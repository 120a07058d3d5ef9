"""Measured kernel dispatch: the tuning table and per-bucket resolution.

The port of ``repro/kernels/autotune.py``.  Whether a bound family or the
pool merge runs through its CUDA kernel or through plain PyTorch is a
*measured* choice per bucket shape, never a global one:

* ``tune_shape(kernel, n, b)`` times the fused (kernel) and unfused
  (plain PyTorch) paths at one engine-realistic shape on the executor's
  device — CUDA events on the card, ``perf_counter`` on the CPU — and
  records the winner in a tuning table.
* The table is keyed by ``(device_kind, kernel, N, B)`` and persisted to
  ``<dir>/tuning.json`` when a directory is configured
  (``enable_autotune(dir)`` / ``REPRO_GED_AUTOTUNE_DIR``), with the
  reference's schema, so one file reads the same in both packages:
  idempotent enable, reset on re-point, corrupt files recover to an empty
  table, and ``autotune_hits`` / ``autotune_misses`` /
  ``autotune_sweep_s`` / ``autotune_entries`` surface in
  ``GedEngine.stats``.
* ``EngineConfig.use_kernel="auto"``: ``resolve_config`` runs in
  ``ged/exec.py Executor.run_packed_async`` and pins each bucket's
  ``(slots, batch)`` shape to a concrete :class:`KernelDispatch` stored on
  the config.  Outcomes are bit-identical across every dispatch path (the
  kernels equal their plain twins).  Untuned shapes fall back to a static
  heuristic: everything unfused on the CPU (where the "kernels" are the
  plain twins anyway), the bound kernels fused from N >= 128 on the card,
  the merge unfused until a measurement says otherwise.

``device_kind`` is ``"cpu"`` for the CPU and
``torch.cuda.get_device_name(device)`` for a card — the reference writes
``"cpu"`` for its CPU backend too.  Key schema (flat strings)::

    "<device_kind>|<kernel>|N=<n>|B=<b>"

where ``kernel`` is ``lsa`` / ``bma`` (N = bucket slots, B = states per
iteration = pairs x expand) or ``merge`` (N = pool size, B = children per
iteration = expand x slots).  Lookups try the exact key, then the nearest
tuned B (log-space) at the same ``(device_kind, kernel, N)``, and count a
miss only when no measurement for that (kernel, N) exists.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

AUTOTUNE_ENV = "REPRO_GED_AUTOTUNE_DIR"
TABLE_FILE = "tuning.json"
_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class KernelDispatch:
    """A concrete per-bucket kernel plan: which families run fused.

    The tile fields mirror the reference's so that one tuning table reads
    the same in both packages; the CUDA kernels pick their own blocking,
    so the port carries them and ignores them (``0`` = kernel default).
    """

    lsa_fused: bool = False
    lsa_tile_u: int = 0
    bma_fused: bool = False
    bma_tile_v: int = 0
    bma_tile_u: int = 0
    merge_fused: bool = False


# Module state: one process-wide table, like the reference's.
_AUTOTUNE = {
    "dir": None,        # Optional[str] — None = in-memory table only
    "table": {},        # key -> entry dict
    "hits": 0,
    "misses": 0,
    "sweep_s": 0.0,
}


# --------------------------------------------------------------------------
# table: enable / load / save / lookup
# --------------------------------------------------------------------------

def device_kind(device=None) -> str:
    """The tuning-table device key: ``"cpu"`` or the card's name.

    ``device=None`` means the card, as everywhere in the port.

    >>> device_kind("cpu")
    'cpu'
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    from repro_torch.device import resolve_device
    return torch.cuda.get_device_name(resolve_device(dev))


def _table_path(path: str) -> str:
    return os.path.join(path, TABLE_FILE)


def _load(path: str) -> Dict[str, Dict]:
    """Read a tuning table; corrupt or alien files recover to empty."""
    from repro_torch.store_io.atomic import read_json_or_none
    raw = read_json_or_none(_table_path(path))
    if not isinstance(raw, dict) or raw.get("version") != _SCHEMA_VERSION:
        return {}
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        return {}
    return {k: v for k, v in entries.items() if isinstance(v, dict)}


def _save() -> None:
    """Atomically persist the in-memory table (no-op without a dir)."""
    path = _AUTOTUNE["dir"]
    if path is None:
        return
    from repro_torch.store_io.atomic import atomic_write_json
    payload = {"version": _SCHEMA_VERSION, "entries": _AUTOTUNE["table"]}
    atomic_write_json(_table_path(path), payload, indent=1, sort_keys=True)


def enable_autotune(path: Optional[str] = None) -> Optional[str]:
    """Point the tuning table at a directory and load any persisted rows.

    ``path=None`` falls back to ``$REPRO_GED_AUTOTUNE_DIR``; when neither
    is set the table stays in memory (tuning still works, nothing
    persists).  Idempotent for a repeated path; re-pointing at a new
    directory replaces the in-memory table with that directory's rows.
    """
    path = path or os.environ.get(AUTOTUNE_ENV)
    if path is None:
        return _AUTOTUNE["dir"]
    if path == _AUTOTUNE["dir"]:
        return path
    os.makedirs(path, exist_ok=True)
    _AUTOTUNE["dir"] = path
    _AUTOTUNE["table"] = _load(path)
    return path


def reset() -> None:
    """Forget the directory, table and counters."""
    _AUTOTUNE.update(dir=None, table={}, hits=0, misses=0, sweep_s=0.0)


def snapshot() -> Dict:
    """Copy of the module state, for save/restore around probes."""
    out = dict(_AUTOTUNE)
    out["table"] = dict(_AUTOTUNE["table"])
    return out


def restore(state: Dict) -> None:
    _AUTOTUNE.clear()
    _AUTOTUNE.update(state)


def autotune_stats() -> Dict[str, float]:
    """Merged into ``GedEngine.stats``."""
    return {
        "autotune_hits": float(_AUTOTUNE["hits"]),
        "autotune_misses": float(_AUTOTUNE["misses"]),
        "autotune_sweep_s": float(_AUTOTUNE["sweep_s"]),
        "autotune_entries": float(len(_AUTOTUNE["table"])),
    }


def table_key(kernel: str, n: int, b: int, kind: str) -> str:
    """>>> table_key("merge", 1024, 256, "cpu")
    'cpu|merge|N=1024|B=256'
    """
    return f"{kind}|{kernel}|N={int(n)}|B={int(b)}"


def put(kernel: str, n: int, b: int, entry: Dict, device=None) -> Dict:
    kind = device_kind(device)
    entry = dict(entry)
    entry.update(kernel=kernel, N=int(n), B=int(b), device_kind=kind)
    _AUTOTUNE["table"][table_key(kernel, n, b, kind)] = entry
    _save()
    return entry


def lookup(kernel: str, n: int, b: int, count: bool = True,
           device=None) -> Optional[Dict]:
    """Tuned entry for ``(device_kind, kernel, n, b)``, or None.

    Falls back to the nearest tuned ``B`` (log-space) at the same
    ``(device_kind, kernel, n)`` — still a hit.  ``count=False`` probes
    without touching the hit/miss counters.
    """
    kind = device_kind(device)
    exact = _AUTOTUNE["table"].get(table_key(kernel, n, b, kind))
    if exact is not None:
        if count:
            _AUTOTUNE["hits"] += 1
        return exact
    prefix = f"{kind}|{kernel}|N={int(n)}|B="
    best, best_d = None, None
    for key, entry in _AUTOTUNE["table"].items():
        if not key.startswith(prefix):
            continue
        bb = int(key.rsplit("B=", 1)[1])
        d = abs(math.log(max(bb, 1)) - math.log(max(int(b), 1)))
        if best_d is None or d < best_d:
            best, best_d = entry, d
    if count:
        if best is not None:
            _AUTOTUNE["hits"] += 1
        else:
            _AUTOTUNE["misses"] += 1
    return best


# --------------------------------------------------------------------------
# dispatch resolution
# --------------------------------------------------------------------------

def static_heuristic(n: int, device=None) -> KernelDispatch:
    """Plan for unmeasured shapes.

    On the CPU everything stays unfused: the wrappers would run the plain
    twins there, so "fused" buys nothing.  On the card the bound kernels
    are fused once tiles are full (N >= 128); the merge kernel stays off
    until measured.

    >>> static_heuristic(256, "cpu") == KernelDispatch()
    True
    """
    if torch.device("cuda" if device is None else device).type == "cpu":
        return KernelDispatch()
    on = int(n) >= 128
    return KernelDispatch(lsa_fused=on, bma_fused=on)


def _safe_tile(tile, n: int) -> int:
    """Tile sizes from disk are untrusted: anything that doesn't divide
    the axis falls back to the kernel default (0)."""
    try:
        tile = int(tile)
    except (TypeError, ValueError):
        return 0
    if tile <= 0 or int(n) % tile != 0:
        return 0
    return tile


def resolve_config(cfg, slots: int, batch: int, device=None):
    """Pin ``use_kernel="auto"`` to a concrete ``KernelDispatch``.

    Runs once per bucket dispatch (``ged/exec.py``), on the executor's
    ``device``; non-"auto" configs and configs that already carry a
    ``dispatch`` pass through untouched.
    """
    if getattr(cfg, "use_kernel", None) != "auto" or cfg.dispatch is not None:
        return cfg
    n = int(slots)
    fallback = static_heuristic(n, device)
    b_eff = int(batch) * int(cfg.expand)

    fields = {}
    if cfg.bound in ("lsa", "hybrid"):
        ent = lookup("lsa", n, b_eff, device=device)
        if ent is not None:
            fields["lsa_fused"] = ent.get("impl") == "fused"
            fields["lsa_tile_u"] = _safe_tile(ent.get("tile_u"), n)
        else:
            fields["lsa_fused"] = fallback.lsa_fused
    if cfg.bound in ("bma", "hybrid"):
        ent = lookup("bma", n, b_eff, device=device)
        if ent is not None:
            fields["bma_fused"] = ent.get("impl") == "fused"
            fields["bma_tile_v"] = _safe_tile(ent.get("tile_v"), n)
            fields["bma_tile_u"] = _safe_tile(ent.get("tile_u"), n)
        else:
            fields["bma_fused"] = fallback.bma_fused
    ent = lookup("merge", int(cfg.pool), int(cfg.expand) * n, device=device)
    if ent is not None:
        fields["merge_fused"] = ent.get("impl") == "fused"
    else:
        fields["merge_fused"] = fallback.merge_fused
    return dataclasses.replace(cfg, dispatch=KernelDispatch(**fields))


def concrete_dispatch(cfg, n: int, device=None) -> KernelDispatch:
    """The plan the search loop follows — pure in ``cfg``, ``n`` and
    ``device``; it never reads the mutable table.  An ``"auto"`` config
    that reached the loop without a resolved ``dispatch`` (not via the
    executor) gets the static heuristic.

    >>> from repro_torch.core.engine.search import EngineConfig
    >>> concrete_dispatch(EngineConfig(use_kernel=True), 32)
    KernelDispatch(lsa_fused=True, lsa_tile_u=0, bma_fused=True, bma_tile_v=0, bma_tile_u=0, merge_fused=False)
    """
    d = getattr(cfg, "dispatch", None)
    if d is not None:
        return d
    uk = cfg.use_kernel
    if uk == "auto":
        return static_heuristic(n, device)
    on = bool(uk)
    return KernelDispatch(lsa_fused=on, bma_fused=on)


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------

def _timeit(fn, device: torch.device, budget_s: float = 0.15) -> float:
    """Best-of-3 steady-state seconds per call, the iteration count scaled
    to ``budget_s``.  CUDA events around the calls on the card (after a
    synchronise), ``perf_counter`` on the CPU."""
    on_card = device.type == "cuda"

    def timed(iters: int) -> float:
        if on_card:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    timed(1)                                       # build + warm
    est = timed(1)
    iters = max(1, min(8, int(budget_s / (3.0 * max(est, 1e-7)))))
    return min(timed(iters) for _ in range(3))


def _bound_bench(kernel: str, n: int, b: int, device: torch.device,
                 seed: int = 7):
    """A fused/unfused bound evaluation at engine-realistic shapes: one
    dense packed pair at ``slots == n`` and ``b`` random expansion states,
    laid out as the search loop lays them out (pair constants
    ``(1, 1, ...)`` against states ``(1, b, ...)``).

    Returns ``bench(use_kernel) -> tensor``.
    """
    from repro_torch.core.engine import bounds as eb
    from repro_torch.core.engine.tensor_graphs import pack_pairs, to_device
    from repro_torch.data.graphs import perturb, random_graph

    rng = np.random.default_rng(seed)
    q = random_graph(rng, n, density=0.3, n_vlabels=5, n_elabels=3)
    g = perturb(rng, q, 4, n_vlabels=5, n_elabels=3)
    pc = eb.make_pair_consts(*to_device(pack_pairs([(q, g)], slots=n),
                                        device)).unsqueeze(1)
    imgs = np.full((1, b, n), -1, np.int32)
    levels = rng.integers(1, max(2, n // 2), (1, b)).astype(np.int32)
    for i, lvl in enumerate(levels[0]):
        imgs[0, i, :lvl] = rng.permutation(n)[:lvl]
    gcosts = (rng.integers(0, 8, (1, b)) * 0.5).astype(np.float32)
    img_t, level_t, gcost_t = (torch.as_tensor(a, device=device)
                               for a in (imgs, levels, gcosts))

    def bench(uk: bool):
        sm = eb.state_masks(pc, img_t, level_t)
        if kernel == "lsa":
            return eb.lsa_children(pc, sm, level_t, gcost_t, use_kernel=uk)
        return eb.bma_cost_matrix(pc, sm, use_kernel=uk)

    return bench


def _merge_bench(pool: int, children: int, device: torch.device,
                 seed: int = 11, pairs: int = 8):
    """A sorted-pool merge step (the engine's frontier update) over a small
    pair batch.  Returns ``bench(use_kernel) -> tensors``."""
    from repro_torch.parallel.ops import merge_sorted_topk, sort_by_key

    rng = np.random.default_rng(seed)
    na = max(int(pool) - 8, 8)                     # pool minus the pop slice
    nb = int(children)

    def t(a):
        return torch.as_tensor(a, device=device)

    ka = t(np.sort(rng.random((pairs, na)), axis=1).astype(np.float32))
    kb = t(rng.random((pairs, nb)).astype(np.float32))
    pa = t(rng.integers(0, 64, (pairs, na, 16)).astype(np.int32))
    pb = t(rng.integers(0, 64, (pairs, nb, 16)).astype(np.int32))
    rows = torch.arange(nb, device=device).expand(pairs, nb)

    def bench(uk: bool):
        kbs, order = sort_by_key(kb, rows)
        return merge_sorted_topk(ka, kbs, (pa,), (pb,), int(pool),
                                 drop_a=ka, drop_b=kbs, perm_b=order,
                                 use_kernel=uk)

    return bench


def tune_shape(kernel: str, n: int, b: int, *, device=None,
               budget_s: float = 0.15) -> Dict:
    """Time one ``(kernel, N, B)`` shape on ``device`` and record the
    winner.  The entry's ``us`` is the winner's own measured time
    (``impl`` names it), so dispatch by table never picks a variant that
    measured slower.  The CUDA kernels take no tiles: ``tile_v`` and
    ``tile_u`` are recorded as 0.
    """
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if kernel in ("lsa", "bma"):
        bench = _bound_bench(kernel, int(n), int(b), dev)
    elif kernel == "merge":
        bench = _merge_bench(int(n), int(b), dev)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    unfused_s = _timeit(lambda: bench(False), dev, budget_s)
    fused_s = _timeit(lambda: bench(True), dev, budget_s)
    fused_wins = fused_s < unfused_s
    entry = {
        "impl": "fused" if fused_wins else "unfused",
        "tile_v": 0, "tile_u": 0,
        "us": min(fused_s, unfused_s) * 1e6,
        "fused_us": fused_s * 1e6,
        "unfused_us": unfused_s * 1e6,
    }
    _AUTOTUNE["sweep_s"] += time.perf_counter() - t0
    return put(kernel, n, b, entry, device=dev)


def tune(*, ns: Iterable[int] = (32, 64, 128),
         bs: Iterable[int] = (8, 32, 128),
         kernels: Iterable[str] = ("lsa", "bma"),
         merge_shapes: Iterable[Tuple[int, int]] = ((512, 256), (2048, 1024)),
         force: bool = False, device=None,
         budget_s: float = 0.15) -> List[Dict]:
    """Pre-warm the table over a shape grid on ``device`` (skips
    already-tuned keys unless ``force``)."""
    kind = device_kind(device)
    entries = []
    shapes: List[Tuple[str, int, int]] = [
        (k, n, b) for k in kernels for n in ns for b in bs]
    shapes += [("merge", pool, children) for pool, children in merge_shapes]
    for kernel, n, b in shapes:
        if not force and table_key(kernel, n, b, kind) in _AUTOTUNE["table"]:
            continue
        entries.append(tune_shape(kernel, n, b, device=device,
                                  budget_s=budget_s))
    return entries

