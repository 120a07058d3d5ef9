"""Device-resident frontier search (the tensorised Alg. 2) in PyTorch.

The counterpart of ``repro/core/engine/search.py``.  Where the reference
runs one ``lax.while_loop`` per pair, ``vmap``-ed across pairs in
lockstep, this runs a loop of ``_step`` over a ``(pairs, P, ...)`` pool:
every pair owns a fixed-capacity pool of search states kept **sorted by
the strategy pop key** (AStar+: ``(lb, -level)``; DFS+: ``(-level, lb)``).
Per iteration, for all pairs at once:

  1. **pop**: the best ``expand`` states are the first ``B`` rows of each
     sorted pool — a slice.
  2. **expand**: score all children of each popped state (LSa via
     histogram algebra, BMa via one auction + dual forced bounds; the
     CUDA kernels under ``EngineConfig.use_kernel``).
  3. **bound**: update the incumbent from exact leaf children and the
     greedy-primal full-mapping extension.
  4. **merge**: sort only the ``B*N`` child keys, rank-merge them into the
     surviving pool and truncate to ``P`` rows; the smallest lower bound
     ever dropped is the floor the exactness certificate rests on.

A pair that has finished is frozen: every carried tensor keeps its old
value under the same done mask as the reference (``search.py:268-270``),
so ``iterations``, ``expanded`` and ``floor`` match it, and a pair's
result does not depend on how long the other pairs of its batch run.  So
steps past the point where every pair is done change nothing, and the
loop reads its termination flag once per chunk of ``CHUNK`` steps, not
every step: the outputs are the same for every chunk length.

On the CPU (:func:`run_eager`) the chunks run eagerly and the flag is read
before each one.  On the card (:func:`run_graphed`) a chunk is one
replay of a CUDA graph of ``CHUNK`` chained steps over static carry and
``PairConsts`` buffers (captured once per batch shape and kept in a small
cache), and the flag of chunk ``j`` is copied into pinned host memory and
read while chunk ``j + 1`` runs, so the host never leaves the device
idle waiting for it.  A failed capture or replay raises; nothing falls
back to the eager loop.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.engine import bounds as eb
from repro_torch.core.engine.tensor_graphs import DevicePairs
from repro_torch.kernels import ops as kops
from repro_torch.kernels.autotune import KernelDispatch, concrete_dispatch
from repro_torch.parallel.ops import merge_sorted_topk, sort_by_key, tree_map

INF = 3.0e8
BIG = eb.BIG

# search steps per termination read: one eager chunk on the CPU, one graph
# replay on the card.  Chosen from card runs (PERF.md): with the read
# pipelined, a longer chunk only adds frozen steps at the batch's end and
# a longer capture, and no chunk length ran a cached batch faster than 1.
CHUNK = 1
# captured graphs kept for reuse when no batch holds them (each keeps its
# static buffers and a private memory pool on the card)
GRAPH_CACHE_SIZE = 16


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    pool: int = 1024          # state-pool capacity P
    expand: int = 8           # states expanded per iteration B
    max_iters: int = 512
    sweeps: int = 8           # auction sweeps per expansion
    bound: str = "hybrid"     # "lsa" | "bma" | "hybrid" (max of both)
    strategy: str = "astar"   # "astar" | "dfs"
    # True/False turn the CUDA kernels of the bound families on/off;
    # "auto" resolves per bucket shape through the measured tuning table
    # (kernels/autotune.py).  ``dispatch`` is the resolved per-bucket plan
    # the executor pins; outcomes are bit-identical across every plan.
    use_kernel: Union[bool, str] = True
    dispatch: Optional[KernelDispatch] = None

    def __post_init__(self):
        if self.use_kernel not in (True, False, "auto"):
            raise ValueError(
                f"use_kernel must be True, False or 'auto', "
                f"got {self.use_kernel!r}")


class PoolState(NamedTuple):
    img: torch.Tensor       # (pairs, P, N) int32 images by order position (-1 = unset)
    level: torch.Tensor     # (pairs, P) int32
    gcost: torch.Tensor     # (pairs, P) f32
    lb: torch.Tensor        # (pairs, P) f32
    valid: torch.Tensor     # (pairs, P) bool


class Carry(NamedTuple):
    pool: PoolState
    ub: torch.Tensor          # (pairs,) f32 incumbent
    best_img: torch.Tensor    # (pairs, N) int32 incumbent mapping (by position)
    floor: torch.Tensor       # (pairs,) f32 min lower bound ever dropped
    it: torch.Tensor          # (pairs,) int32
    expanded: torch.Tensor    # (pairs,) int32 total states expanded
    done: torch.Tensor        # (pairs,) bool


def _pop_key(cfg: EngineConfig, lb, level, valid, n):
    nf = n.float()
    if cfg.strategy == "astar":
        key = lb * 256.0 + (nf - level.float())
    else:  # dfs: deepest first, then smallest bound
        key = (nf - level.float()) * 1.0e5 + lb
    return torch.where(valid, key, INF)


def _expand(pc: eb.PairConsts, cfg: EngineConfig, img, level, gcost,
            state_valid):
    """Score all children of a batch of states.  Returns per-child arrays
    ``(..., N)`` plus the heuristic mapping ``(..., N)`` and its cost."""
    sm = eb.state_masks(pc, img, level)
    delta = eb.child_exact_delta(pc, sm)
    child_gcost = gcost[..., None] + delta

    d = concrete_dispatch(cfg, img.shape[-1], img.device)
    lb_parts = []
    if cfg.bound in ("lsa", "hybrid"):
        lb_parts.append(eb.lsa_children(pc, sm, level, gcost,
                                        use_kernel=d.lsa_fused))
    if cfg.bound in ("bma", "hybrid"):
        bma = eb.bma_children(pc, sm, img, level, gcost, cfg.sweeps,
                              use_kernel=d.bma_fused)
        lb_parts.append(bma.lb)
        heur_img, heur_cost = bma.full_img, bma.full_cost
    else:
        heur_img = img
        heur_cost = torch.full(level.shape, INF, device=img.device)
    lb = lb_parts[0]
    for p in lb_parts[1:]:
        lb = torch.maximum(lb, p)

    ok = (sm.free_g > 0) & state_valid[..., None]
    lb = torch.where(ok, lb, INF)
    child_gcost = torch.where(ok, child_gcost, INF)
    heur_cost = torch.where(state_valid, heur_cost, INF)
    return lb, child_gcost, heur_img, heur_cost


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-pair row pick: ``x[p, idx[p]]`` for ``x`` of shape (pairs, R, ...)."""
    idx = idx.long().reshape((-1, 1) + (1,) * (x.ndim - 2))
    return torch.take_along_dim(x, idx, 1)[:, 0]


def _step(pc: eb.PairConsts, cfg: EngineConfig, c: Carry, n: torch.Tensor,
          tau: torch.Tensor, verification: bool) -> Carry:
    """One search iteration for every pair; done pairs keep their carry."""
    pool = c.pool
    P, B = cfg.pool, cfg.expand
    N = pool.img.shape[-1]
    dev = pool.img.device
    pos = torch.arange(N, dtype=torch.int32, device=dev)

    # ---- pop: the pool is key-sorted, so the best B states are the first
    # B rows of each pair's pool
    sel_img = pool.img[:, :B]
    sel_level = pool.level[:, :B]
    sel_gcost = pool.gcost[:, :B]
    sel_lb = pool.lb[:, :B]
    sel_valid = pool.valid[:, :B] & (sel_lb < c.ub[:, None])   # Alg. 2 line 6
    # the unpopped remainder stays sorted: nothing below mutates it
    rem = PoolState(pool.img[:, B:], pool.level[:, B:], pool.gcost[:, B:],
                    pool.lb[:, B:], pool.valid[:, B:])

    # ---- expand ---------------------------------------------------------------
    clb, cgc, heur_img, heur_cost = _expand(pc, cfg, sel_img, sel_level,
                                            sel_gcost, sel_valid)  # (pairs, B, N)
    # monotone bounds along root-leaf paths (§5.1)
    clb = torch.maximum(clb, sel_lb[..., None])
    child_level = sel_level + 1                                    # (pairs, B)
    is_leaf = child_level[..., None] == n[:, None, None]           # (pairs, B, N)

    # ---- incumbent update ------------------------------------------------------
    leaf_costs = torch.where(is_leaf & (cgc < INF / 2), cgc, INF)
    l_flat = leaf_costs.reshape(-1, B * N)
    l_best = l_flat.argmin(-1)
    l_cost = _row(l_flat[..., None], l_best)[:, 0]
    lb_state, lu = l_best // N, (l_best % N).to(torch.int32)
    leaf_img = torch.where(pos == _row(sel_level, lb_state)[:, None],
                           lu[:, None], _row(sel_img, lb_state))

    h_best = heur_cost.argmin(-1)
    h_cost = _row(heur_cost[..., None], h_best)[:, 0]

    new_ub = torch.minimum(c.ub, torch.minimum(l_cost, h_cost))
    best_img = torch.where(
        ((l_cost < c.ub) & (l_cost <= h_cost))[:, None], leaf_img,
        torch.where((h_cost < c.ub)[:, None], _row(heur_img, h_best),
                    c.best_img))

    # ---- children to insert ----------------------------------------------------
    ins_mask = (~is_leaf) & (clb < new_ub[:, None, None]) & (clb < INF / 2)
    child_imgs = torch.where(
        pos == sel_level[..., None, None],
        pos[:, None].expand(N, N), sel_img[:, :, None, :])        # (pairs, B, N, N)
    ch = PoolState(
        child_imgs.reshape(-1, B * N, N),
        child_level[..., None].expand(-1, B, N).reshape(-1, B * N),
        cgc.reshape(-1, B * N),
        torch.where(ins_mask, clb, INF).reshape(-1, B * N),
        ins_mask.reshape(-1, B * N))

    # ---- merge: keep best P by pop key ----------------------------------------
    # Only the child keys are sorted; the sort permutation composes into the
    # merge's source-index map (perm_b), so child payload rows never move
    # before the merge.
    n_col = n[:, None]
    ch_keys = _pop_key(cfg, ch.lb, ch.level, ch.valid, n_col)
    ch_keys, ch_order = sort_by_key(
        ch_keys, torch.arange(B * N, device=dev).expand(ch_keys.shape))
    rem_keys = _pop_key(cfg, rem.lb, rem.level, rem.valid, n_col)
    # dropped states whose bound the incumbent already beat (lb >= new_ub)
    # are pruned, not unexplored: they stay out of the floor
    _, kept, dropped_lb = merge_sorted_topk(
        rem_keys, ch_keys, rem, ch, P,
        drop_a=torch.where(rem.valid & (rem.lb < new_ub[:, None]), rem.lb, INF),
        drop_b=torch.where(ch.valid, ch.lb, INF),
        perm_b=ch_order,
        use_kernel=concrete_dispatch(cfg, N, dev).merge_fused)
    new_pool = kept._replace(lb=torch.where(kept.valid, kept.lb, INF))
    new_floor = torch.minimum(c.floor, dropped_lb)

    # ---- termination -------------------------------------------------------------
    min_lb = torch.where(new_pool.valid, new_pool.lb, INF).amin(-1)
    it = c.it + 1
    exhausted = min_lb >= INF / 2
    # min_lb >= ub: every remaining state is prunable, the incumbent is optimal
    opt_done = min_lb >= new_ub
    done = exhausted | opt_done | (it >= cfg.max_iters)
    if verification:
        done = done | (new_ub <= tau) | (torch.minimum(min_lb, new_floor) > tau)

    new_c = Carry(new_pool, new_ub, best_img, new_floor, it,
                  c.expanded + sel_valid.sum(-1, dtype=torch.int32), done)
    # freeze pairs that were already done (the reference's lockstep mask)
    return tree_map(
        lambda new, old: torch.where(
            c.done.reshape((-1,) + (1,) * (old.ndim - 1)), old, new),
        new_c, c)


def _init(pairs: DevicePairs, taus: torch.Tensor, cfg: EngineConfig,
          verification: bool):
    """The pair constants, the root carry, ``n`` and ``taus`` of a batch."""
    qv, gv, qa, ga, order, n, n_vlabels, n_elabels = pairs
    npairs, N = qv.shape
    P = cfg.pool
    dev = qv.device
    pc = eb.make_pair_consts(qv, gv, qa, ga, order, n, n_vlabels,
                             n_elabels).unsqueeze(1)
    taus = taus.to(device=dev, dtype=torch.float32)

    def rows(fill, dtype, root=None):
        t = torch.full((npairs, P), fill, dtype=dtype, device=dev)
        if root is not None:
            t[:, 0] = root
        return t

    pool0 = PoolState(
        img=torch.full((npairs, P, N), -1, dtype=torch.int32, device=dev),
        level=rows(0, torch.int32),
        gcost=rows(INF, torch.float32, 0.0),
        lb=rows(INF, torch.float32, 0.0),
        valid=rows(False, torch.bool, True),
    )
    ub0 = (taus + 0.5) if verification else torch.full((npairs,), INF,
                                                       device=dev)
    c = Carry(pool0, ub0,
              torch.full((npairs, N), -1, dtype=torch.int32, device=dev),
              torch.full((npairs,), INF, device=dev),
              torch.zeros(npairs, dtype=torch.int32, device=dev),
              torch.zeros(npairs, dtype=torch.int32, device=dev),
              n == 0)
    return pc, c, n, taus


def _finish(final: Carry, taus: torch.Tensor, cfg: EngineConfig,
            verification: bool) -> Dict[str, torch.Tensor]:
    min_lb_end = torch.where(final.pool.valid, final.pool.lb, INF).amin(-1)
    truncated = (final.it >= cfg.max_iters) & (min_lb_end < final.ub)
    ged_val = final.ub
    exact = (ged_val <= final.floor) & ~truncated
    if verification:
        similar = final.ub <= taus
        exact = torch.where(
            similar, True,
            (torch.minimum(min_lb_end, final.floor) > taus) & ~truncated)
        return {
            "similar": similar,
            "exact": exact,
            "lower_bound": torch.where(similar, 0.0,
                                       torch.minimum(min_lb_end, final.floor)),
            "upper_bound": final.ub,
            "iterations": final.it,
            "expanded": final.expanded,
            "best_img": final.best_img,
        }
    return {
        "ged": ged_val,
        "exact": exact,
        "lower_bound": torch.minimum(torch.minimum(min_lb_end, final.floor),
                                     final.ub),
        "upper_bound": final.ub,
        "iterations": final.it,
        "expanded": final.expanded,
        "best_img": final.best_img,
        "floor": final.floor,
    }


def _chunk_len(cfg: EngineConfig, chunk: int) -> int:
    return max(1, min(int(chunk), cfg.max_iters))


def run_batch(pairs: DevicePairs, taus: torch.Tensor, cfg: EngineConfig,
              verification: bool) -> Dict[str, torch.Tensor]:
    """Search every pair of a packed batch; the reference's ``_run_batch``.

    Returns the same keys as the reference: ``ged`` (computation mode) or
    ``similar`` (verification), ``exact``, ``lower_bound``,
    ``upper_bound``, ``iterations``, ``expanded``, ``best_img`` and, in
    computation mode, ``floor`` — one row per pair, on the batch's device.
    On the card the loop runs as CUDA graph replays (:func:`run_graphed`)
    and this returns once the outputs have landed; on the CPU it runs
    eagerly (:func:`run_eager`).
    """
    if pairs.qv.device.type == "cuda":
        return run_graphed(pairs, taus, cfg, verification)
    return run_eager(pairs, taus, cfg, verification)


def run_eager(pairs: DevicePairs, taus: torch.Tensor, cfg: EngineConfig,
              verification: bool, chunk: int = CHUNK
              ) -> Dict[str, torch.Tensor]:
    """:func:`run_batch` as eager chunks of ``chunk`` steps, the done flag
    read on the host before each chunk: at most ``ceil(iterations /
    chunk) + 1`` reads a batch.  The CPU path, and on the card the
    reference the graph loop is held to (and the dry run's op trace)."""
    pc, c, n, taus = _init(pairs, taus, cfg, verification)
    k = _chunk_len(cfg, chunk)
    steps = 0
    while steps < cfg.max_iters and not bool(c.done.all()):
        for _ in range(k):
            c = _step(pc, cfg, c, n, taus, verification)
        steps += k
    return _finish(c, taus, cfg, verification)


def _leaves(c: Carry) -> List[torch.Tensor]:
    return [*c.pool, *c[1:]]


# what the graph loop did, process-wide: batches run, graphs captured,
# replays, and host reads of a chunk's done flag
LOOP_COUNTS: Dict[str, int] = {"batches": 0, "captures": 0, "replays": 0,
                               "flag_reads": 0}
_COUNTS_LOCK = threading.Lock()


def _bump(**by: int) -> None:
    with _COUNTS_LOCK:
        for k, v in by.items():
            LOOP_COUNTS[k] += v


def loop_counts() -> Dict[str, int]:
    with _COUNTS_LOCK:
        return dict(LOOP_COUNTS)


class _Graph:
    """``k`` chained steps captured as one CUDA graph.

    The static inputs are clones of the pair constants, ``n``, ``taus``
    and the carry they were captured from; a replay advances the static
    carry in place by ``k`` steps and leaves ``done.all()`` in
    ``all_done``.  ``tally`` is the kernel launches one replay makes, as
    the capture recorded them.  ``flags`` is pinned host memory for the
    pipelined flag reads.  One batch holds a graph at a time.
    """

    def __init__(self, pc: eb.PairConsts, c: Carry, n: torch.Tensor,
                 taus: torch.Tensor, cfg: EngineConfig, verification: bool,
                 k: int):
        self.pc = eb.PairConsts(*(t.clone() for t in pc[:10]),
                                pc.n_vlabels, pc.n_elabels)
        self.c = tree_map(torch.clone, c)
        self.n, self.taus = n.clone(), taus.clone()
        self.flags = torch.zeros(2, dtype=torch.bool, pin_memory=True)
        self.graph = torch.cuda.CUDAGraph()
        # other threads launch while this one captures (other batches,
        # other shards): only this thread's calls are checked
        with kops.capture_tally() as tally:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self.c
                for _ in range(k):
                    out = _step(self.pc, cfg, out, self.n, self.taus,
                                verification)
                for s, o in zip(_leaves(self.c), _leaves(out)):
                    s.copy_(o)
                self.all_done = self.c.done.all()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass        # the capture was already invalidated
                raise
            self.graph.capture_end()
        self.tally = dict(tally)
        _bump(captures=1)

    def load(self, pc: eb.PairConsts, c: Carry, n: torch.Tensor,
             taus: torch.Tensor) -> None:
        """Copy a new batch's inputs into the static buffers."""
        for s, x in zip([*self.pc[:10], *_leaves(self.c), self.n, self.taus],
                        [*pc[:10], *_leaves(c), n, taus]):
            s.copy_(x)

    def replay(self) -> None:
        self.graph.replay()
        kops.add_launches(self.tally)
        _bump(replays=1)


class _GraphCache:
    """Idle captured graphs by key, least recently used first; at most
    ``GRAPH_CACHE_SIZE``.  A batch takes a graph out and puts it back once
    its outputs have landed, so two batches never share static buffers: a
    second batch of the same key captures a graph of its own."""

    def __init__(self):
        self._idle: "collections.OrderedDict[int, Tuple[tuple, _Graph]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def take(self, key: tuple) -> Optional[_Graph]:
        with self._lock:
            for gid, (k, g) in self._idle.items():
                if k == key:
                    del self._idle[gid]
                    return g
        return None

    def put(self, key: tuple, g: _Graph) -> None:
        with self._lock:
            self._idle[id(g)] = (key, g)
            while len(self._idle) > GRAPH_CACHE_SIZE:
                self._idle.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._idle.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._idle)


GRAPHS = _GraphCache()


def clear_graphs() -> None:
    """Drop every idle captured graph (and with it its memory pool)."""
    GRAPHS.clear()


def run_graphed(pairs: DevicePairs, taus: torch.Tensor, cfg: EngineConfig,
                verification: bool, chunk: int = CHUNK
                ) -> Dict[str, torch.Tensor]:
    """:func:`run_batch` on the card as replays of a CUDA graph of
    ``chunk`` chained steps; returns once the outputs have landed.

    Runs on the current stream, or on a side stream when that is the
    default stream (a graph cannot be captured there).  A batch whose
    shape has an idle graph in the cache loads its inputs into the
    graph's buffers and replays it from the first chunk.  Otherwise the
    first chunk runs eagerly (the warm-up a capture needs, and real
    work), and the graph is captured while the device runs it, unless one
    chunk is all the batch can take.  Chunk ``j``'s done flag is copied
    to pinned memory behind it and read after chunk ``j + 1`` has been
    enqueued.
    """
    dev = pairs.qv.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cur = torch.cuda.current_stream(dev)
    side = cur == torch.cuda.default_stream(dev)
    stream = torch.cuda.Stream(dev) if side else cur
    if side:
        stream.wait_stream(cur)
        for t in (*pairs[:6], taus):
            t.record_stream(stream)
    k = _chunk_len(cfg, chunk)
    total = -(-cfg.max_iters // k)
    npairs, N = pairs.qv.shape
    key = (dev.index, cfg, concrete_dispatch(cfg, N, dev), bool(verification),
           k, npairs, N, int(pairs.n_vlabels), int(pairs.n_elabels))
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        pc, c, n, taus = _init(pairs, taus, cfg, verification)
        g = GRAPHS.take(key)
        if g is not None:
            g.load(pc, c, n, taus)
            g.replay()
            flag_src, c = g.all_done, g.c
        else:
            for _ in range(k):
                c = _step(pc, cfg, c, n, taus, verification)
            flag_src = c.done.all()
            if total > 1:
                g = _Graph(pc, c, n, taus, cfg, verification, k)
        flags = g.flags if g is not None else torch.zeros(
            1, dtype=torch.bool, pin_memory=True)

        def flag(j: int) -> torch.cuda.Event:
            flags[j % len(flags)].copy_(flag_src, non_blocking=True)
            # the thread sleeps in synchronize(), leaving its core to the
            # caller's host work
            ev = torch.cuda.Event(blocking=True)
            ev.record(stream)
            return ev

        ev, j, reads = flag(0), 0, 0
        while True:
            nxt = None
            if j + 1 < total:
                g.replay()
                flag_src, c = g.all_done, g.c
                nxt = flag(j + 1)
            ev.synchronize()
            reads += 1
            if bool(flags[j % len(flags)]) or nxt is None:
                break
            ev, j = nxt, j + 1
        # the outputs must not alias the graph's buffers, which the next
        # batch of this shape overwrites
        out = {name: v.clone() for name, v in
               _finish(c, taus, cfg, verification).items()}
        landed = torch.cuda.Event(blocking=True)
        landed.record(stream)
    landed.synchronize()
    if side:
        for v in out.values():
            v.record_stream(cur)
    if g is not None:
        GRAPHS.put(key, g)
    _bump(batches=1, flag_reads=reads)
    return out
