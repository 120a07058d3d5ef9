"""Cell builders: (arch x shape x mesh) -> a sharded step and its inputs.

The reference's ``repro/launch/steps.py`` over ``torch.distributed``:
parameters, optimizer state, caches and inputs are DTensors on a
``DeviceMesh`` (``launch/mesh.py``), placed by :func:`shard_like` from the
same logical specs the reference builds its ``NamedSharding``s from
(``parallel/sharding.py``).  Each step then runs the port's own model code
on those DTensors: ``constrain`` redistributes at the reference's call
sites, DTensor's sharding propagation decides the rest, and the MoE
dispatch and the decode cache write run on local shards (``local_map``
and ``_write_slot``).  ``launch/dryrun.py`` runs the steps on ``meta``
tensors over a fake process group; a real launch runs them on concrete
tensors over NCCL.

Sharding policy (the reference's)
  train : FSDP over ``data`` (params' embed axis), TP over ``model``,
          batch over (``pod``, ``data``); params+opt updated in place
          (the reference's donation, kept as ``donate_argnums``).
  serve : params bf16, replicated over ``data``/``pod`` and TP over
          ``model``; KV cache sequence-sharded over ``model``, batch over
          (``pod``, ``data``); caches written in place.
  ged   : pure DP — pair batch sharded over every mesh axis; the step
          runs the port's engine on one device's share of the pairs
          (concrete, on the caller's device: the search loop reads its
          termination on the host, so it cannot run on ``meta``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.shapes import (GedShapeSpec, ShapeSpec,
                                       ged_input_specs, input_specs)
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (abstract_params, param_pspecs,
                                       tree_map)
from repro_torch.optim import AdamWConfig
from repro_torch.parallel.sharding import (NamedSharding, ShardingRules,
                                           canonical_spec, default_rules,
                                           is_distributed,
                                           logical_spec, mesh_axis_sizes,
                                           set_rules)


@dataclasses.dataclass
class CellPlan:
    """Everything needed to run one grid cell."""
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    rules: Optional[ShardingRules]
    meta: Dict[str, Any]


def _ns(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, canonical_spec(spec))


def _tree_ns(mesh, spec_tree: Any) -> Any:
    return tree_map(lambda s: _ns(mesh, s), spec_tree)


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))


def abstract_opt_state(cfg: ArchConfig) -> Dict[str, Any]:
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    ap = abstract_params(cfg)
    return {"m": tree_map(f32, ap), "v": tree_map(f32, ap),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_pspecs(cfg: ArchConfig, rules: ShardingRules) -> Dict[str, Any]:
    pp = param_pspecs(cfg, rules)
    return {"m": pp, "v": pp, "step": ()}


def _input_shardings(mesh, specs: Dict[str, Any]) -> Dict[str, Any]:
    ba = _batch_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    ba_size = int(np.prod([sizes[a] for a in ba]))
    out = {}
    for k, v in specs.items():
        if v.ndim == 0 or v.shape[0] % ba_size != 0:
            # degrade: replicate when the batch dim does not divide the
            # batch mesh axes (long_500k's global_batch=1)
            out[k] = _ns(mesh, (None,) * v.ndim)
        else:
            out[k] = _ns(mesh, (ba,) + (None,) * (v.ndim - 1))
    return out


def _cache_pspecs(cfg: ArchConfig, batch: int, cache_len: int,
                  rules: ShardingRules) -> Dict[str, Any]:
    shapes = T.cache_shapes(cfg, batch, cache_len)
    axes = T.cache_axes(cfg)
    return {k: logical_spec(shape, axes[k], rules)
            for k, (shape, _) in shapes.items()}


def shard_like(tree: Any, shardings: Any, mesh=None) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor in the placements of its
    :class:`NamedSharding` (the port's ``jax.device_put(tree,
    shardings)``).  Leaves may be ``meta`` or concrete; a concrete leaf is
    taken as the same full tensor on every rank, and each rank keeps its
    own shard of it.  Non-tensor leaves pass through."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, ns):
        if not isinstance(x, torch.Tensor) or is_distributed(x):
            return x
        m = ns.mesh if mesh is None else mesh
        return distribute_tensor(x, m, list(ns.placements(x.shape)),
                                 src_data_rank=None)

    if isinstance(tree, dict):
        return {k: shard_like(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_like(v, s, mesh)
                          for v, s in zip(tree, shardings))
    return put(tree, shardings)


def _replicated_plain(fn: Callable) -> Callable:
    """``fn`` with plain tensors made inside the model code (positions,
    masks, accumulators) taken as replicated DTensors, as they are
    replicated constants of the reference's traced step."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args, **kwargs)
    return run


# ------------------------------------------------------------------- train

def build_train(cfg: ArchConfig, shape: ShapeSpec, mesh,
                impl: str = "auto", schedule: str = "dense",
                accum: Optional[int] = None, fsdp: bool = True) -> CellPlan:
    rules = default_rules(mesh, fsdp=fsdp)
    set_rules(rules)
    acc = cfg.train_accum if accum is None else accum
    step = T.make_train_step(cfg, AdamWConfig(), accum=acc, impl=impl,
                             schedule=schedule)

    params_a = abstract_params(cfg)
    opt_a = abstract_opt_state(cfg)
    batch_a = input_specs(cfg, shape)

    pshard = _tree_ns(mesh, param_pspecs(cfg, rules))
    oshard = _tree_ns(mesh, opt_pspecs(cfg, rules))
    bshard = _input_shardings(mesh, batch_a)
    metrics_shard = {k: _ns(mesh, ()) for k in ("grad_norm", "lr", "loss")}

    return CellPlan(
        fn=_replicated_plain(step),
        args=(params_a, opt_a, batch_a),
        in_shardings=(pshard, oshard, bshard),
        out_shardings=(pshard, oshard, metrics_shard),
        donate_argnums=(0, 1),
        rules=rules,
        meta={"kind": "train", "accum": acc},
    )


# ----------------------------------------------------------------- prefill

def build_prefill(cfg: ArchConfig, shape: ShapeSpec, mesh,
                  impl: str = "auto", schedule: str = "dense") -> CellPlan:
    rules = default_rules(mesh, fsdp=False)   # serve: weights TP, no FSDP
    set_rules(rules)
    ins = input_specs(cfg, shape)
    b = shape.global_batch

    params_a = abstract_params(cfg, torch.bfloat16)
    pshard = _tree_ns(mesh, param_pspecs(cfg, rules))
    inshard = _input_shardings(mesh, ins)

    fn = functools.partial(_prefill_fn, cfg=cfg, impl=impl, schedule=schedule)

    ba = _batch_axes(mesh)
    logits_shard = _ns(mesh, logical_spec((b, cfg.padded_vocab),
                                          ("batch", "vocab"), rules))
    cache_shard = _tree_ns(
        mesh, _cache_pspecs(cfg, b, _stream_len(cfg, shape), rules))

    return CellPlan(
        fn=_replicated_plain(fn),
        args=(params_a, ins),
        in_shardings=(pshard, inshard),
        out_shardings=(logits_shard, cache_shard),
        donate_argnums=(),
        rules=rules,
        meta={"kind": "prefill", "batch_axes": ba},
    )


def _stream_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    # cache length produced by a prefill of this shape (vlm: patches + text)
    return shape.seq_len


def _prefill_fn(params, ins, *, cfg: ArchConfig, impl, schedule):
    with torch.no_grad():
        return T.prefill_step(params, ins["tokens"], cfg,
                              frames=ins.get("frames"),
                              patches=ins.get("patches"),
                              impl=impl, schedule=schedule)


# ------------------------------------------------------------------ decode

def build_decode(cfg: ArchConfig, shape: ShapeSpec, mesh) -> CellPlan:
    """The decode step.  The port's ``decode_step`` takes the new token's
    position as a host int: the plan passes ``seq_len - 1`` (a full
    cache), where the reference compiles for any ``cache_len``."""
    rules = default_rules(mesh, fsdp=False)
    set_rules(rules)
    b, s = shape.global_batch, shape.seq_len
    ins = input_specs(cfg, shape)

    params_a = abstract_params(cfg, torch.bfloat16)
    caches_a = T.init_caches(cfg, b, s, device="meta")

    pshard = _tree_ns(mesh, param_pspecs(cfg, rules))
    cshard = _tree_ns(mesh, _cache_pspecs(cfg, b, s, rules))
    inshard = _input_shardings(mesh, ins)

    fn = functools.partial(_decode_fn, cfg=cfg)

    logits_shard = _ns(mesh, logical_spec((b, cfg.padded_vocab),
                                          ("batch", "vocab"), rules))

    return CellPlan(
        fn=_replicated_plain(fn),
        args=(params_a, caches_a, ins["token"], s - 1),
        in_shardings=(pshard, cshard, inshard["token"], inshard["cache_len"]),
        out_shardings=(logits_shard, cshard),
        donate_argnums=(1,),
        rules=rules,
        meta={"kind": "decode", "cache_len": s - 1},
    )


def _decode_fn(params, caches, token, cache_len, *, cfg: ArchConfig):
    with torch.no_grad():
        return T.decode_step(params, caches, token, cache_len, cfg)


# --------------------------------------------------------------------- ged

def ged_pairs(spec: GedShapeSpec, n_pairs: int, seed: int = 0,
              n_vlabels: int = 64, n_elabels: int = 8):
    """``n_pairs`` (graph, perturbed graph) pairs packed at ``spec.slots``
    slots over the fixed label vocabulary, and their thresholds (the
    number of edits), from ``seed``: the concrete stand-in for the
    reference's abstract ``ged_input_specs``."""
    from repro_torch.core.engine.tensor_graphs import pack_pairs
    from repro_torch.data.graphs import perturb, random_graph

    rng = np.random.default_rng(seed)
    pairs, taus = [], []
    for _ in range(n_pairs):
        n = int(rng.integers(max(2, spec.slots // 2), spec.slots + 1))
        x = int(rng.integers(1, 5))
        base = random_graph(rng, n, 0.2, n_vlabels, n_elabels)
        pairs.append((base, perturb(rng, base, x, n_vlabels, n_elabels)))
        taus.append(float(x))
    packed = pack_pairs(pairs, slots=spec.slots,
                        vocab=(range(n_vlabels), range(1, n_elabels + 1)))
    return packed, np.asarray(taus, np.float32)


def build_ged(spec: GedShapeSpec, mesh, *, n_vlabels: int = 64,
              n_elabels: int = 8, use_kernel: bool = False,
              seed: int = 0, device=None) -> CellPlan:
    """The paper's engine as a mesh workload: pure DP over pairs.

    ``use_kernel=False`` keeps the reference's dry-run setting (the bound
    families unfused); ``reduced_top2`` is not behind it and launches on
    a CUDA device.  ``args`` are one device's share of the pair batch
    (``pairs_per_chip`` pairs) on ``device`` (default the card);
    ``in_shardings`` describe the whole batch over every mesh axis.
    """
    from repro_torch.core.engine.search import EngineConfig, run_eager
    from repro_torch.core.engine.tensor_graphs import to_device
    from repro_torch.device import resolve_device

    set_rules(None)
    dev = resolve_device(device)
    ec = EngineConfig(pool=spec.pool, expand=spec.expand,
                      max_iters=spec.max_iters, sweeps=spec.sweeps,
                      bound="hybrid", strategy="astar",
                      use_kernel=use_kernel)
    n_chips = int(np.prod(list(mesh_axis_sizes(mesh).values())))
    ins = ged_input_specs(spec, n_chips)
    all_axes = tuple(mesh_axis_sizes(mesh))
    keys = ("qv", "gv", "qa", "ga", "order", "n", "taus")
    in_sh = tuple(_ns(mesh, (all_axes,) + (None,) * (ins[k].ndim - 1))
                  for k in keys)

    packed, taus = ged_pairs(spec, spec.pairs_per_chip, seed, n_vlabels,
                             n_elabels)
    pairs = to_device(packed, dev)

    def fn(qv, gv, qa, ga, order, n, taus):
        batch = pairs._replace(qv=qv, gv=gv, qa=qa, ga=ga, order=order, n=n)
        # the eager loop on every device: the dry run counts the ops each
        # step dispatches, which a CUDA graph's replays would not show
        return run_eager(batch, taus, ec, spec.verification)

    args = tuple(pairs[:6]) + (torch.as_tensor(taus, device=dev),)
    return CellPlan(
        fn=fn, args=args, in_shardings=in_sh, out_shardings=None,
        donate_argnums=(), rules=None,
        meta={"kind": "ged-verify" if spec.verification else "ged-compute",
              "pairs": ins["qv"].shape[0], "slots": spec.slots,
              "pool": spec.pool, "local_pairs": spec.pairs_per_chip,
              "device": str(dev)},
    )


# ------------------------------------------------------------------ entry

def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
               **overrides) -> CellPlan:
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, **overrides)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, **overrides)
    if shape.kind == "decode":
        return build_decode(cfg, shape, mesh)
    raise ValueError(shape.kind)


def placed_args(plan: CellPlan, mesh=None) -> Tuple[Any, ...]:
    """``plan.args`` as DTensors in ``plan.in_shardings`` (the LM cells;
    a GED plan's args are already one device's share)."""
    if plan.rules is None:
        return plan.args
    return shard_like(tuple(plan.args), tuple(plan.in_shardings), mesh)
