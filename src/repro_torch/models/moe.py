"""Token-choice top-k MoE with sort-based capacity dispatch.

The port of the reference's ``repro/models/moe.py``.  Tokens are split
into G groups (:func:`_num_groups`: the batch-shard count of the
installed sharding rules, else 1), and within each group the
assignments are sorted by expert, ranked, and the first ``cap`` of each
expert's are scattered into an ``(E, C, d)`` buffer.  The expert MLPs
contract that buffer with the ``(E, ...)`` weight stacks as one batched
matmul, and the combine gathers each kept assignment's output back and
weights it.

Shared experts (qwen2-moe) are plain always-on MLPs added to the output.
Padded experts (60 -> 64) are real rows of the weight stacks whose router
logits are masked to -1e30, so they never win top-k.

A dropped assignment (rank >= ``cap``) is written to the buffer's spare
row ``E * C``, which nothing reads.  The reference sends it to row
``Tg * k`` (its ``moe.py:99``), which is a live slot whenever
``Tg * k < E * C``, so a dropped token's activations overwrite a kept
token's input there (``ROADMAP.md``, R5); with drop-free capacity the two
agree exactly.

On the DTensor steps of ``launch/steps.py`` the dispatch and the combine
(sorts, scatters and gathers that DTensor has no sharding rule for) run
under ``local_map``: each device handles the groups of its own batch
shard, in the placements the reference's ``constrain`` calls set.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import cdt as compute_dtype
from repro_torch.parallel.ops import top_k_sorted
from repro_torch.parallel.sharding import constrain, get_rules, is_distributed


def router_topk(x: torch.Tensor, wr: torch.Tensor, cfg: ArchConfig):
    """x: (T, d) -> (weights (T, k) f32, ids (T, k), probs (T, E)) with
    padded experts masked."""
    moe = cfg.moe
    logits = x.float() @ wr.float()
    if moe.total_experts != moe.num_experts:
        pad = torch.arange(moe.total_experts,
                           device=x.device) >= moe.num_experts
        logits = logits.masked_fill(pad[None, :], -1e30)
    probs = torch.softmax(logits, -1)
    _, ids = top_k_sorted(probs, moe.top_k)
    weights = torch.gather(probs, -1, ids)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids, probs


def capacity(tokens: int, cfg: ArchConfig) -> int:
    moe = cfg.moe
    c = int(math.ceil(tokens * moe.top_k / moe.total_experts
                      * moe.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def _num_groups(b: int, s: int) -> int:
    """Groups = batch-shard count, so per-group dispatch is shard-local."""
    rules = get_rules()
    if rules is None:
        return 1
    g = rules.mesh_size(rules.table.get("batch"))
    if g <= 1 or b % g != 0:
        return 1
    return g


def _dispatch_group(xg: torch.Tensor, idg: torch.Tensor, e: int, cap: int,
                    cdt: torch.dtype):
    """One group's sort-based dispatch.  xg: (Tg, d), idg: (Tg, k).

    Returns (ex_in (E, C, d), slot (Tg*k,), keep (Tg*k,), inv (Tg*k,)).
    """
    tg, k = idg.shape
    dev = xg.device
    flat_ids = idg.reshape(tg * k)
    token_idx = torch.arange(tg, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    sorted_tok = token_idx[order]
    pos = torch.arange(tg * k, device=dev)
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(e, device=dev,
                                             dtype=sorted_ids.dtype))
    rank = pos - starts[sorted_ids]
    keep = rank < cap
    # a dropped assignment goes to the spare row E*C (R5: not Tg*k)
    slot = torch.where(keep, sorted_ids * cap + rank, e * cap)

    buf = torch.zeros((e * cap + 1, xg.shape[-1]), dtype=cdt, device=dev)
    buf[slot] = xg[sorted_tok].to(cdt)
    ex_in = buf[:-1].reshape(e, cap, xg.shape[-1])
    inv = torch.empty_like(order)
    inv[order] = pos
    return ex_in, slot, keep, inv


def _combine_group(ex_out_flat: torch.Tensor, slot: torch.Tensor,
                   keep: torch.Tensor, inv: torch.Tensor, tg: int, k: int
                   ) -> torch.Tensor:
    """Undo one group's dispatch: (E*C, d) -> (Tg, k, d)."""
    rows = ex_out_flat[slot.clamp(0, ex_out_flat.shape[0] - 1)]
    picked = torch.where(keep[:, None], rows, torch.zeros_like(rows))
    return picked[inv].reshape(tg, k, -1)


def _dispatch(xg: torch.Tensor, idg: torch.Tensor, e: int, cap: int,
              cdt: torch.dtype):
    """Every group's dispatch: (G, Tg, d), (G, Tg, k) -> (ex_in (G, E, C,
    d), slot, keep, inv (G, Tg*k))."""
    groups = [_dispatch_group(xg[i], idg[i], e, cap, cdt)
              for i in range(xg.shape[0])]
    return tuple(torch.stack([gr[j] for gr in groups]) for j in range(4))


def _combine(flat_out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             inv: torch.Tensor, tg: int, k: int) -> torch.Tensor:
    """Every group's combine: (G, E*C, d) -> (G, Tg, k, d)."""
    return torch.stack([_combine_group(flat_out[i], slot[i], keep[i],
                                       inv[i], tg, k)
                        for i in range(flat_out.shape[0])])


def _by_group(fn, n_out: int, *tensors):
    """``fn`` over the local groups of each device when ``tensors`` are
    DTensors (``local_map``: no DTensor rule covers the sort-based
    dispatch), all in the first tensor's placements; else ``fn`` itself."""
    if not is_distributed(tensors[0]):
        return fn(*tensors)
    from torch.distributed.tensor.experimental import local_map

    pl = list(tensors[0].placements)
    out = (pl,) * n_out if n_out > 1 else pl
    return local_map(fn, out_placements=out, in_placements=(pl,) * len(
        tensors), device_mesh=tensors[0].device_mesh,
        redistribute_inputs=True)(*tensors)


def _edot(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype
          ) -> torch.Tensor:
    """(G, E, C, x) @ (E, x, y) -> (G, E, C, y), batched over E, in the
    compute dtype (f32 accumulation)."""
    g, e, c, x = a.shape
    ae = a.transpose(0, 1).reshape(e, g * c, x)
    out = torch.bmm(ae.to(cdt), w.to(cdt))
    return out.reshape(e, g, c, -1).transpose(0, 1)


def moe_mlp(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). p holds router + expert + shared weights."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = moe.top_k
    e = moe.total_experts
    cdt = compute_dtype(cfg)

    # the tokens keep the batch layout (a DTensor would otherwise take
    # gradients split over every mesh dim, which do not fold back to B)
    xt = constrain(x.reshape(t, d), "batch", None)
    weights, ids, _ = router_topk(xt, p["router"], cfg)

    g = _num_groups(b, s)
    tg = t // g
    cap = capacity(tg, cfg)
    xg = xt.reshape(g, tg, d)
    xg = constrain(xg, "batch", None, None)
    idg = ids.reshape(g, tg, k)
    ex_in, slot, keep, inv = _by_group(
        lambda xx, ii: _dispatch(xx, ii, e, cap, cdt), 4, xg, idg)
    # (G, E, C, d): G over (pod, data); E replicated here
    ex_in = constrain(ex_in, "batch", None, None, None)

    ex_in_e = constrain(ex_in, "batch", "expert", None, None)
    h = F.silu(_edot(ex_in_e, p["wg"], cdt)) * _edot(ex_in_e, p["wi"], cdt)
    ex_out = _edot(h, p["wo"], cdt)                         # (G, E, C, d)
    # the combine needs every expert's rows on each device
    ex_out = constrain(ex_out, "batch", None, None, None)

    flat_out = ex_out.reshape(g, e * cap, d)
    per_assign = _by_group(lambda fo, sl, kp, iv: _combine(fo, sl, kp, iv,
                                                           tg, k),
                           1, flat_out, slot, keep, inv)    # (G, Tg, k, d)
    wgt = weights.reshape(g, tg, k)
    # bf16 operands, f32 accumulation, as the reference's combine
    out = torch.einsum("gtk,gtkd->gtd", wgt.to(cdt), per_assign.to(cdt))
    out = out.reshape(t, d)

    if moe.shared_experts:
        xc = xt.to(cdt)
        sh = F.silu(xc @ p["shared_wg"].to(cdt)) * (xc @ p["shared_wi"].to(cdt))
        out = out + sh @ p["shared_wo"].to(cdt)
    return out.reshape(b, s, d)


def aux_loss(probs: torch.Tensor, ids: torch.Tensor, cfg: ArchConfig
             ) -> torch.Tensor:
    """Switch-style load-balancing loss (mean prob * mean assignment rate)."""
    e = cfg.moe.total_experts
    flat = ids.reshape(-1)
    assign = torch.zeros(e, dtype=torch.float32, device=probs.device)
    assign.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                          device=probs.device))
    assign = assign / torch.clamp(assign.sum(), min=1.0)
    imp = probs.mean(0)
    return e * torch.sum(assign * imp)
