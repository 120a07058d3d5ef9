"""Token-choice top-k MoE with sort-based capacity dispatch.

The port of the reference's ``repro/models/moe.py``.  Tokens are split
into G groups (:func:`_num_groups`; always 1 here: one device, and the
port has no multi-device LM placement), and within each group the
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
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import cdt as compute_dtype
from repro_torch.parallel.ops import top_k_sorted


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
    """Dispatch groups: 1 (the reference's count of batch shards)."""
    return 1


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

    xt = x.reshape(t, d)
    weights, ids, _ = router_topk(xt, p["router"], cfg)

    g = _num_groups(b, s)
    tg = t // g
    cap = capacity(tg, cfg)
    xg = xt.reshape(g, tg, d)
    idg = ids.reshape(g, tg, k)
    groups = [_dispatch_group(xg[i], idg[i], e, cap, cdt) for i in range(g)]
    ex_in = torch.stack([gr[0] for gr in groups])          # (G, E, C, d)

    h = F.silu(_edot(ex_in, p["wg"], cdt)) * _edot(ex_in, p["wi"], cdt)
    ex_out = _edot(h, p["wo"], cdt)                         # (G, E, C, d)

    flat_out = ex_out.reshape(g, e * cap, d)
    per_assign = torch.stack([
        _combine_group(flat_out[i], *groups[i][1:], tg, k)
        for i in range(g)])                                 # (G, Tg, k, d)
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
