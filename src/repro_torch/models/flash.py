"""Blocked online-softmax attention ("flash"), the forward pass.

The port of the reference's ``repro/models/flash.py``, which is pure JAX:
its docstring names a Pallas kernel (``repro/kernels/flash_attention.py``)
that was never written, so no TPU kernel lies on this path and this module
is plain PyTorch following the reference's tiling.  Attention is computed
in (block_q x block_k) tiles with running (max, sum, acc) statistics in
f32, so no (S, T) score matrix is ever materialised.  The backward is the
reference's custom VJP (``_fwd_rule`` / ``_bwd_rule``) as a
``torch.autograd.Function``: the forward also keeps the per-row
log-sum-exp, and the backward recomputes each tile's scores from it
instead of saving them, with f32 accumulation of ``dq`` / ``dk`` / ``dv``
over the same tile pairs as the forward, so live memory stays
O(S * block) in both directions.

Two schedules:

* ``schedule="dense"``: every (q tile, k tile) pair, causality by masking;
* ``schedule="tri"``: only the tiles that intersect the causal region.

Both visit a q tile's k tiles in ascending order, so their numerics are
the same.  GQA is native: q (B, S, Hq, hd), k/v (B, T, Hk, hd) with
Hq = G * Hk; tiles contract in grouped form so k/v are never repeated.
``window`` (sliding window), ``kv_valid`` (key padding) and ``q_offset``
are plain ints.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

NEG_INF = -1e30


def _tile_mask(qi, ki, bq, bk, causal, window, kv_valid, q_offset, device):
    """(bq, bk) bool mask for tile (qi, ki)."""
    qpos = q_offset + qi * bq + torch.arange(bq, device=device)[:, None]
    kpos = ki * bk + torch.arange(bk, device=device)[None, :]
    m = kpos < kv_valid
    if causal:
        m = m & (kpos <= qpos)
        if window > 0:
            m = m & (kpos > qpos - window)
    return m


def _pairs(nq: int, nk: int, causal: bool, bq: int, bk: int,
           q_offset: int = 0) -> List[Tuple[int, int]]:
    if not causal:
        return [(q, k) for q in range(nq) for k in range(nk)]
    # the tiles that intersect the causal region.  The reference leaves
    # ``q_offset`` out here, so its "tri" schedule drops needed tiles when
    # the queries are shifted (ROADMAP.md, R4); it only ever passes 0.
    return [(q, k) for q in range(nq) for k in range(nk)
            if k * bk <= q_offset + q * bq + bq - 1]


def _check(q, k, block_q, block_k, schedule):
    s, t = q.shape[1], k.shape[1]
    if s % block_q or t % block_k:
        raise ValueError(f"sequence lengths ({s}, {t}) must be multiples "
                         f"of the blocks ({block_q}, {block_k})")
    if schedule not in ("dense", "tri"):
        raise ValueError(f"unknown schedule {schedule!r}")


def _flash_fwd(q, k, v, causal, schedule, block_q, block_k, window,
               kv_valid, q_offset):
    """(out in q's dtype, the f32 output (B,Hk,G,S,hd), lse (B,Hk,G,S))."""
    b, s, hq, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(hd)
    # products of the inputs are exact in f32: upcasting gives the
    # reference's preferred_element_type=f32 contractions
    qf = q.reshape(b, s, hk, g, hd).movedim(1, 3).float()   # (B,Hk,G,S,hd)
    kf = k.movedim(1, 2).float()                             # (B,Hk,T,hd)
    vf = v.movedim(1, 2).float()

    acc = torch.zeros((b, hk, g, s, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, hk, g, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hk, g, s), dtype=torch.float32, device=q.device)

    tri = schedule == "tri" and causal
    for qi, ki in _pairs(s // block_q, t // block_k, tri, block_q, block_k,
                         q_offset):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        ks = slice(ki * block_k, (ki + 1) * block_k)
        sc = torch.einsum("bkgqd,bktd->bkgqt", qf[:, :, :, qs],
                          kf[:, :, ks]) * scale
        mask = _tile_mask(qi, ki, block_q, block_k, causal, window,
                          kv_valid, q_offset, q.device)
        sc = torch.where(mask, sc, NEG_INF)
        mt, lt = m[..., qs], l[..., qs]
        m_new = torch.maximum(mt, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(mt - m_new)
        l[..., qs] = lt * corr + p.sum(-1)
        pv = torch.einsum("bkgqt,bktd->bkgqd", p, vf[:, :, ks])
        acc[..., qs, :] = acc[..., qs, :] * corr[..., None] + pv
        m[..., qs] = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = acc / l_safe[..., None]
    out_std = out.movedim(3, 1).reshape(b, s, hq, hd).to(q.dtype)
    return out_std, out, m + torch.log(l_safe)


def _flash_bwd(q, k, v, out, lse, do, causal, schedule, block_q, block_k,
               window, kv_valid, q_offset):
    """The reference's ``_flash_bwd_impl``: (dq, dk, dv) in the inputs'
    dtypes, each tile's probabilities recomputed from ``lse``."""
    b, s, hq, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, s, hk, g, hd).movedim(1, 3).float()
    kf = k.movedim(1, 2).float()
    vf = v.movedim(1, 2).float()
    dof = do.reshape(b, s, hk, g, hd).movedim(1, 3).float()
    delta = torch.sum(out * dof, -1)                         # (B,Hk,G,S)

    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    tri = schedule == "tri" and causal
    for qi, ki in _pairs(s // block_q, t // block_k, tri, block_q, block_k,
                         q_offset):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        ks = slice(ki * block_k, (ki + 1) * block_k)
        qt, kt, vt = qf[:, :, :, qs], kf[:, :, ks], vf[:, :, ks]
        dot = dof[:, :, :, qs]
        sc = torch.einsum("bkgqd,bktd->bkgqt", qt, kt) * scale
        mask = _tile_mask(qi, ki, block_q, block_k, causal, window,
                          kv_valid, q_offset, q.device)
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - lse[..., qs, None])               # (B,Hk,G,bq,bk)
        dv_t = torch.einsum("bkgqt,bkgqd->bkgtd", p, dot)
        dp = torch.einsum("bkgqd,bktd->bkgqt", dot, vt)
        ds = p * (dp - delta[..., qs, None]) * scale
        dq[:, :, :, qs] += torch.einsum("bkgqt,bktd->bkgqd", ds, kt)
        # the GQA group sum for dk / dv
        dk[:, :, ks] += torch.einsum("bkgqt,bkgqd->bkgtd", ds, qt).sum(2)
        dv[:, :, ks] += dv_t.sum(2)
    return (dq.movedim(3, 1).reshape(b, s, hq, hd).to(q.dtype),
            dk.movedim(2, 1).to(k.dtype), dv.movedim(2, 1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Blocked forward that keeps (f32 output, lse); recompute-per-tile
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, schedule, block_q, block_k, window,
                kv_valid, q_offset):
        out, out_f32, lse = _flash_fwd(q, k, v, causal, schedule, block_q,
                                       block_k, window, kv_valid, q_offset)
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.static = (causal, schedule, block_q, block_k, window, kv_valid,
                      q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out_f32, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out_f32, lse, do, *ctx.static)
        return (dq, dk, dv) + (None,) * 7


def flash_attention(q, k, v, causal: bool = True, schedule: str = "dense",
                    block_q: int = 512, block_k: int = 512, window: int = 0,
                    kv_valid: int = 10 ** 9, q_offset: int = 0
                    ) -> torch.Tensor:
    """q: (B,S,Hq,hd), k/v: (B,T,Hk,hd) -> (B,S,Hq,hd) in q's dtype.

    S and T must be multiples of ``block_q`` and ``block_k``.
    Differentiable in q, k and v through the blocked backward.
    """
    _check(q, k, block_q, block_k, schedule)
    return _FlashAttention.apply(q, k, v, causal, schedule, block_q,
                                 block_k, int(window), int(kv_valid),
                                 int(q_offset))


def reference_attention(q, k, v, causal=True, window=0, kv_valid=10 ** 9,
                        q_offset=0) -> torch.Tensor:
    """Naive O(S*T) attention in f32 (the reference's oracle, and its
    ``impl="naive"`` path)."""
    b, s, hq, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    window, kv_valid, q_offset = int(window), int(kv_valid), int(q_offset)
    qf = q.reshape(b, s, hk, g, hd).float()
    sc = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    sc = sc / math.sqrt(hd)
    qpos = q_offset + torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    m = kpos < kv_valid
    if causal:
        m = m & (kpos <= qpos)
        if window > 0:
            m = m & (kpos > qpos - window)
    sc = torch.where(m, sc, NEG_INF)
    w = torch.softmax(sc, -1)
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(b, s, hq, hd).to(q.dtype)
