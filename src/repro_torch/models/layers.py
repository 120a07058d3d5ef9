"""Shared layer library of the port: plain functions over tensors.

A line-for-line counterpart of the reference's ``repro/models/layers.py``.
Every matmul runs through :func:`dot` / :func:`einsum`, which cast both
operands to the compute dtype (bf16 by default) and return that dtype
with f32 accumulation inside, as the reference's ``dot_general(...,
preferred_element_type=f32).astype(cdt)`` does.  On the card the
accumulation stays f32 because :func:`repro_torch.device.resolve_device`
turns off cuBLAS's reduced-precision bf16 reductions (and TF32, so f32
compute stays f32).

The reference annotates tensors with ``repro.parallel.constrain``, a
sharding annotation that is the identity when no sharding rules are
installed, which is always so on its serving path.  The port drops those
calls: its multi-device LM placement belongs to a later slice.

Caches passed to :func:`attention_decode` are written in place (the
reference's donated ``.at[:, slot].set``) and handed back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig

NEG_INF = -1e30

# --------------------------------------------------------------------- util


def cdt(cfg: ArchConfig) -> torch.dtype:
    """The compute dtype (``"bfloat16"`` or ``"float32"``)."""
    return getattr(torch, cfg.compute_dtype)


def dot(x: torch.Tensor, w: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``x @ w`` over x's last and w's first axis, in the compute dtype."""
    dt = cdt(cfg)
    return torch.matmul(x.to(dt), w.to(dt))


def einsum(expr: str, *args: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = cdt(cfg)
    return torch.einsum(expr, *[a.to(dt) for a in args])


# -------------------------------------------------------------------- norms


def norm(x: torch.Tensor, p: Dict, cfg: ArchConfig, eps: float = 1e-6
         ) -> torch.Tensor:
    """``layernorm`` / ``layernorm1p`` / ``rmsnorm`` / ``rmsnorm1p`` in f32
    (the ``1p`` kinds add 1 to the scale); the result in x's dtype."""
    xf = x.float()
    if cfg.norm in ("layernorm", "layernorm1p"):
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)   # population variance
        scale = p["scale"] + 1.0 if cfg.norm == "layernorm1p" else p["scale"]
        out = (xf - mu) * torch.rsqrt(var + eps) * scale + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        xn = xf * torch.rsqrt(ms + eps)
        scale = p["scale"] + 1.0 if cfg.norm == "rmsnorm1p" else p["scale"]
        out = xn * scale
    return out.to(x.dtype)


def head_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                 ) -> torch.Tensor:
    """qk-norm: RMS over the head dim. x: (..., hd), scale: (hd,)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------- rope


def _rope_angles(pos: torch.Tensor, dims: int, theta: float) -> torch.Tensor:
    """pos: (...,) -> (..., dims/2) f32 angles."""
    exps = -torch.arange(0, dims, 2, dtype=torch.float32,
                         device=pos.device) / dims
    freq = float(theta) ** exps
    return pos[..., None].float() * freq


def apply_rope(x: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig,
               theta: Optional[float] = None) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd).

    * pos (B, S): standard RoPE over the first ``rope_pct * hd`` dims
      (rounded down to even: nemotron's partial RoPE);
    * pos (3, B, S): M-RoPE, the rotary half-dims split into
      ``cfg.vlm.mrope_sections`` groups driven by the (t, h, w) streams.
    """
    hd = x.shape[-1]
    rot = int(hd * cfg.rope_pct)
    rot -= rot % 2
    th = cfg.rope_theta if theta is None else theta
    if pos.dim() == 3 and cfg.vlm is not None:
        secs = cfg.vlm.mrope_sections
        assert sum(secs) == rot // 2, (secs, rot)
        full = _rope_angles(pos, rot, th)          # (3, B, S, rot/2)
        parts, start = [], 0
        for i, s in enumerate(secs):
            parts.append(full[i, ..., start:start + s])
            start += s
        ang = torch.cat(parts, -1)                 # (B, S, rot/2)
    else:
        ang = _rope_angles(pos, rot, th)           # (B, S, rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().tensor_split(2, -1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out.to(x.dtype), x_pass], -1)


# ---------------------------------------------------------------- attention


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, f = x.shape
    return x.reshape(b, s, n_heads, f // n_heads)


def qkv_project(x: torch.Tensor, p: Dict, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = dot(x, p["wq"], cfg)
    k = dot(x, p["wk"], cfg)
    v = dot(x, p["wv"], cfg)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = _split_heads(q, cfg.n_heads)
    k = _split_heads(k, cfg.n_kv_heads)
    v = _split_heads(v, cfg.n_kv_heads)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"])
        k = head_rmsnorm(k, p["k_norm"])
    return q, k, v


def _gqa_scores(q, k, cfg: ArchConfig):
    """(B,S,Hq,hd) x (B,T,Hk,hd) -> (B,Hq,S,T) with GQA grouping."""
    b, s, hq, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, s, hk, g, hd)
    out = einsum("bskgd,btkd->bkgst", qg, k, cfg=cfg)
    return out.reshape(b, hk * g, s, t)


def _gqa_out(w, v, cfg: ArchConfig):
    """(B,Hq,S,T) x (B,T,Hk,hd) -> (B,S,Hq,hd)."""
    b, hq, s, t = w.shape
    hk = v.shape[2]
    g = hq // hk
    wg = w.reshape(b, hk, g, s, t)
    out = einsum("bkgst,btkd->bskgd", wg, v, cfg=cfg)
    return out.reshape(b, s, hq, v.shape[-1])


def attention_train(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                    pos: torch.Tensor, window: int = 0,
                    theta: Optional[float] = None,
                    kv_x: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  window>0 = sliding window.

    ``kv_x`` switches to cross-attention (no rope on k, no causal mask).
    """
    b, s, d = x.shape
    if kv_x is None:
        q, k, v = qkv_project(x, p, cfg)
        q = apply_rope(q, pos, cfg, theta)
        k = apply_rope(k, pos, cfg, theta)
        t = s
    else:
        q = _split_heads(dot(x, p["wq"], cfg), cfg.n_heads)
        k = _split_heads(dot(kv_x, p["wk"], cfg), cfg.n_kv_heads)
        v = _split_heads(dot(kv_x, p["wv"], cfg), cfg.n_kv_heads)
        t = kv_x.shape[1]
        causal = False
    scores = _gqa_scores(q, k, cfg).float() / math.sqrt(cfg.hd)
    if causal:
        qi = torch.arange(s, device=x.device)[:, None]
        ki = torch.arange(t, device=x.device)[None, :]
        mask = ki <= qi
        if window > 0:
            mask &= ki > qi - window
        scores = torch.where(mask[None, None], scores, NEG_INF)
    w = torch.softmax(scores, -1)
    o = _gqa_out(w.to(cdt(cfg)), v, cfg)
    o = o.reshape(b, s, -1)
    o = dot(o, p["wo"], cfg)
    if cfg.attn_out_bias:
        o = o + p["bo"].to(o.dtype)
    return o


def attention_decode(x: torch.Tensor, p: Dict, cfg: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, cache_len: int,
                     window: int = 0, theta: Optional[float] = None,
                     rolling: bool = False,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a (B, T, Hk, hd) cache, which is written
    in place at the new token's slot and returned.

    ``rolling=True`` treats the cache as a ring buffer of size ``T``
    (gemma3's local layers): slot = cache_len % T, and every slot is
    valid once cache_len >= T.  ``k_scale``/``v_scale`` (B, Hk) switch to
    an int8 cache: reads dequantise against the per-(batch, head) prefill
    scale, the new row is quantised (clipped) into the same scale.
    """
    b = x.shape[0]
    cache_len = int(cache_len)
    q, k, v = qkv_project(x, p, cfg)           # (B, 1, H*, hd)
    # decode positions: one per row; for M-RoPE archs the three position
    # streams coincide during text decoding, so standard RoPE is exact
    posb = pos.reshape(-1, 1)[:b].expand(b, 1)
    q = apply_rope(q, posb, cfg, theta)
    k = apply_rope(k, posb, cfg, theta)

    t = k_cache.shape[1]
    slot = cache_len % max(t, 1) if rolling else min(cache_len, t - 1)
    dt = cdt(cfg)
    if k_scale is not None:                    # int8-quantised cache
        k_cache[:, slot] = _quant_row(k[:, 0], k_scale)
        v_cache[:, slot] = _quant_row(v[:, 0], v_scale)
        k_eff = k_cache.to(dt) * k_scale[:, None, :, None].to(dt)
        v_eff = v_cache.to(dt) * v_scale[:, None, :, None].to(dt)
    else:
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        k_eff = k_cache.to(dt)
        v_eff = v_cache.to(dt)

    scores = _gqa_scores(q, k_eff, cfg).float()
    scores = scores / math.sqrt(cfg.hd)        # (B, Hq, 1, T)
    if not (rolling and cache_len >= t):
        valid = torch.arange(t, device=x.device) <= slot
        scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, -1)
    o = _gqa_out(w.to(dt), v_eff, cfg)
    o = o.reshape(b, 1, -1)
    o = dot(o, p["wo"], cfg)
    if cfg.attn_out_bias:
        o = o + p["bo"].to(o.dtype)
    return o, k_cache, v_cache


def _quant_row(row: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(B, H, hd) -> int8 against the per-(B, H) scale (clipped).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    q = torch.round(row.float() / torch.clamp(scale[:, :, None], min=1e-8))
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_kv(kc: torch.Tensor, vc: torch.Tensor):
    """(L, B, S, H, hd) caches -> (int8 caches, (L, B, H) f32 scales)."""
    def one(c):
        amax = c.float().abs().amax(dim=(2, 4))
        scale = torch.clamp(amax, min=1e-8) / 127.0        # (L, B, H)
        q = torch.round(c.float() / scale[:, :, None, :, None])
        return torch.clamp(q, -127, 127).to(torch.int8), scale
    kq, ks = one(kc)
    vq, vs = one(vc)
    return kq, vq, ks, vs


def cross_attention_decode(x, p, cfg: ArchConfig, k_cache, v_cache):
    """Decoder cross-attention against precomputed encoder KV (no mask)."""
    b = x.shape[0]
    dt = cdt(cfg)
    q = _split_heads(dot(x, p["wq"], cfg), cfg.n_heads)
    scores = _gqa_scores(q, k_cache.to(dt), cfg).float()
    scores = scores / math.sqrt(cfg.hd)
    w = torch.softmax(scores, -1)
    o = _gqa_out(w.to(dt), v_cache.to(dt), cfg)
    o = dot(o.reshape(b, 1, -1), p["wo"], cfg)
    if cfg.attn_out_bias:
        o = o + p["bo"].to(o.dtype)
    return o


# ----------------------------------------------------------------------- mlp


def mlp(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = F.silu(dot(x, p["wg"], cfg)) * dot(x, p["wi"], cfg)
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(dot(x, p["wi"], cfg)))
    else:  # gelu: jax.nn.gelu's default is the tanh approximation
        h = dot(x, p["wi"], cfg)
        if cfg.mlp_bias:
            h = h + p["bi"].to(h.dtype)
        h = F.gelu(h, approximate="tanh")
    o = dot(h, p["wo"], cfg)
    if cfg.mlp_bias:
        o = o + p["bo"].to(o.dtype)
    return o


# ------------------------------------------------------------------- embeds


def embed_tokens(tokens: torch.Tensor, embed: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    dt = cdt(cfg)
    x = F.embedding(tokens, embed).to(dt)
    if cfg.embed_scale:
        # the reference multiplies by a weakly typed scalar, which JAX
        # rounds to the compute dtype first: round it the same way
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dt))
    return x


def lm_logits(x: torch.Tensor, params: Dict, cfg: ArchConfig
              ) -> torch.Tensor:
    """(B, S, d) -> (B, S, V_padded) f32, rounded through the compute
    dtype first as in the reference."""
    if cfg.tied_embeddings:
        logits = einsum("bsd,vd->bsv", x, params["embed"], cfg=cfg)
    else:
        logits = dot(x, params["lm_head"], cfg)
    return logits.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
