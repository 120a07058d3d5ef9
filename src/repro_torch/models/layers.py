"""Shared layer library of the port: plain functions over tensors.

A line-for-line counterpart of the reference's ``repro/models/layers.py``.
Every matmul runs through :func:`dot` / :func:`einsum`, which cast both
operands to the compute dtype (bf16 by default) and return that dtype
with f32 accumulation inside, as the reference's ``dot_general(...,
preferred_element_type=f32).astype(cdt)`` does.  On the card the
accumulation stays f32 because :func:`repro_torch.device.resolve_device`
turns off cuBLAS's reduced-precision bf16 reductions (and TF32, so f32
compute stays f32).

Tensors are annotated with logical axis names through
:func:`repro_torch.parallel.constrain` at the reference's call sites.  It
is the identity on plain tensors and without installed rules; on the
``torch.distributed.tensor`` (DTensor) steps of ``launch/steps.py`` it
redistributes to the rules' placements, as ``with_sharding_constraint``
does in the reference.

Caches passed to :func:`attention_decode` are written in place (the
reference's donated ``.at[:, slot].set``) and handed back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.parallel.sharding import (constrain, is_distributed,
                                           reduce_partial)

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
    xf = reduce_partial(x).float()
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
    if is_distributed(x):
        x = whole_heads(x, n_heads)
    return x.reshape(b, s, n_heads, f // n_heads)


def whole_heads(x, n_heads: int):
    """A DTensor whose last dim (``n_heads`` heads of equal width) is
    sharded so that no head is split: kept where the heads divide over
    the sharding mesh dims, else gathered (GQA's 8 KV heads on a 16-way
    ``model`` axis), as the reference's per-tensor degrade replicates
    them.  DTensor cannot split a sharded dim into (heads, width)
    otherwise."""
    from torch.distributed.tensor import Replicate

    last, mesh = x.ndim - 1, x.device_mesh
    shards = 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard(last):
            shards *= mesh.size(i)
    if n_heads % shards == 0:
        return x
    return x.redistribute(mesh, [Replicate() if pl.is_shard(last) else pl
                                 for pl in x.placements])


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
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)

    def core(q, k, v):
        scores = _gqa_scores(q, k, cfg).float() / math.sqrt(cfg.hd)
        if causal:
            qi = torch.arange(s, device=q.device)[:, None]
            ki = torch.arange(t, device=q.device)[None, :]
            mask = ki <= qi
            if window > 0:
                mask &= ki > qi - window
            scores = torch.where(mask[None, None], scores, NEG_INF)
        w = torch.softmax(scores, -1)
        return _gqa_out(w.to(cdt(cfg)), v, cfg)

    o = attend_heads(core, q, k, v)
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
        _write_slot(k_cache, slot, _quant_row(k[:, 0], k_scale))
        _write_slot(v_cache, slot, _quant_row(v[:, 0], v_scale))
        k_eff = k_cache.to(dt) * k_scale[:, None, :, None].to(dt)
        v_eff = v_cache.to(dt) * v_scale[:, None, :, None].to(dt)
    else:
        _write_slot(k_cache, slot, k[:, 0].to(k_cache.dtype))
        _write_slot(v_cache, slot, v[:, 0].to(v_cache.dtype))
        k_eff = k_cache.to(dt)
        v_eff = v_cache.to(dt)
    k_cache = constrain(k_cache, "batch", "kv_seq", None, None)
    v_cache = constrain(v_cache, "batch", "kv_seq", None, None)

    valid = None
    if not (rolling and cache_len >= t):
        valid = torch.arange(t, device=x.device) <= slot
    o = _decode_attend(q, k_eff, v_eff, valid, cfg)
    o = o.reshape(b, 1, -1)
    o = dot(o, p["wo"], cfg)
    if cfg.attn_out_bias:
        o = o + p["bo"].to(o.dtype)
    return o, k_cache, v_cache


def _decode_core(q, k_eff, v_eff, valid, cfg: ArchConfig) -> torch.Tensor:
    """Softmax attention of (B, 1, Hq, hd) queries over (B, T, Hk, hd)
    keys / values, ``valid`` (T,) masking slots (None: all valid)."""
    scores = _gqa_scores(q, k_eff, cfg).float()
    scores = scores / math.sqrt(cfg.hd)        # (B, Hq, 1, T)
    if valid is not None:
        scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, -1)
    return _gqa_out(w.to(cdt(cfg)), v_eff, cfg)


def _decode_attend(q, k_eff, v_eff, valid, cfg: ArchConfig) -> torch.Tensor:
    """:func:`_decode_core`; on DTensors, per device over its own batch
    rows and cache-sequence shard (``local_map``).

    A sequence-sharded cache ("kv_seq" over ``model``) is read as
    flash-decode does: each device scores its own slots, and the partial
    softmax numerators and denominators are combined with an all-reduce
    of the max and two of the sums over the sharding mesh dim.  With the
    sequence unsharded the device runs :func:`_decode_core` as is.
    """
    if not is_distributed(k_eff):
        return _decode_core(q, k_eff, v_eff, valid, cfg)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, kp = k_eff.device_mesh, tuple(k_eff.placements)
    seq_dims = [i for i, pl in enumerate(kp)
                if pl.is_shard(1) and mesh.size(i) > 1]
    qp = tuple(pl if pl.is_shard(0) else Replicate() for pl in kp)
    mask_p = tuple(Shard(0) if pl.is_shard(1) else Replicate() for pl in kp)
    if valid is None:
        valid = torch.ones(k_eff.shape[1], dtype=torch.bool,
                           device=k_eff.to_local().device)
    if not is_distributed(valid):
        from torch.distributed.tensor import distribute_tensor
        valid = distribute_tensor(valid, mesh, [Replicate()] * mesh.ndim)

    def local(ql, kl, vl, ml):
        if not seq_dims:
            return _decode_core(ql, kl, vl, ml, cfg)
        import torch.distributed._functional_collectives as funcol

        groups = [(mesh, i) for i in seq_dims]
        scores = _gqa_scores(ql, kl, cfg).float() / math.sqrt(cfg.hd)
        scores = torch.where(ml[None, None, None, :], scores, NEG_INF)
        m = scores.amax(-1, keepdim=True)                  # (B, Hq, 1, 1)
        for grp in groups:
            m = funcol.all_reduce(m, "max", grp)
        e = torch.exp(scores - m) * ml[None, None, None, :]
        den = e.sum(-1, keepdim=True)
        for grp in groups:
            den = funcol.all_reduce(den, "sum", grp)
        # normalised before the cast, as the softmax weights of the
        # unsharded step are; the shards' outputs summed in f32
        o = _gqa_out((e / den).to(cdt(cfg)), vl, cfg).float()
        for grp in groups:
            o = funcol.all_reduce(o, "sum", grp)
        return funcol.wait_tensor(o).to(cdt(cfg))

    return local_map(local, out_placements=list(qp),
                     in_placements=(list(qp), list(kp), list(kp),
                                    list(mask_p)), device_mesh=mesh,
                     redistribute_inputs=True)(q, k_eff, v_eff, valid)


def attend_heads(fn, q, k, v):
    """``fn(q, k, v)``, an attention core over (B, S, H, hd) heads; on
    DTensors, per device over its own batch rows and heads
    (``local_map``), in the layout of the reference's constrain
    ``("batch", None, "heads", None)``: DTensor has no cheap rule for the
    grouped-query einsums.  Where ``model`` splits the query heads but
    not the fewer KV heads, each device takes the KV heads its query
    heads read (query head ``h`` reads KV head ``h // (Hq / Hk)``).
    """
    if not is_distributed(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.sharding import (logical_spec,
                                               spec_to_placements)

    mesh = q.device_mesh
    axes = ("batch", None, "heads", None)
    qp = spec_to_placements(logical_spec(q.shape, axes), mesh)
    kp = spec_to_placements(logical_spec(k.shape, axes), mesh)
    hq, hk = q.shape[2], k.shape[2]
    split = [i for i, (a, b) in enumerate(zip(qp, kp))
             if a.is_shard(2) and not b.is_shard(2)]

    def local(ql, kl, vl):
        if split:
            g = hq // hk
            coord = mesh.get_coordinate()
            r = 0
            for i in split:
                r = r * mesh.size(i) + coord[i]
            n = ql.shape[2]
            lo, hi = r * n // g, ((r + 1) * n - 1) // g + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl)

    from torch.distributed.tensor import Partial

    # a device that reads a slice of replicated KV heads adds gradients
    # to that slice only
    kg = [Partial() if i in split else pl for i, pl in enumerate(kp)]
    return local_map(local, out_placements=list(qp),
                     in_placements=(list(qp), list(kp), list(kp)),
                     in_grad_placements=(list(qp), kg, kg),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _write_slot(cache: torch.Tensor, slot: int, row: torch.Tensor) -> None:
    """``cache[:, slot] = row`` in place.

    DTensor has no in-place rule for a write into a sharded dim, and the
    decode caches are sequence-sharded over ``model`` ("kv_seq"): each
    device writes into its own shard (the one whose sequence range holds
    ``slot``), with ``row`` in the cache's batch layout, as the
    reference's donated ``.at[:, slot].set`` under its constrain does.
    """
    if not is_distributed(cache):
        cache[:, slot] = row
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, placements = cache.device_mesh, cache.placements
    row_pl = [pl if pl.is_shard(0) else Replicate() for pl in placements]
    if is_distributed(row):
        row = row.redistribute(mesh, row_pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, placements)
    local_slot = slot - offset[1]
    if 0 <= local_slot < shape[1]:
        cache.to_local()[:, local_slot] = row


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
    o = _decode_attend(q, k_cache.to(dt), v_cache.to(dt), None, cfg)
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
    h = constrain(h, "batch", None, "ff")
    o = dot(h, p["wo"], cfg)
    if cfg.mlp_bias:
        o = o + p["bo"].to(o.dtype)
    return o


# ------------------------------------------------------------------- embeds


def _lookup(tokens: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, embed)``.  On a DTensor table whose vocab is
    sharded, each device looks up the ids inside its own vocab rows and
    zeroes the rest, and the rows are summed over the vocab-sharding mesh
    dims (``local_map`` with a ``Partial`` output, the vocab-parallel
    embedding): DTensor's own masked-partial rule for it fails once the
    batch is sharded too.  The table's other shards (FSDP over "embed")
    are gathered for the lookup."""
    if not is_distributed(embed):
        return F.embedding(tokens, embed)
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.sharding import sum_over

    mesh, ep = embed.device_mesh, tuple(embed.placements)
    vocab = [i for i, pl in enumerate(ep) if pl.is_shard(0)]
    if not is_distributed(tokens):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim)
    tok_p = [Shard(0) if pl.is_shard(0) and i not in vocab else Replicate()
             for i, pl in enumerate(tokens.placements)]
    tab_p = [Shard(0) if i in vocab else Replicate() for i in range(len(ep))]
    # each batch shard adds its own rows' gradients to the gathered table
    tab_grad = [Partial() if pl.is_shard(0) else tab_p[i]
                for i, pl in enumerate(tok_p)]

    def local(tl, el):
        r, coord = 0, mesh.get_coordinate()
        for i in vocab:
            r = r * mesh.size(i) + coord[i]
        idx = tl.long() - r * el.shape[0]
        inside = (idx >= 0) & (idx < el.shape[0])
        rows = F.embedding(idx.clamp(0, el.shape[0] - 1), el)
        rows = torch.where(inside[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
        return sum_over(rows, mesh, vocab)

    return local_map(local, out_placements=tok_p,
                     in_placements=(tok_p, tab_p),
                     in_grad_placements=(tok_p, tab_grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, embed)


def embed_tokens(tokens: torch.Tensor, embed: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    dt = cdt(cfg)
    x = _lookup(tokens, embed).to(dt)
    if cfg.embed_scale:
        # the reference multiplies by a weakly typed scalar, which JAX
        # rounds to the compute dtype first: round it the same way
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dt))
    return constrain(x, "batch", None, None)


def lm_logits(x: torch.Tensor, params: Dict, cfg: ArchConfig
              ) -> torch.Tensor:
    """(B, S, d) -> (B, S, V_padded) f32, rounded through the compute
    dtype first as in the reference."""
    if cfg.tied_embeddings:
        logits = einsum("bsd,vd->bsv", x, params["embed"], cfg=cfg)
    else:
        logits = dot(x, params["lm_head"], cfg)
    return constrain(logits.float(), "batch", None, "vocab")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
