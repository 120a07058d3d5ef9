"""Forward passes and step functions of the dense stack.

The port of the reference's ``repro/models/transformer.py`` for the
families that run the dense stack: ``dense`` (qwen3-8b, nemotron-4-15b,
gemma3-1b, qwen2-72b) and ``vlm`` (qwen2-vl-2b).  A pre-norm attention +
MLP block runs over the stacked ``(L, ...)`` parameter tree in a Python
loop, with each layer's window and RoPE theta from :func:`_layer_meta`
(gemma3's 5:1 local:global pattern).

* :func:`forward_hidden` — the whole token stream to final hidden states;
* :func:`prefill_step` — the same forward, also building the decode
  caches (gemma3's local layers as ring buffers; int8 with ``kv_quant``);
* :func:`decode_step` — one token against the caches, which it writes in
  place at the new token's slot (the reference carries them through a
  ``dynamic_update_index_in_dim``).

:func:`cache_shapes` is shape arithmetic and covers every family.  The
other families (``moe``, ``ssm``, ``hybrid``, ``audio``) raise
``NotImplementedError``: their bodies come with later slices
(``ROADMAP.md``), as do ``loss_fn`` / ``make_train_step``.

Every function follows the device of the parameters: token, patch and
position inputs (numpy or tensors) are moved there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.flash import flash_attention, reference_attention

FLASH_MIN = 2048 * 2048   # S*T above which the blocked path is used
BLOCK = 512
PORTED_FAMILIES = ("dense", "vlm")


def _use_flash(s: int, t: int, impl: str) -> bool:
    if impl == "flash":
        return True
    if impl == "naive":
        return False
    return (s * t >= FLASH_MIN) and s % BLOCK == 0 and t % BLOCK == 0


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family outside this slice."""
    if cfg.family not in PORTED_FAMILIES or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            "port's LM path runs the dense and vlm families (see "
            "ROADMAP.md, queue 1)")


def _device(params) -> torch.device:
    return params["embed"].device


def _tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ------------------------------------------------------------ attention wrap

def attention_full(x, p, cfg: ArchConfig, pos, window, theta, *,
                   impl: str = "auto", schedule: str = "dense",
                   causal: bool = True, kv_x=None, kv_valid: int = 10 ** 9):
    """Self- or cross-attention over a full sequence."""
    b, s, _ = x.shape
    if kv_x is None:
        q, k, v = L.qkv_project(x, p, cfg)
        if cfg.rope_pct > 0:
            q = L.apply_rope(q, pos, cfg, theta)
            k = L.apply_rope(k, pos, cfg, theta)
        t = s
    else:
        q = L._split_heads(L.dot(x, p["wq"], cfg), cfg.n_heads)
        k = L._split_heads(L.dot(kv_x, p["wk"], cfg), cfg.n_kv_heads)
        v = L._split_heads(L.dot(kv_x, p["wv"], cfg), cfg.n_kv_heads)
        t = kv_x.shape[1]
        causal = False
    if _use_flash(s, t, impl):
        o = flash_attention(q, k, v, causal, schedule, BLOCK, BLOCK,
                            window, kv_valid, 0)
    else:
        o = reference_attention(q, k, v, causal, window, kv_valid, 0)
    o = L.dot(o.reshape(b, s, -1).to(L.cdt(cfg)), p["wo"], cfg)
    if cfg.attn_out_bias:
        o = o + p["bo"].to(o.dtype)
    return o


# -------------------------------------------------------------- block bodies

def _block_tail(x, a, lp, cfg: ArchConfig):
    """The residual after attention output ``a``: sandwich norms, MLP."""
    if cfg.sandwich_norm:
        a = L.norm(a, lp["ln1b"], cfg)
    x = x + a
    m = L.mlp(L.norm(x, lp["ln2"], cfg), lp["mlp"], cfg)
    if cfg.sandwich_norm:
        m = L.norm(m, lp["ln2b"], cfg)
    return x + m


def dense_block(x, lp, cfg: ArchConfig, pos, window, theta, impl, schedule):
    h = L.norm(x, lp["ln1"], cfg)
    a = attention_full(h, lp["attn"], cfg, pos, window, theta,
                       impl=impl, schedule=schedule)
    return _block_tail(x, a, lp, cfg)


def _layer_meta(cfg: ArchConfig) -> Tuple[List[int], List[float]]:
    """Per-layer (window, rope_theta), 0 = global attention.  Thetas go
    through f32, as the reference's scanned f32 array does."""
    windows = np.asarray(cfg.windows(), np.int32)
    thetas = np.full(cfg.n_layers, cfg.rope_theta, np.float32)
    if cfg.global_rope_theta:
        thetas = np.where(windows == 0, np.float32(cfg.global_rope_theta),
                          thetas)
    return [int(w) for w in windows], [float(t) for t in thetas]


def _embed_stream(params, tokens, cfg: ArchConfig, patches):
    """Token embeddings, with a VLM's patch embeddings prepended."""
    dev = _device(params)
    x = L.embed_tokens(_tensor(tokens, dev, torch.int32), params["embed"],
                       cfg)
    if cfg.vlm is not None and patches is not None:
        x = torch.cat([_tensor(patches, dev).to(x.dtype), x], 1)
    return x


def _positions(pos, b: int, s: int, device) -> torch.Tensor:
    if pos is None or pos.shape[-1] != s:
        return torch.arange(s, dtype=torch.int32,
                            device=device)[None].expand(b, s)
    return _tensor(pos, device)


def forward_hidden(params, tokens, cfg: ArchConfig, *, pos=None,
                   patches=None, frames=None, impl="auto",
                   schedule="dense") -> torch.Tensor:
    """Token stream -> final hidden states (pre final-norm)."""
    check_family(cfg)
    x = _embed_stream(params, tokens, cfg, patches)
    b, s, _ = x.shape
    pos = (torch.arange(s, dtype=torch.int32, device=x.device)[None]
           .expand(b, s) if pos is None else _tensor(pos, x.device))
    windows, thetas = _layer_meta(cfg)
    for i in range(cfg.n_layers):
        x = dense_block(x, _layer(params["layers"], i), cfg, pos,
                        windows[i], thetas[i], impl, schedule)
    return x


# ----------------------------------------------------------------- caches

def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) for the decode state of one model."""
    hk, hd, d = cfg.n_kv_heads, cfg.hd, cfg.d_model
    bf, f32 = torch.bfloat16, torch.float32
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        dims = ssm_lib.rwkv6_dims(cfg)
        h, p = dims["n_heads"], dims["head_dim"]
        out["wkv"] = ((cfg.n_layers, batch, h, p, p), f32)
        out["att_x"] = ((cfg.n_layers, batch, d), f32)
        out["ffn_x"] = ((cfg.n_layers, batch, d), f32)
        return out
    if cfg.family == "ssm" and cfg.ssm.kind == "mamba2":
        dims = ssm_lib.mamba2_dims(cfg)
        out["ssd"] = ((cfg.n_layers, batch, dims["n_heads"],
                       dims["head_dim"], dims["d_state"]), f32)
        out["conv"] = ((cfg.n_layers, batch, cfg.ssm.d_conv - 1,
                        dims["d_inner"]), f32)
        return out
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        n_attn = cfg.n_layers // k
        n_mamba = cfg.n_layers - n_attn
        dims = ssm_lib.mamba2_dims(cfg)
        out["ssd"] = ((n_mamba, batch, dims["n_heads"], dims["head_dim"],
                       dims["d_state"]), f32)
        out["conv"] = ((n_mamba, batch, cfg.ssm.d_conv - 1,
                        dims["d_inner"]), f32)
        out["attn_k"] = ((n_attn, batch, cache_len, hk, hd), bf)
        out["attn_v"] = ((n_attn, batch, cache_len, hk, hd), bf)
        return out
    if cfg.family == "audio":
        es = cfg.encdec.enc_seq
        out["self_k"] = ((cfg.n_layers, batch, cache_len, hk, hd), bf)
        out["self_v"] = ((cfg.n_layers, batch, cache_len, hk, hd), bf)
        out["cross_k"] = ((cfg.n_layers, batch, es, hk, hd), bf)
        out["cross_v"] = ((cfg.n_layers, batch, es, hk, hd), bf)
        return out
    windows = cfg.windows()
    if any(w > 0 for w in windows):      # gemma3: ring-buffer local layers
        n_local = sum(1 for w in windows if w > 0)
        n_global = cfg.n_layers - n_local
        w = max(w for w in windows if w > 0)
        out["local_k"] = ((n_local, batch, min(w, cache_len), hk, hd), bf)
        out["local_v"] = ((n_local, batch, min(w, cache_len), hk, hd), bf)
        out["global_k"] = ((n_global, batch, cache_len, hk, hd), bf)
        out["global_v"] = ((n_global, batch, cache_len, hk, hd), bf)
        return out
    if cfg.kv_quant:
        out["k"] = ((cfg.n_layers, batch, cache_len, hk, hd), torch.int8)
        out["v"] = ((cfg.n_layers, batch, cache_len, hk, hd), torch.int8)
        out["k_scale"] = ((cfg.n_layers, batch, hk), f32)
        out["v_scale"] = ((cfg.n_layers, batch, hk), f32)
        return out
    out["k"] = ((cfg.n_layers, batch, cache_len, hk, hd), bf)
    out["v"] = ((cfg.n_layers, batch, cache_len, hk, hd), bf)
    return out


def init_caches(cfg: ArchConfig, batch: int, cache_len: int,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in cache_shapes(cfg, batch, cache_len).items()}


# -------------------------------------------------------------- decode step

def decode_step(params, caches, token, cache_len: int, cfg: ArchConfig,
                enc=None):
    """One-token decode. token: (B, 1) int32; cache_len: the new token's
    position.

    Returns (logits (B, V) f32, caches); the caches are the ones passed
    in, written in place at the new token's slot.
    """
    check_family(cfg)
    cache_len = int(cache_len)
    x = L.embed_tokens(_tensor(token, _device(params), torch.int32),
                       params["embed"], cfg)
    b = x.shape[0]
    posb = torch.full((b,), cache_len, dtype=torch.int32, device=x.device)
    windows, thetas = _layer_meta(cfg)
    mixed = any(w > 0 for w in windows)
    li = gi = 0
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.norm(x, lp["ln1"], cfg)
        if mixed and windows[i] > 0:      # gemma3 local: ring buffer
            a, _, _ = L.attention_decode(
                h, lp["attn"], cfg, caches["local_k"][li],
                caches["local_v"][li], posb, cache_len, window=windows[i],
                theta=thetas[i], rolling=True)
            li += 1
        elif mixed:                       # gemma3 global
            a, _, _ = L.attention_decode(
                h, lp["attn"], cfg, caches["global_k"][gi],
                caches["global_v"][gi], posb, cache_len, theta=thetas[i])
            gi += 1
        else:
            scales = {}
            if cfg.kv_quant:
                scales = dict(k_scale=caches["k_scale"][i],
                              v_scale=caches["v_scale"][i])
            a, _, _ = L.attention_decode(
                h, lp["attn"], cfg, caches["k"][i], caches["v"][i], posb,
                cache_len, window=0, theta=thetas[i], **scales)
        x = _block_tail(x, a, lp, cfg)
    x = L.norm(x, params["final_norm"], cfg)
    return L.lm_logits(x, params, cfg)[:, 0], caches


# ------------------------------------------------------------- prefill step

def prefill_step(params, tokens, cfg: ArchConfig, *, frames=None,
                 patches=None, pos=None, impl="auto", schedule="dense"):
    """Full-sequence forward that also builds the decode state.

    Returns (last-position logits (B, V), caches covering the stream:
    a VLM's patches and then the S tokens).
    """
    check_family(cfg)
    x, caches = _dense_prefill(params, tokens, cfg, pos, patches, impl,
                               schedule)
    x = L.norm(x, params["final_norm"], cfg)
    return L.lm_logits(x[:, -1:], params, cfg)[:, 0], caches


def _attn_with_cache(h, lp_attn, cfg, pos_arr, w, th, impl, schedule):
    """Full-seq self attention returning (out, roped k, v) for the cache."""
    q, kk, vv = L.qkv_project(h, lp_attn, cfg)
    if cfg.rope_pct > 0:
        q = L.apply_rope(q, pos_arr, cfg, th)
        kk = L.apply_rope(kk, pos_arr, cfg, th)
    s = h.shape[1]
    if _use_flash(s, s, impl):
        o = flash_attention(q, kk, vv, True, schedule, BLOCK, BLOCK, w,
                            10 ** 9, 0)
    else:
        o = reference_attention(q, kk, vv, True, w, 10 ** 9, 0)
    o = L.dot(o.reshape(h.shape[0], s, -1).to(L.cdt(cfg)), lp_attn["wo"],
              cfg)
    if cfg.attn_out_bias:
        o = o + lp_attn["bo"].to(o.dtype)
    return o, kk.to(torch.bfloat16), vv.to(torch.bfloat16)


def _dense_prefill(params, tokens, cfg, pos, patches, impl, schedule):
    x = _embed_stream(params, tokens, cfg, patches)
    b, s, _ = x.shape
    # positions over the whole stream unless the caller gave them for it
    pos_arr = _positions(pos, b, s, x.device)
    windows, thetas = _layer_meta(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.norm(x, lp["ln1"], cfg)
        a, kk, vv = _attn_with_cache(h, lp["attn"], cfg, pos_arr,
                                     windows[i], thetas[i], impl, schedule)
        x = _block_tail(x, a, lp, cfg)
        ks.append(kk)
        vs.append(vv)

    kc, vc = torch.stack(ks), torch.stack(vs)      # (L, B, S, Hk, hd)
    if not any(w > 0 for w in windows):
        if cfg.kv_quant:
            kq, vq, kscale, vscale = L.quantize_kv(kc, vc)
            return x, {"k": kq, "v": vq, "k_scale": kscale,
                       "v_scale": vscale}
        return x, {"k": kc, "v": vc}
    # gemma3: ring-buffer local caches + full global ones.  Position p
    # lives in slot p % keep (decode indexes the ring modulo its size),
    # so the last ``keep`` positions are scattered accordingly.
    keep = min(max(windows), s)
    tail = torch.arange(s - keep, s, device=x.device)
    ring = torch.empty_like(tail)
    ring[tail % keep] = tail             # ring[slot] = the position it holds
    local = torch.tensor([i for i, w in enumerate(windows) if w > 0],
                         dtype=torch.long, device=x.device)
    glob = torch.tensor([i for i, w in enumerate(windows) if w == 0],
                        dtype=torch.long, device=x.device)
    return x, {"local_k": kc[local][:, :, ring],
               "local_v": vc[local][:, :, ring],
               "global_k": kc[glob], "global_v": vc[glob]}
