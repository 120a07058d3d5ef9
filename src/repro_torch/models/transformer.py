"""Forward passes and step functions for all ten architectures.

The port of the reference's ``repro/models/transformer.py``.  The
reference scans one block body over a stacked ``(L, ...)`` parameter
tree; the port loops over the layers in Python, one family at a time:

* dense / moe / vlm: a pre-norm attention + (MLP | MoE) block, with each
  layer's window and RoPE theta from :func:`_layer_meta` (gemma3's 5:1
  local:global pattern);
* ssm (rwkv6 / mamba2): token-shift / SSD blocks, chunked for prefill,
  an O(1)-state recurrence for decode (``models/ssm.py``);
* hybrid (zamba2): groups of ``k - 1`` mamba layers, each followed by
  the ONE weight-shared attention block, then the remaining mamba layers;
* audio (whisper): a non-causal encoder stack over pre-embedded frames
  (padded to a multiple of 512, the pad masked) and a decoder stack with
  cross-attention; sinusoidal positions on both.

Entry points:

* :func:`forward_hidden` — the whole stream to final hidden states;
* :func:`prefill_step` — the same forward, also building the decode
  state (gemma3's local layers as ring buffers; int8 with ``kv_quant``;
  the final SSM states; whisper's cross K/V);
* :func:`decode_step` — one token against that state.  Attention caches
  are written in place at the new token's slot (the reference carries
  them through a ``dynamic_update_index_in_dim``); SSM states are
  replaced by new tensors.

* :func:`loss_fn` / :func:`make_train_step` — the masked cross-entropy
  of :func:`forward_hidden`'s logits, and one AdamW step on its
  gradients, with ``accum`` sequential microbatches summed in f32.

The training forward unbinds each stacked ``(L, ...)`` leaf once
(:func:`_unstack`): indexing a stack once per layer would, under
autograd, allocate a zero tensor of the whole stack per layer in the
backward.  With ``cfg.remat == "full"`` each layer (each zamba2 group,
each whisper layer) runs under ``torch.utils.checkpoint`` while grad is
enabled, where the reference applies ``jax.checkpoint``.

On the DTensor steps of ``launch/steps.py`` the same functions run on
placed parameters: ``constrain`` sits at the reference's sites, each
block's output (the residual stream) and its gradient keep the batch
layout, attention runs per device over its own heads
(``layers.attend_heads``), and the loss picks each label's logit from
the device that holds it (:func:`_gold`).  On plain tensors all of these
are the identity or the plain computation.

Every function follows the device of the parameters: token, patch,
frame, position, label and mask inputs (numpy or tensors) are moved
there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.flash import flash_attention, reference_attention
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.parallel.sharding import (constrain, is_distributed,
                                           placed_like)

FLASH_MIN = 2048 * 2048   # S*T above which the blocked path is used
BLOCK = 512


def _use_flash(s: int, t: int, impl: str) -> bool:
    if impl == "flash":
        return True
    if impl == "naive":
        return False
    return (s * t >= FLASH_MIN) and s % BLOCK == 0 and t % BLOCK == 0


def _device(params) -> torch.device:
    return params["embed"].device


def _tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer of a stacked parameter tree, one ``unbind`` per leaf
    (views; under autograd one ``UnbindBackward`` per leaf)."""
    parts = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """``fn`` under activation checkpointing when ``cfg.remat == "full"``
    and grad is enabled (the reference's ``jax.checkpoint``).

    The block's output (the residual stream) is constrained to the batch
    layout ("batch", None, None), and so is its gradient: on DTensors this
    keeps DTensor from carrying a sequence-sharded stream (and its
    gradients) from block to block, whose ``(B*S, d)`` matmul folds have
    no cheap sharding rule.  It is the identity on plain tensors.
    """
    def stream(x):
        return constrain(x, "batch", None, None)

    if cfg.remat != "full":
        return lambda *args: stream(fn(*args))

    def run(*args):
        if not torch.is_grad_enabled():
            return stream(fn(*args))
        return stream(torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False))
    return run


def sinusoid_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32 table, computed in f64 and rounded once, as the
    reference's numpy table is."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    tab = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(tab.astype(np.float32), device=device)


def sinusoid_row(pos: int, d: int, device=None) -> torch.Tensor:
    """The sinusoid row at position ``pos``, computed in f32 as the
    reference's traced row is."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) \
        / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])


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
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)
    if _use_flash(s, t, impl):
        o = L.attend_heads(lambda q, k, v: flash_attention(
            q, k, v, causal, schedule, BLOCK, BLOCK, window, kv_valid, 0),
            q, k, v)
    else:
        o = L.attend_heads(lambda q, k, v: reference_attention(
            q, k, v, causal, window, kv_valid, 0), q, k, v)
    o = L.dot(o.reshape(b, s, -1).to(L.cdt(cfg)), p["wo"], cfg)
    if cfg.attn_out_bias:
        o = o + p["bo"].to(o.dtype)
    return o


# -------------------------------------------------------------- block bodies

def _block_tail(x, a, lp, cfg: ArchConfig):
    """The residual after attention output ``a``: sandwich norms, then
    the MLP, or the MoE where ``cfg.moe`` is set."""
    if cfg.sandwich_norm:
        a = L.norm(a, lp["ln1b"], cfg)
    x = x + a
    h = L.norm(x, lp["ln2"], cfg)
    if cfg.moe is not None:
        m = moe_lib.moe_mlp(h, lp["moe"], cfg)
    else:
        m = L.mlp(h, lp["mlp"], cfg)
    if cfg.sandwich_norm:
        m = L.norm(m, lp["ln2b"], cfg)
    return x + m


def dense_block(x, lp, cfg: ArchConfig, pos, window, theta, impl, schedule):
    h = L.norm(x, lp["ln1"], cfg)
    a = attention_full(h, lp["attn"], cfg, pos, window, theta,
                       impl=impl, schedule=schedule)
    return _block_tail(x, a, lp, cfg)


def rwkv_block(x, lp, cfg: ArchConfig, prev=None):
    """One RWKV6 layer; ``prev`` = (wkv, att_x, ffn_x) decodes one token
    against that state.  Returns (x, (wkv, att_x, ffn_x))."""
    wkv, ax, fx = prev if prev is not None else (None, None, None)
    h = L.norm(x, lp["ln1"], cfg)
    a, wkv, ax = ssm_lib.rwkv6_time_mix(h, lp["rwkv"], cfg, prev_x=ax,
                                        state=wkv)
    x = x + a
    h = L.norm(x, lp["ln2"], cfg)
    m, fx = ssm_lib.rwkv6_channel_mix(h, lp["rwkv"], cfg, prev_x=fx)
    return x + m, (wkv, ax, fx)


def mamba_block(x, lp, cfg: ArchConfig):
    h = L.norm(x, lp["ln1"], cfg)
    return x + ssm_lib.mamba2_train(h, lp["mamba"], cfg)


def _mamba_prefill_block(x, lp, cfg: ArchConfig):
    h = L.norm(x, lp["ln1"], cfg)
    a, st = ssm_lib.mamba2_train(h, lp["mamba"], cfg, return_state=True)
    return x + a, st


def _mamba_decode_block(x, lp, cfg: ArchConfig, ssd, conv):
    h = L.norm(x, lp["ln1"], cfg)
    a, st = ssm_lib.mamba2_decode(h, lp["mamba"], cfg,
                                  {"ssd": ssd, "conv": conv})
    return x + a, st


def _shared_tail(x, a, sp, cfg: ArchConfig):
    x = x + a
    h = L.norm(x, sp["ln2"], cfg)
    return x + L.mlp(h, sp["mlp"], cfg)


def shared_attn_block(x, sp, cfg: ArchConfig, pos, impl, schedule):
    h = L.norm(x, sp["ln1"], cfg)
    a = attention_full(h, sp["attn"], cfg, pos, 0, cfg.rope_theta,
                       impl=impl, schedule=schedule)
    return _shared_tail(x, a, sp, cfg)


def _layer_meta(cfg: ArchConfig) -> Tuple[List[int], List[float]]:
    """Per-layer (window, rope_theta), 0 = global attention.  Thetas go
    through f32, as the reference's scanned f32 array does."""
    windows = np.asarray(cfg.windows(), np.int32)
    thetas = np.full(cfg.n_layers, cfg.rope_theta, np.float32)
    if cfg.global_rope_theta:
        thetas = np.where(windows == 0, np.float32(cfg.global_rope_theta),
                          thetas)
    return [int(w) for w in windows], [float(t) for t in thetas]


def _zamba_layout(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(groups, mamba layers per group, mamba layers in all groups, mamba
    layers): the stacked mamba layers ``[0, grouped)`` run in groups, each
    followed by the shared block, and the rest after the last group."""
    k = cfg.hybrid_attn_every
    n_attn = cfg.n_layers // k
    return n_attn, k - 1, n_attn * (k - 1), cfg.n_layers - n_attn


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
    if cfg.family == "audio":
        enc = whisper_encode(params, frames, cfg, impl, schedule)
        return whisper_decoder_hidden(params, tokens, enc, cfg, impl,
                                      schedule)
    x = _embed_stream(params, tokens, cfg, patches)
    b, s, _ = x.shape
    pos = (torch.arange(s, dtype=torch.int32, device=x.device)[None]
           .expand(b, s) if pos is None else _tensor(pos, x.device))
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        block = _remat(lambda c, lp: rwkv_block(c, lp, cfg)[0], cfg)
        for lp in _unstack(params["layers"]):
            x = block(x, lp)
        return x
    if cfg.family == "ssm" and cfg.ssm.kind == "mamba2":
        block = _remat(lambda c, lp: mamba_block(c, lp, cfg), cfg)
        for lp in _unstack(params["layers"]):
            x = block(x, lp)
        return x
    if cfg.family == "hybrid":
        return zamba_hidden(params, x, cfg, pos, impl, schedule)
    windows, thetas = _layer_meta(cfg)
    block = _remat(lambda c, lp, w, th: dense_block(c, lp, cfg, pos, w, th,
                                                    impl, schedule), cfg)
    for i, lp in enumerate(_unstack(params["layers"])):
        x = block(x, lp, windows[i], thetas[i])
    return x


def zamba_hidden(params, x, cfg: ArchConfig, pos, impl, schedule):
    n_attn, per_group, grouped, n_mamba = _zamba_layout(cfg)
    mam, shared = _unstack(params["layers"]), params["shared_attn"]

    def group(c, lps):
        for lp in lps:
            c = mamba_block(c, lp, cfg)
        return shared_attn_block(c, shared, cfg, pos, impl, schedule)

    group, inner = _remat(group, cfg), _remat(
        lambda c, lp: mamba_block(c, lp, cfg), cfg)
    for g in range(n_attn):
        x = group(x, mam[g * per_group:(g + 1) * per_group])
    for j in range(grouped, n_mamba):
        x = inner(x, mam[j])
    return x


# ------------------------------------------------------------------ whisper

def _enc_pad(cfg: ArchConfig) -> int:
    es = cfg.encdec.enc_seq
    return -(-es // BLOCK) * BLOCK if es >= BLOCK else es


def _pad_enc(enc: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    pad = _enc_pad(cfg) - enc.shape[1]
    return torch.nn.functional.pad(enc, (0, 0, 0, pad)) if pad else enc


def whisper_encode(params, frames, cfg: ArchConfig, impl="auto",
                   schedule="dense") -> torch.Tensor:
    """frames: (B, enc_seq, d) pre-embedded (the conv frontend is a stub,
    as in the reference)."""
    dev, dt = _device(params), L.cdt(cfg)
    frames = _tensor(frames, dev)
    b, es, d = frames.shape
    x = frames.to(dt) + sinusoid_pos(es, d, dev)[None].to(dt)
    x = _pad_enc(x, cfg)
    pos = torch.arange(x.shape[1], dtype=torch.int32,
                       device=dev)[None].expand(b, x.shape[1])

    def layer(c, lp):
        h = L.norm(c, lp["ln1"], cfg)
        c = c + attention_full(h, lp["attn"], cfg, pos, 0, cfg.rope_theta,
                               impl=impl, schedule=schedule, causal=False,
                               kv_valid=es)
        h = L.norm(c, lp["ln2"], cfg)
        return c + L.mlp(h, lp["mlp"], cfg)

    layer = _remat(layer, cfg)
    for lp in _unstack(params["enc_layers"]):
        x = layer(x, lp)
    x = L.norm(x, params["enc_final_norm"], cfg)
    return x[:, :es]


def _whisper_dec_embed(params, tokens, cfg: ArchConfig):
    x = _embed_stream(params, tokens, cfg, None)
    b, s, _ = x.shape
    x = x + sinusoid_pos(s, cfg.d_model, x.device)[None].to(x.dtype)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None] \
        .expand(b, s)
    return x, pos


def whisper_decoder_hidden(params, tokens, enc, cfg: ArchConfig,
                           impl="auto", schedule="dense") -> torch.Tensor:
    x, pos = _whisper_dec_embed(params, tokens, cfg)
    es = enc.shape[1]
    enc_p = _pad_enc(enc, cfg)

    def layer(c, lp):
        h = L.norm(c, lp["ln1"], cfg)
        c = c + attention_full(h, lp["attn"], cfg, pos, 0, cfg.rope_theta,
                               impl=impl, schedule=schedule)
        h = L.norm(c, lp["ln2"], cfg)
        c = c + attention_full(h, lp["cross"], cfg, pos, 0, cfg.rope_theta,
                               impl=impl, schedule=schedule, kv_x=enc_p,
                               kv_valid=es)
        h = L.norm(c, lp["ln3"], cfg)
        return c + L.mlp(h, lp["mlp"], cfg)

    layer = _remat(layer, cfg)
    for lp in _unstack(params["layers"]):
        x = layer(x, lp)
    return x


# --------------------------------------------------------------------- loss

def masked_cross_entropy(logits, labels, vocab: int, mask=None
                         ) -> torch.Tensor:
    """Mean next-token NLL in f32 over the real vocabulary (padded
    columns masked out); with ``mask``, the mean over its weight."""
    logits = logits.float()
    if logits.shape[-1] > vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
        logits = torch.where(pad, -1e30, logits)
    logz = torch.logsumexp(logits, -1)
    labels = _tensor(labels, logits.device, torch.long)
    gold = _gold(logits, labels)
    nll = logz - gold
    if mask is not None:
        mask = _tensor(mask, logits.device).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _gold(logits, labels):
    """``logits[..., labels]``.  On a DTensor whose vocab dim is sharded,
    each device picks the labels inside its own vocab range and the
    picks are summed over the sharding mesh dims (``local_map``):
    DTensor's gather rule for a vocab-sharded operand does not cover this
    shape."""
    if not is_distributed(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.sharding import sum_over

    mesh, lp = logits.device_mesh, tuple(logits.placements)
    last = logits.ndim - 1
    vocab_dims = [i for i, pl in enumerate(lp) if pl.is_shard(last)]
    lab_p = [Replicate() if pl.is_shard(last) else pl for pl in lp]
    out_p = [Replicate() if pl.is_shard(last) else pl for pl in lp]
    if not is_distributed(labels):
        from torch.distributed.tensor import distribute_tensor
        labels = distribute_tensor(labels, mesh, [Replicate()] * mesh.ndim)

    def local(zl, lab):
        r, coord = 0, mesh.get_coordinate()
        for i in vocab_dims:
            r = r * mesh.size(i) + coord[i]
        idx = lab - r * zl.shape[-1]
        inside = (idx >= 0) & (idx < zl.shape[-1])
        g = torch.gather(zl, -1, idx.clamp(0, zl.shape[-1] - 1)[..., None])
        return sum_over(torch.where(inside, g[..., 0], 0.0), mesh,
                        vocab_dims)

    return local_map(local, out_placements=out_p, in_placements=(list(lp),
                     lab_p), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def loss_fn(params, batch: Dict[str, Any], cfg: ArchConfig, impl="auto",
            schedule="dense") -> torch.Tensor:
    """The batch's loss: ``tokens``, ``labels`` and the optional ``pos``,
    ``patches``, ``frames`` and ``loss_mask``.  A VLM's loss leaves out
    the patch positions."""
    h = forward_hidden(params, batch["tokens"], cfg, pos=batch.get("pos"),
                       patches=batch.get("patches"),
                       frames=batch.get("frames"), impl=impl,
                       schedule=schedule)
    if cfg.vlm is not None and batch.get("patches") is not None:
        h = h[:, batch["patches"].shape[1]:]       # loss on text positions
    h = L.norm(h, params["final_norm"], cfg)
    logits = L.lm_logits(h, params, cfg)
    return masked_cross_entropy(logits, batch["labels"], cfg.vocab,
                                batch.get("loss_mask"))


# --------------------------------------------------------------- train step

def _value_and_grad(params, batch, cfg: ArchConfig, impl, schedule):
    """(loss, grads with the params' tree); a leaf the loss does not reach
    (zamba2's shared block below ``hybrid_attn_every`` layers) gets zeros,
    as under ``jax.grad``."""
    paths, leaves = zip(*tree_leaves(params))
    flags = [leaf.requires_grad for leaf in leaves]
    try:
        for leaf in leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(params, batch, cfg, impl, schedule)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for leaf, flag in zip(leaves, flags):
            leaf.requires_grad_(flag)
    by_path = {p: torch.zeros_like(leaf) if g is None else g
               for p, leaf, g in zip(paths, leaves, grads)}
    return loss.detach(), _like(params, by_path)


def _like(tree, by_path: Dict[str, Any], prefix: str = ""):
    """``tree``'s nested dicts with the leaf at each path from
    ``by_path``."""
    if isinstance(tree, dict):
        return {k: _like(v, by_path, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return by_path[prefix]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, accum: int = 1,
                    impl="auto", schedule="dense"):
    """Returns train_step(params, opt_state, batch) -> (params', opt',
    metrics).

    ``accum`` splits the batch into sequential microbatches along axis 0:
    activation memory peaks at one microbatch's, and the gradients are
    summed in f32, then divided by ``accum``, as is the loss.  The AdamW
    update writes into ``params`` and ``opt_state`` in place
    (:func:`repro_torch.optim.adamw_update`).
    """
    sched = cosine_schedule(opt_cfg.warmup, opt_cfg.total_steps,
                            opt_cfg.min_lr_frac)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = _value_and_grad(params, batch, cfg, impl, schedule)
        else:
            leaves = dict(tree_leaves(params))
            grads, loss = None, torch.zeros((), device=_device(params))
            for i in range(accum):
                mb = {k: _microbatch(v, accum, i) for k, v in batch.items()}
                l, g = _value_and_grad(params, mb, cfg, impl, schedule)
                if grads is None:
                    # f32 sums in the parameters' layout (their shards)
                    grads = {p: torch.zeros_like(leaves[p],
                                                 dtype=torch.float32)
                             for p, _ in tree_leaves(g)}
                for p, t in tree_leaves(g):
                    grads[p].add_(placed_like(t, leaves[p]).float())
                del g
                loss = loss + l
            for t in grads.values():
                t.div_(accum)
            grads = _like(params, grads)
            loss = loss / accum
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt_cfg, sched)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _microbatch(x, accum: int, i: int):
    """Rows ``[i * mb, (i + 1) * mb)`` of a batch leaf, ``mb = B //
    accum``: microbatch ``i`` of the reference's ``(accum, mb)`` reshape.

    A DTensor's batch dim is sharded, and DTensor has no rule for
    splitting a sharded dim into ``(accum, mb)``: the rows are sliced from
    the gathered leaf and sharded again as the batch was, or left
    replicated when ``mb`` does not divide over the batch axes.
    """
    mb = x.shape[0] // accum
    if not is_distributed(x):
        return x.reshape((accum, mb) + tuple(x.shape[1:]))[i]
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    part = full[i * mb:(i + 1) * mb]
    shards = 1
    for j, pl in enumerate(x.placements):
        if pl.is_shard(0):
            shards *= mesh.size(j)
    if mb % shards:
        return part
    return part.redistribute(mesh, x.placements)


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
    """Zero decode state on ``device`` (default the card); ``"meta"``
    gives the reference's abstract caches (shapes and dtypes only)."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in cache_shapes(cfg, batch, cache_len).items()}


def cache_axes(cfg: ArchConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes for each cache entry (KV seq sharded over ``model``)."""
    shapes = cache_shapes(cfg, 2, 4)
    out: Dict[str, Tuple[Optional[str], ...]] = {}
    for k, (shape, _) in shapes.items():
        if k in ("ssd", "conv", "wkv", "att_x", "ffn_x"):
            out[k] = (None, "batch") + (None,) * (len(shape) - 2)
        elif k.endswith("_scale"):
            out[k] = (None, "batch", None)
        else:
            out[k] = (None, "batch", "kv_seq", None, None)
    return out


# -------------------------------------------------------------- decode step

def decode_step(params, caches, token, cache_len: int, cfg: ArchConfig,
                enc=None):
    """One-token decode. token: (B, 1) int32; cache_len: the new token's
    position.  ``enc`` is unused (whisper's cross K/V are in the caches),
    as in the reference.

    Returns (logits (B, V) f32, caches): attention caches are the ones
    passed in, written in place at the new token's slot; SSM states
    (``wkv``, ``att_x``, ``ffn_x``, ``ssd``, ``conv``) are new tensors.
    """
    cache_len = int(cache_len)
    x = L.embed_tokens(_tensor(token, _device(params), torch.int32),
                       params["embed"], cfg)
    b = x.shape[0]
    posb = torch.full((b,), cache_len, dtype=torch.int32, device=x.device)
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        states = []
        for i in range(cfg.n_layers):
            x, st = rwkv_block(x, _layer(params["layers"], i), cfg,
                               prev=(caches["wkv"][i], caches["att_x"][i],
                                     caches["ffn_x"][i]))
            states.append(st)
        caches = {k: torch.stack([st[j] for st in states])
                  for j, k in enumerate(("wkv", "att_x", "ffn_x"))}
    elif cfg.family == "ssm" and cfg.ssm.kind == "mamba2":
        states = []
        for i in range(cfg.n_layers):
            x, st = _mamba_decode_block(x, _layer(params["layers"], i), cfg,
                                        caches["ssd"][i], caches["conv"][i])
            states.append(st)
        caches = {k: torch.stack([st[k] for st in states])
                  for k in ("ssd", "conv")}
    elif cfg.family == "hybrid":
        x, caches = _zamba_decode(params, caches, x, posb, cache_len, cfg)
    elif cfg.family == "audio":
        # absolute (sinusoidal) positions: add the row at position cache_len
        x = x + sinusoid_row(cache_len, cfg.d_model,
                             x.device)[None, None].to(x.dtype)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = L.norm(x, lp["ln1"], cfg)
            a, _, _ = L.attention_decode(h, lp["attn"], cfg,
                                         caches["self_k"][i],
                                         caches["self_v"][i], posb,
                                         cache_len)
            x = x + a
            h = L.norm(x, lp["ln2"], cfg)
            x = x + L.cross_attention_decode(h, lp["cross"], cfg,
                                             caches["cross_k"][i],
                                             caches["cross_v"][i])
            h = L.norm(x, lp["ln3"], cfg)
            x = x + L.mlp(h, lp["mlp"], cfg)
    else:
        x = _dense_decode(params, caches, x, posb, cache_len, cfg)
    x = L.norm(x, params["final_norm"], cfg)
    return L.lm_logits(x, params, cfg)[:, 0], caches


def _dense_decode(params, caches, x, posb, cache_len: int, cfg: ArchConfig):
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
    return x


def _zamba_decode(params, caches, x, posb, cache_len: int, cfg: ArchConfig):
    n_attn, per_group, grouped, n_mamba = _zamba_layout(cfg)
    mam, shared = params["layers"], params["shared_attn"]

    def mamba(x, j):
        x, st = _mamba_decode_block(x, _layer(mam, j), cfg,
                                    caches["ssd"][j], caches["conv"][j])
        states.append(st)
        return x

    states: List[Dict[str, torch.Tensor]] = []
    for g in range(n_attn):
        for j in range(g * per_group, (g + 1) * per_group):
            x = mamba(x, j)
        h = L.norm(x, shared["ln1"], cfg)
        a, _, _ = L.attention_decode(h, shared["attn"], cfg,
                                     caches["attn_k"][g],
                                     caches["attn_v"][g], posb, cache_len)
        x = _shared_tail(x, a, shared, cfg)
    for j in range(grouped, n_mamba):
        x = mamba(x, j)
    new = dict(caches)
    for k in ("ssd", "conv"):
        new[k] = torch.stack([st[k] for st in states])
    return x, new


# ------------------------------------------------------------- prefill step

def prefill_step(params, tokens, cfg: ArchConfig, *, frames=None,
                 patches=None, pos=None, impl="auto", schedule="dense"):
    """Full-sequence forward that also builds the decode state.

    Returns (last-position logits (B, V), caches covering the stream:
    a VLM's patches and then the S tokens).
    """
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        x = _embed_stream(params, tokens, cfg, None)
        states = []
        for i in range(cfg.n_layers):
            x, st = rwkv_block(x, _layer(params["layers"], i), cfg)
            states.append(st)
        caches = {k: torch.stack([st[j] for st in states])
                  for j, k in enumerate(("wkv", "att_x", "ffn_x"))}
    elif cfg.family == "ssm" and cfg.ssm.kind == "mamba2":
        x = _embed_stream(params, tokens, cfg, None)
        states = []
        for i in range(cfg.n_layers):
            x, st = _mamba_prefill_block(x, _layer(params["layers"], i), cfg)
            states.append(st)
        caches = {k: torch.stack([st[k] for st in states])
                  for k in ("ssd", "conv")}
    elif cfg.family == "audio":
        enc = whisper_encode(params, frames, cfg, impl, schedule)
        x, caches = _whisper_prefill_dec(params, tokens, enc, cfg, impl,
                                         schedule)
    elif cfg.family == "hybrid":
        x, caches = _zamba_prefill(params, tokens, cfg, pos, impl, schedule)
    else:
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
        o = L.attend_heads(lambda q, k, v: flash_attention(
            q, k, v, True, schedule, BLOCK, BLOCK, w, 10 ** 9, 0),
            q, kk, vv)
    else:
        o = L.attend_heads(lambda q, k, v: reference_attention(
            q, k, v, True, w, 10 ** 9, 0), q, kk, vv)
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


def _zamba_prefill(params, tokens, cfg, pos, impl, schedule):
    n_attn, per_group, grouped, n_mamba = _zamba_layout(cfg)
    x = _embed_stream(params, tokens, cfg, None)
    b, s, _ = x.shape
    pos_arr = _positions(pos, b, s, x.device)
    mam, shared = params["layers"], params["shared_attn"]
    states, ks, vs = [], [], []
    for g in range(n_attn):
        for j in range(g * per_group, (g + 1) * per_group):
            x, st = _mamba_prefill_block(x, _layer(mam, j), cfg)
            states.append(st)
        h = L.norm(x, shared["ln1"], cfg)
        a, kk, vv = _attn_with_cache(h, shared["attn"], cfg, pos_arr, 0,
                                     cfg.rope_theta, impl, schedule)
        x = _shared_tail(x, a, shared, cfg)
        ks.append(kk)
        vs.append(vv)
    for j in range(grouped, n_mamba):
        x, st = _mamba_prefill_block(x, _layer(mam, j), cfg)
        states.append(st)
    caches = {k: torch.stack([st[k] for st in states])
              for k in ("ssd", "conv")}
    # fewer layers than ``hybrid_attn_every``: no group, empty caches
    empty = torch.zeros((0, b, s, cfg.n_kv_heads, cfg.hd),
                        dtype=torch.bfloat16, device=x.device)
    caches["attn_k"] = torch.stack(ks) if ks else empty
    caches["attn_v"] = torch.stack(vs) if vs else empty
    return x, caches


def _whisper_prefill_dec(params, tokens, enc, cfg, impl, schedule):
    x, pos_arr = _whisper_dec_embed(params, tokens, cfg)
    es = enc.shape[1]
    enc_p = _pad_enc(enc, cfg)
    sk, sv, ck, cv = [], [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.norm(x, lp["ln1"], cfg)
        a, kk, vv = _attn_with_cache(h, lp["attn"], cfg, pos_arr, 0,
                                     cfg.rope_theta, impl, schedule)
        x = x + a
        h = L.norm(x, lp["ln2"], cfg)
        x = x + attention_full(h, lp["cross"], cfg, pos_arr, 0,
                               cfg.rope_theta, impl=impl, schedule=schedule,
                               kv_x=enc_p, kv_valid=es)
        ck.append(L._split_heads(L.dot(enc, lp["cross"]["wk"], cfg),
                                 cfg.n_kv_heads).to(torch.bfloat16))
        cv.append(L._split_heads(L.dot(enc, lp["cross"]["wv"], cfg),
                                 cfg.n_kv_heads).to(torch.bfloat16))
        h = L.norm(x, lp["ln3"], cfg)
        x = x + L.mlp(h, lp["mlp"], cfg)
        sk.append(kk)
        sv.append(vv)
    return x, {"self_k": torch.stack(sk), "self_v": torch.stack(sv),
               "cross_k": torch.stack(ck), "cross_v": torch.stack(cv)}
