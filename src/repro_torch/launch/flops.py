"""Analytic MODEL_FLOPS per (arch x shape) — the 6·N·D yardstick.

The reference's ``repro/launch/flops.py``, arithmetic over the same
``param_specs`` tree.  ``model_flops`` returns the *useful* flops of one
step under the standard accounting: 2·N_mm per token forward, x3 for
train (fwd+bwd), where N_mm is the matmul parameter count (embedding
table lookups excluded; MoE counts only the ``top_k`` routed experts +
shared experts — 6·N_active·D), plus attention score/value flops
(4·tokens·T_avg·Hq·hd) and SSM state-update flops, which 6·N·D alone would
miss at 32k+ contexts.

The ratio MODEL_FLOPS / counted FLOPs (both per device) exposes remat and
dispatch waste in the step (``launch/step_analysis.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import param_specs, tree_leaves
from repro_torch.models.ssm import mamba2_dims, rwkv6_dims


def _leaf_groups(cfg: ArchConfig) -> Dict[str, float]:
    """Matmul params split into {enc, dec, expert} groups."""
    groups = {"enc": 0.0, "dec": 0.0, "expert": 0.0}
    for name, spec in tree_leaves(param_specs(cfg)):
        if spec.shape and len(spec.shape) < 2:
            continue                       # norms, biases: negligible
        if name.startswith("embed"):
            continue                       # table lookup, not a matmul
        n = float(np.prod(spec.shape))
        if "expert" in spec.axes:
            groups["expert"] += n
        elif name.startswith("enc_layers"):
            groups["enc"] += n
        else:
            groups["dec"] += n
    return groups


def _attn_flops(cfg: ArchConfig, tokens: float, t_avg: float) -> float:
    """score + value matmuls: 2 x 2 x tokens x T x Hq x hd."""
    return 4.0 * tokens * t_avg * cfg.n_heads * cfg.hd


def _train_t_avg(cfg: ArchConfig, s: int) -> float:
    """Mean KV length per layer, respecting sliding windows."""
    windows = cfg.windows()
    total = 0.0
    for w in windows:
        total += min(w, s / 2) if w > 0 else s / 2
    return total / max(len(windows), 1)


def _ssm_state_flops(cfg: ArchConfig, tokens: float) -> float:
    if cfg.ssm is None:
        return 0.0
    if cfg.ssm.kind == "rwkv6":
        d = rwkv6_dims(cfg)
        # wkv state update + readout: ~4 ops per (head, p, p) cell per token
        return 4.0 * tokens * d["n_heads"] * d["head_dim"] ** 2 * _n_ssm(cfg)
    d = mamba2_dims(cfg)
    # SSD: state update (h,p,n) + readout per token
    return 4.0 * tokens * d["n_heads"] * d["head_dim"] * d["d_state"] \
        * _n_ssm(cfg)


def _n_ssm(cfg: ArchConfig) -> int:
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers - cfg.n_layers // cfg.hybrid_attn_every
    return 0


def _n_attn_layers(cfg: ArchConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def _expert_active(cfg: ArchConfig) -> float:
    """Active routed-expert matmul params (per token) across layers."""
    if cfg.moe is None:
        return 0.0
    m = cfg.moe
    mats = 3                               # wg, wi, wo
    return float(cfg.n_layers * mats * m.top_k * cfg.d_model * m.expert_ff)


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, float]:
    b, s = shape.global_batch, shape.seq_len
    g = _leaf_groups(cfg)
    n_dec = g["dec"] + _expert_active(cfg)
    if cfg.tied_embeddings:
        n_dec += cfg.d_model * cfg.padded_vocab      # logits matmul

    if shape.kind == "decode":
        tokens = float(b)                            # one new token per seq
        flops = 2.0 * n_dec * tokens
        flops += _attn_flops(cfg, tokens, _decode_t_avg(cfg, s)) \
            * _n_attn_layers(cfg)
        flops += _ssm_state_flops(cfg, tokens)
        n_active = n_dec
    else:
        stream = s                                   # vlm patches included
        tokens = float(b) * stream
        mult = 3.0 if shape.kind == "train" else 1.0
        flops = mult * 2.0 * n_dec * tokens
        flops += mult * _attn_flops(cfg, tokens, _train_t_avg(cfg, stream)) \
            * _n_attn_layers(cfg)
        flops += mult * _ssm_state_flops(cfg, tokens)
        if cfg.family == "audio":
            enc_tokens = float(b) * cfg.encdec.enc_seq
            flops += mult * 2.0 * g["enc"] * enc_tokens
            flops += mult * _attn_flops(cfg, enc_tokens,
                                        cfg.encdec.enc_seq / 2) \
                * cfg.encdec.enc_layers
            # decoder cross-attention reads the encoder sequence
            flops += mult * _attn_flops(cfg, tokens, cfg.encdec.enc_seq) \
                * cfg.n_layers
        n_active = n_dec + g["enc"]

    return {"model_flops": flops, "n_matmul_params": n_dec + g["enc"],
            "n_active_matmul_params": n_active, "tokens": tokens}


def _decode_t_avg(cfg: ArchConfig, cache: int) -> float:
    windows = cfg.windows()
    att = [w for w in windows]
    if cfg.family == "hybrid":
        att = [0] * _n_attn_layers(cfg)
    if not att:
        return 0.0
    total = 0.0
    for w in att:
        total += min(w, cache) if w > 0 else cache
    return total / len(att)
