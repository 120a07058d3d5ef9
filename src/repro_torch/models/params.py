"""Parameter specs: one declarative tree per architecture.

The reference's ``repro/models/params.py``, with the same tree for every
family (the specs are data): each leaf is a ``PSpec(shape, axes, init)``,
and layer stacks carry a leading ``L`` axis.  From it come

* :func:`param_count`, arithmetic only (a 72B tree in microseconds);
* :func:`init_params`, random weights drawn from an explicit
  ``torch.Generator`` on the target device.  They cannot match the
  reference's ``jax.random`` draws, and need not: the parity tests carry
  the reference's weights across with :func:`params_from_numpy`.

* :func:`abstract_params`, ``meta`` tensors of the leaves' shapes and
  dtype (the reference's ``ShapeDtypeStruct`` tree; nothing allocated);
* :func:`param_pspecs`, each leaf's spec under a ``ShardingRules`` table
  (FSDP over ``data`` via "embed", TP over ``model`` via "qkv_flat" /
  "ff" / "vocab" / "expert"; a dim its axes do not divide is replicated).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import mamba2_dims, rwkv6_dims
from repro_torch.parallel.sharding import ShardingRules, logical_spec

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"        # normal|zeros|ones|small|alog|dtbias|mix|wbase
    scale: float = 0.02


def _attn_specs(cfg: ArchConfig, d: int) -> Dict[str, PSpec]:
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out: Dict[str, PSpec] = {
        "wq": PSpec((d, hq * hd), ("embed", "qkv_flat")),
        "wk": PSpec((d, hk * hd), ("embed", "qkv_flat")),
        "wv": PSpec((d, hk * hd), ("embed", "qkv_flat")),
        "wo": PSpec((hq * hd, d), ("qkv_flat", "embed"), "small"),
    }
    if cfg.qkv_bias:
        out["bq"] = PSpec((hq * hd,), ("qkv_flat",), "zeros")
        out["bk"] = PSpec((hk * hd,), ("qkv_flat",), "zeros")
        out["bv"] = PSpec((hk * hd,), ("qkv_flat",), "zeros")
    if cfg.attn_out_bias:
        out["bo"] = PSpec((d,), (None,), "zeros")
    if cfg.qk_norm:
        out["q_norm"] = PSpec((hd,), (None,), "ones")
        out["k_norm"] = PSpec((hd,), (None,), "ones")
    return out


def _norm_specs(cfg: ArchConfig, d: int) -> Dict[str, PSpec]:
    plus_one = cfg.norm in ("rmsnorm1p", "layernorm1p")
    out = {"scale": PSpec((d,), (None,), "zeros" if plus_one else "ones")}
    if cfg.norm.startswith("layernorm"):
        out["bias"] = PSpec((d,), (None,), "zeros")
    return out


def _mlp_specs(cfg: ArchConfig, d: int, ff: int) -> Dict[str, PSpec]:
    out: Dict[str, PSpec] = {
        "wi": PSpec((d, ff), ("embed", "ff")),
        "wo": PSpec((ff, d), ("ff", "embed"), "small"),
    }
    if cfg.mlp == "swiglu":
        out["wg"] = PSpec((d, ff), ("embed", "ff"))
    if cfg.mlp_bias:
        out["bi"] = PSpec((ff,), ("ff",), "zeros")
        out["bo"] = PSpec((d,), (None,), "zeros")
    return out


def _moe_specs(cfg: ArchConfig) -> Dict[str, PSpec]:
    moe, d = cfg.moe, cfg.d_model
    e, ff = moe.total_experts, moe.expert_ff
    out: Dict[str, PSpec] = {
        "router": PSpec((d, e), ("embed", None)),
        "wg": PSpec((e, d, ff), ("expert", "embed", None)),
        "wi": PSpec((e, d, ff), ("expert", "embed", None)),
        "wo": PSpec((e, ff, d), ("expert", None, "embed"), "small"),
    }
    if moe.shared_experts:
        sf = moe.shared_ff or moe.shared_experts * ff
        out["shared_wg"] = PSpec((d, sf), ("embed", "ff"))
        out["shared_wi"] = PSpec((d, sf), ("embed", "ff"))
        out["shared_wo"] = PSpec((sf, d), ("ff", "embed"), "small")
    return out


def _mamba_specs(cfg: ArchConfig) -> Dict[str, PSpec]:
    dims = mamba2_dims(cfg)
    d, di, h = cfg.d_model, dims["d_inner"], dims["n_heads"]
    gn = dims["n_groups"] * dims["d_state"]
    return {
        "in_z": PSpec((d, di), ("embed", "ff")),
        "in_x": PSpec((d, di), ("embed", "ff")),
        "in_bc": PSpec((d, 2 * gn), ("embed", None)),
        "in_dt": PSpec((d, h), ("embed", None)),
        "conv_w": PSpec((cfg.ssm.d_conv, di), (None, "ff")),
        "conv_b": PSpec((di,), ("ff",), "zeros"),
        "dt_bias": PSpec((h,), (None,), "dtbias"),
        "a_log": PSpec((h,), (None,), "alog"),
        "d_skip": PSpec((h,), (None,), "ones"),
        "norm_scale": PSpec((di,), ("ff",), "ones"),
        "out_proj": PSpec((di, d), ("ff", "embed"), "small"),
    }


def _rwkv_specs(cfg: ArchConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    lora = 64
    out: Dict[str, PSpec] = {
        "wr": PSpec((d, d), ("embed", "qkv_flat")),
        "wk": PSpec((d, d), ("embed", "qkv_flat")),
        "wv": PSpec((d, d), ("embed", "qkv_flat")),
        "wg": PSpec((d, d), ("embed", "qkv_flat")),
        "wo": PSpec((d, d), ("qkv_flat", "embed"), "small"),
        "w_lora_a": PSpec((d, lora), ("embed", None)),
        "w_lora_b": PSpec((lora, d), (None, "embed")),
        "w_base": PSpec((d,), (None,), "wbase"),
        "u": PSpec((d,), (None,), "mix"),
        "ln_x_scale": PSpec((d,), (None,), "ones"),
        "ln_x_bias": PSpec((d,), (None,), "zeros"),
        "fk": PSpec((d, cfg.d_ff), ("embed", "ff")),
        "fv": PSpec((cfg.d_ff, d), ("ff", "embed"), "small"),
        "fr": PSpec((d, d), ("embed", "qkv_flat")),
    }
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w",
                 "mix_fk", "mix_fr"):
        out[name] = PSpec((d,), (None,), "mix")
    return out


def _layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Specs for ONE layer of the main stack."""
    d = cfg.d_model
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        return {"ln1": _norm_specs(cfg, d), "ln2": _norm_specs(cfg, d),
                "rwkv": _rwkv_specs(cfg)}
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is not None \
            and cfg.ssm.kind == "mamba2":
        return {"ln1": _norm_specs(cfg, d), "mamba": _mamba_specs(cfg)}
    body: Dict[str, Any] = {
        "ln1": _norm_specs(cfg, d), "ln2": _norm_specs(cfg, d),
        "attn": _attn_specs(cfg, d),
    }
    if cfg.moe is not None:
        body["moe"] = _moe_specs(cfg)
    else:
        body["mlp"] = _mlp_specs(cfg, d, cfg.d_ff)
    if cfg.sandwich_norm:
        body["ln1b"] = _norm_specs(cfg, d)
        body["ln2b"] = _norm_specs(cfg, d)
    return body


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in sorted-key order, the order JAX flattens dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in tree_leaves(tree[k]):
                yield (f"{k}/{path}" if path else k), leaf
    else:
        yield "", tree


def _stack(tree: Any, n: int) -> Any:
    return tree_map(lambda s: PSpec((n,) + s.shape, (None,) + s.axes,
                                    s.init, s.scale), tree)


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, Any] = {
        "embed": PSpec((v, d), ("vocab", "embed")),
        "final_norm": _norm_specs(cfg, d),
    }
    if not cfg.tied_embeddings:
        specs["lm_head"] = PSpec((d, v), ("embed", "vocab"))

    if cfg.family == "audio":
        # encoder stack (non-causal, layernorm) + decoder stack w/ cross-attn
        enc_layer = {
            "ln1": _norm_specs(cfg, d), "ln2": _norm_specs(cfg, d),
            "attn": _attn_specs(cfg, d),
            "mlp": _mlp_specs(cfg, d, cfg.d_ff),
        }
        specs["enc_layers"] = _stack(enc_layer, cfg.encdec.enc_layers)
        specs["enc_final_norm"] = _norm_specs(cfg, d)
        dec_layer = {
            "ln1": _norm_specs(cfg, d), "ln2": _norm_specs(cfg, d),
            "ln3": _norm_specs(cfg, d),
            "attn": _attn_specs(cfg, d),
            "cross": _attn_specs(cfg, d),
            "mlp": _mlp_specs(cfg, d, cfg.d_ff),
        }
        specs["layers"] = _stack(dec_layer, cfg.n_layers)
        return specs

    if cfg.family == "hybrid":
        # zamba2: n_mamba stacked mamba layers + ONE shared attn+mlp block
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        n_mamba = cfg.n_layers - n_attn
        specs["layers"] = _stack(_layer_specs(cfg), n_mamba)
        specs["shared_attn"] = {
            "ln1": _norm_specs(cfg, d), "ln2": _norm_specs(cfg, d),
            "attn": _attn_specs(cfg, d),
            "mlp": _mlp_specs(cfg, d, cfg.d_ff),
        }
        return specs

    specs["layers"] = _stack(_layer_specs(cfg), cfg.n_layers)
    return specs


def abstract_params(cfg: ArchConfig, dtype=None) -> Dict[str, Any]:
    """``meta`` tensors with every leaf's shape, in ``cfg.param_dtype``
    (or ``dtype``)."""
    dt = getattr(torch, cfg.param_dtype) if dtype is None else dtype
    return tree_map(lambda s: torch.empty(s.shape, dtype=dt, device="meta"),
                    param_specs(cfg))


def param_pspecs(cfg: ArchConfig, rules: ShardingRules) -> Dict[str, Any]:
    return tree_map(lambda s: logical_spec(s.shape, s.axes, rules),
                    param_specs(cfg))


def param_count(cfg: ArchConfig) -> int:
    return sum(int(np.prod(s.shape)) for _, s in tree_leaves(param_specs(cfg)))


def _init_leaf(s: PSpec, gen: torch.Generator, cfg: ArchConfig,
               device: torch.device) -> torch.Tensor:
    dt = getattr(torch, cfg.param_dtype)

    def uniform(lo, hi):
        u = torch.rand(s.shape, generator=gen, device=device,
                       dtype=torch.float32)
        return u.mul_(hi - lo).add_(lo)

    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=device)
    if s.init == "alog":       # mamba A in [1, 16]
        return torch.log(uniform(1.0, 16.0)).to(dt)
    if s.init == "dtbias":     # inverse softplus of dt in [1e-3, 0.1]
        return torch.log(torch.expm1(uniform(1e-3, 0.1))).to(dt)
    if s.init == "mix":
        return uniform(0.0, 1.0).to(dt)
    if s.init == "wbase":
        return torch.full(s.shape, -4.0, dtype=dt, device=device)
    scale = s.scale
    if s.init == "small":      # residual-out projections: 0.02/sqrt(2L)
        scale = s.scale / math.sqrt(max(2 * cfg.n_layers, 1))
    w = torch.randn(s.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dt)


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None
                ) -> Dict[str, Any]:
    """Random weights for ``cfg`` on ``device`` (default the card), drawn
    leaf by leaf in the specs' order from one generator seeded ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda s: _init_leaf(s, gen, cfg, dev), param_specs(cfg))


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Dict[str, Any]:
    """A parameter tree of arrays (the reference's params after
    ``jax.tree.map(np.asarray, params)``, or CPU tensors) as the port's:
    the same keys and the same stacked ``(L, ...)`` leaves, copied onto
    ``device`` (default the card) with their dtypes.  It takes the
    reference's AdamW state (``{"m", "v", "step"}``) the same way, so
    parity tests can start both packages from one ``(params, opt)``."""
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, copy=True)
        return torch.from_numpy(np.array(a)).to(dev)
    return tree_map(leaf, tree)
