"""Architecture configuration dataclasses (one instance per assigned arch).

A copy of the reference's ``repro/models/config.py``: the port imports
nothing of ``repro``, so it keeps its own plain dataclasses, field for
field the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    expert_ff: int
    shared_experts: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    padded_experts: int = 0  # experts padded for even EP sharding (0 = none)

    @property
    def total_experts(self) -> int:
        return self.padded_experts or self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    kind: str            # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int
    enc_seq: int          # fixed encoder length (whisper: 1500)


@dataclasses.dataclass(frozen=True)
class VLMCfg:
    num_patches: int      # patch embeddings prepended to the text stream
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 1e4
    rope_pct: float = 1.0
    window_pattern: Tuple[int, ...] = ()   # per-layer windows, 0 = global; cycled
    global_rope_theta: float = 0.0         # gemma3: different theta on globals
    # body details
    mlp: str = "swiglu"             # swiglu | squared_relu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm | rmsnorm1p
    sandwich_norm: bool = False
    tied_embeddings: bool = False
    embed_scale: bool = False       # gemma: x *= sqrt(d)
    mlp_bias: bool = False
    # submodules
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    encdec: Optional[EncDecCfg] = None
    vlm: Optional[VLMCfg] = None
    hybrid_attn_every: int = 0      # zamba2: shared attn block every k slots
    # training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"             # none | full
    train_accum: int = 8            # gradient-accumulation microbatches
    vocab_pad_to: int = 128
    # serving
    subquadratic: bool = False      # eligible for long_500k
    kv_quant: bool = False          # int8 KV cache (dense-family decode)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    def windows(self) -> Tuple[int, ...]:
        """Per-layer attention windows (0 = full/global)."""
        if not self.window_pattern:
            return (0,) * self.n_layers
        pat = self.window_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))


def reduced(cfg: ArchConfig, layers: int = 2, d_model: int = 64,
            vocab: int = 512, d_ff: int = 128, heads: int = 4,
            kv_heads: Optional[int] = None) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    kv = kv_heads if kv_heads is not None else min(cfg.n_kv_heads, heads)
    kwargs = dict(
        n_layers=layers, d_model=d_model, n_heads=heads, n_kv_heads=max(kv, 1),
        d_ff=d_ff, vocab=vocab, head_dim=d_model // heads,
    )
    if cfg.moe is not None:
        kwargs["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), expert_ff=32,
            shared_ff=32 if cfg.moe.shared_experts else 0, padded_experts=0,
        )
    if cfg.ssm is not None:
        kwargs["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=16,
        )
    if cfg.encdec is not None:
        kwargs["encdec"] = EncDecCfg(enc_layers=2, enc_seq=16)
    if cfg.vlm is not None:
        kwargs["vlm"] = VLMCfg(num_patches=8, mrope_sections=(4, 6, 6))
    if cfg.hybrid_attn_every:
        kwargs["hybrid_attn_every"] = 3
    if cfg.window_pattern:
        kwargs["window_pattern"] = (8, 8, 0)
    return dataclasses.replace(cfg, **kwargs)
