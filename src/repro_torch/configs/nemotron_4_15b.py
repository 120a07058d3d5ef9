"""nemotron-4-15b [dense] — 32L d6144 48H (GQA kv=8) ff24576 vocab 256000.

GQA, squared-ReLU (non-gated) MLP, LayerNorm1p, partial RoPE (50%).
[arXiv:2402.16819; unverified]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    rope_theta=1e4,
    rope_pct=0.5,
    mlp="squared_relu",
    norm="layernorm1p",
    train_accum=8,
)
