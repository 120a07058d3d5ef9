"""qwen3-8b [dense] — 36L d4096 32H (GQA kv=8) ff12288 vocab 151936.

qk-norm, GQA, SwiGLU, RoPE(1e6), untied embeddings.
[hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    mlp="swiglu",
    norm="rmsnorm",
    train_accum=8,
)
