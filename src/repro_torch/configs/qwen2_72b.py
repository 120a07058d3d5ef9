"""qwen2-72b [dense] — 80L d8192 64H (GQA kv=8) ff29568 vocab 152064.

GQA, QKV bias, SwiGLU, RoPE(1e6).  The largest assigned arch: the dry-run
must show FSDP(data) x TP(model) fits 16 GB/chip with AdamW state.
[arXiv:2407.10671; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    mlp="swiglu",
    norm="rmsnorm",
    train_accum=16,
)
