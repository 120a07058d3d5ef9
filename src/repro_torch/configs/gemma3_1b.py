"""gemma3-1b [dense] — 26L d1152 4H (MQA kv=1, hd=256) ff6912 vocab 262144.

5:1 local(512):global attention pattern, qk-norm, sandwich norms,
rmsnorm(+1), tied embeddings, embed scaling, global layers rope theta 1e6.
Sub-quadratic at 500k: local layers hold 512-slot ring buffers; only every
6th layer keeps a full-length KV cache.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1e4,
    global_rope_theta=1e6,
    window_pattern=(512, 512, 512, 512, 512, 0),
    mlp="gelu",
    norm="rmsnorm1p",
    sandwich_norm=True,
    tied_embeddings=True,
    embed_scale=True,
    subquadratic=True,
    train_accum=4,
)
