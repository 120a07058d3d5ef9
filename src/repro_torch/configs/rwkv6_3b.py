"""rwkv6-3b [ssm] — 32L d2560 (attention-free) ff8960 vocab 65536.

Finch: token-shift, data-dependent per-channel decay (low-rank), bonus u,
chunked WKV6 for train/prefill, O(1) recurrent state for decode — the
canonical ``long_500k`` arch (state size is independent of context).
[arXiv:2404.05892; hf]
"""

from repro_torch.models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # informational: wkv heads = d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    head_dim=64,
    mlp="squared_relu",    # rwkv channel-mix uses relu^2
    norm="layernorm",
    ssm=SSMCfg(kind="rwkv6", head_dim=64, chunk=128),
    subquadratic=True,
    train_accum=8,
)
