"""qwen2-moe-a2.7b [moe] — 24L d2048 16H (kv=16) MoE 60e top-4 ff1408.

Qwen1.5-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts (shared ff =
4 x 1408 = 5632).  Experts padded 60 -> 64 for even EP-16 sharding; the 4
padded experts are masked out of the router (never win top-k) and FLOP
accounting uses 60.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoECfg(num_experts=60, top_k=4, expert_ff=1408,
               shared_experts=4, shared_ff=5632, padded_experts=64),
    train_accum=8,
)
