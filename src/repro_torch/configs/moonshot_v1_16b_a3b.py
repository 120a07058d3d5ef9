"""moonshot-v1-16b-a3b [moe] — 48L d2048 16H (kv=16) MoE 64e top-6 ff1408.

kimi/moonlight family: 64 routed experts, top-6, expert ff 1408, vocab
163840.  The assignment spec lists no shared expert, so none is added
(DESIGN.md notes the deviation risk).  EP: experts shard over ``model``.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from repro_torch.models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    head_dim=128,
    rope_theta=5e4,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoECfg(num_experts=64, top_k=6, expert_ff=1408),
    train_accum=8,
)
