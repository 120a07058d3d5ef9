"""zamba2-7b [hybrid] — 81 slots d3584 32H kv32 ff14336 vocab 32000 state 64.

Mamba2 (SSD: headdim 64, state 64, expand 2) backbone with ONE weight-shared
full-attention+MLP block applied every 6th slot (zamba2's signature weight
reuse): 81 slots = 13 x (5 mamba + shared attn) + 3 mamba.  Sub-quadratic at
500k: mamba state is O(1); only the 13 shared-attn applications hold KV.
[arXiv:2411.15242; unverified]
"""

from repro_torch.models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    rope_theta=1e4,
    mlp="swiglu",
    norm="rmsnorm",
    ssm=SSMCfg(kind="mamba2", d_state=64, head_dim=64, expand=2),
    hybrid_attn_every=6,
    subquadratic=True,
    train_accum=8,
)
