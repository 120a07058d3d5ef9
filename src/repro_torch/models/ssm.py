"""State-space mixer dimensions (Mamba2, RWKV6).

Only the shape arithmetic that ``params.param_specs`` and
``transformer.cache_shapes`` need.  The mixers' bodies (chunked SSD and
WKV6, their recurrent decode) come with the SSM slice (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ArchConfig


def mamba2_dims(cfg: ArchConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return dict(d_inner=d_inner, n_heads=n_heads, d_state=s.d_state,
                head_dim=s.head_dim, n_groups=s.n_groups, d_conv=s.d_conv)


def rwkv6_dims(cfg: ArchConfig) -> Dict[str, int]:
    hd = cfg.ssm.head_dim
    return dict(n_heads=cfg.d_model // hd, head_dim=hd)
