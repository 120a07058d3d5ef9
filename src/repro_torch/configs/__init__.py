"""Registry of assigned architectures (``--arch <id>``).

Copies of the reference's ten arch files, so ``--arch`` has the
reference's choices.  The LM serving path runs the ``dense`` and ``vlm``
families (qwen3-8b, nemotron-4-15b, gemma3-1b, qwen2-72b, qwen2-vl-2b);
the other five are configs only until their slices land (``ROADMAP.md``).
"""

from typing import Dict, List

from repro_torch.models.config import ArchConfig

from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen2_moe_a27b import CONFIG as _qwen2_moe
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (
        _qwen3_8b, _nemotron, _gemma3, _qwen2_72b, _qwen2_vl,
        _moonshot, _qwen2_moe, _rwkv6, _whisper, _zamba2,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)
