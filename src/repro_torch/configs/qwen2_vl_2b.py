"""qwen2-vl-2b [vlm] — 28L d1536 12H (GQA kv=2) ff8960 vocab 151936.

M-RoPE (t/h/w 3-section rotary), dynamic resolution.  The vision frontend
is a STUB per the brief: ``input_specs()`` supplies 1024 precomputed patch
embeddings that are prepended to the text stream; the position input is the
(3, B, S) t/h/w stream driving M-RoPE.
[arXiv:2409.12191; hf]
"""

from repro_torch.models.config import ArchConfig, VLMCfg

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    mlp="swiglu",
    norm="rmsnorm",
    vlm=VLMCfg(num_patches=1024, mrope_sections=(16, 24, 24)),
    train_accum=4,
)
