"""whisper-large-v3 [audio] — 32+32L d1280 20H ff5120 vocab 51866.

Encoder-decoder; the conv audio frontend is a STUB per the brief:
``input_specs()`` provides (B, 1500, 1280) precomputed frame embeddings.
Sinusoidal positions on both stacks (deviation: real Whisper uses learned
decoder positions capped at 448 — the 4k/32k decode shapes are synthetic
backbone stress, so the unbounded sinusoid is used instead; DESIGN.md §4).
Vocab padded 51866 -> 51872 for even 16-way TP.
[arXiv:2212.04356; unverified]
"""

from repro_torch.models.config import ArchConfig, EncDecCfg

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers; encoder in encdec
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    rope_pct=0.0,           # absolute (sinusoidal) positions, no rotary
    mlp="gelu",
    mlp_bias=True,
    attn_out_bias=True,
    norm="layernorm",
    encdec=EncDecCfg(enc_layers=32, enc_seq=1500),
    vocab_pad_to=32,
    train_accum=4,
)
