"""LM serving: prefill, then token-by-token greedy decode against KV caches.

The port of the reference's ``repro/serving/lm_decode.py`` for every
family of ``repro_torch.models.transformer``.  ``prefill_step`` builds
the decode state over the prompt's stream (an audio prompt's encoder runs
on ``frames`` there), :func:`_grow_caches` right-sizes the attention
caches for the tokens to come (the O(1) SSM states and whisper's cross
K/V keep their shapes), and each ``decode_step`` writes its token's row
in place.

A VLM prompt's stream is its ``num_patches`` patch embeddings and then
its S tokens.  Decoding starts at position ``num_patches + S``, and the
cache holds ``num_patches + S + max_new`` positions.  The reference sizes
the cache ``S + max_new`` and decodes from position S, which cuts the
prefilled stream and overwrites the patch region (``ROADMAP.md``, R3);
the port does not inherit that.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig


def greedy_sample(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V_padded) f32 -> (B, 1) int32, masking vocab padding.  Ties go
    to the first index, as ``jnp.argmax``'s do."""
    if logits.shape[-1] > vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
        logits = logits.masked_fill(pad[None], -float("inf"))
    return logits.argmax(-1).to(torch.int32)[:, None]


@torch.no_grad()
def generate(params, prompt, cfg: ArchConfig, max_new: int = 16,
             cache_len: Optional[int] = None, frames=None, patches=None,
             impl: str = "auto", device: DeviceLike = None) -> np.ndarray:
    """Greedy generation. prompt: (B, S) int32. Returns (B, max_new) int32.

    ``params`` must lie on ``device`` (default the card, which raises
    without a visible GPU).  ``frames`` (B, enc_seq, d) is the audio
    family's encoder input; ``patches`` a VLM's patch embeddings.
    """
    dev = resolve_device(device)
    have = T._device(params)
    if have.type != dev.type:
        raise ValueError(f"params lie on {have}, not on device={str(dev)!r}")
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=have)
    b, s = prompt.shape
    stream = s
    if cfg.vlm is not None and patches is not None:
        stream += patches.shape[1]
    total = cache_len or (stream + max_new)

    logits, caches = T.prefill_step(params, prompt, cfg, frames=frames,
                                    patches=patches, impl=impl)
    caches = _grow_caches(caches, cfg, b, stream, total)

    token = greedy_sample(logits, cfg.vocab)
    out = [token]
    for pos in range(stream, stream + max_new - 1):
        logits, caches = T.decode_step(params, caches, token, pos, cfg)
        token = greedy_sample(logits, cfg.vocab)
        out.append(token)
    return torch.cat(out, 1).cpu().numpy()


def _grow_caches(caches: Dict[str, torch.Tensor], cfg: ArchConfig, b: int,
                 s: int, total: int) -> Dict[str, torch.Tensor]:
    """Caches of ``cache_shapes(cfg, b, total)`` holding the prefilled
    ``[0, s)`` stream (an entry already at its size, such as a ring
    buffer, an SSM state or a cross cache, is kept)."""
    want = T.cache_shapes(cfg, b, total)
    out = {}
    for k, v in caches.items():
        shape, dt = want[k]
        if tuple(v.shape) == shape:
            out[k] = v.to(dt)
            continue
        buf = torch.zeros(shape, dtype=dt, device=v.device)
        # KV entries: (L, B, T, H, hd) — copy the prefilled slice
        sl = tuple(slice(0, min(a, b_)) for a, b_ in zip(v.shape, shape))
        buf[sl] = v[sl].to(dt)
        out[k] = buf
    return out
