"""Device resolution for every entry point of the port.

Entry points take ``device=`` and default to the card.  Without a visible
GPU they raise instead of quietly running on the CPU; callers (the CPU
tests among them) pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must be visible.

    Resolving a CUDA device also switches TF32 off for matmuls and
    convolutions: the engine's histogram contractions must stay exact f32.
    It also switches off cuBLAS's reduced-precision reductions in bf16
    matmuls, so the LM layers accumulate in f32 as the reference's
    ``preferred_element_type=f32`` contractions do.

    >>> resolve_device("cpu")
    device(type='cpu')
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev

