"""Learning-rate schedules (step -> multiplier in [0, 1])."""

from __future__ import annotations

import math
from typing import Callable

import torch


def cosine_schedule(warmup: int, total_steps: int, min_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup then cosine decay to ``min_frac``.

    The returned function takes an integer step tensor and gives an f32
    tensor on its device, computed in f32 in the reference's order.
    """
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = step / max(warmup, 1)
        prog = (step - warmup) / max(total_steps - warmup, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = min_frac + (1.0 - min_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn
