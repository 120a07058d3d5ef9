"""Batched engine entry point: the raw compute step under ``repro_torch.ged``.

Pairs are data-parallel: one batch is one ``(pairs, P, ...)`` search on
one device (see :mod:`repro_torch.core.engine.search`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine.search import EngineConfig, run_batch
from repro_torch.core.engine.tensor_graphs import GraphPairTensors, to_device
from repro_torch.device import DeviceLike, resolve_device


def dispatch_packed(packed: GraphPairTensors, taus, cfg: EngineConfig,
                    verification: bool, *, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Run one engine invocation over a packed batch on ``device``.

    Returns the reference's ``_run_batch`` dict (``ged``/``similar``,
    ``exact``, ``lower_bound``, ``upper_bound``, ``iterations``,
    ``expanded``, ``best_img``, ``floor``) as tensors on that device; CUDA
    work may still be in flight when it returns.  ``device`` defaults to
    the card and must be given as ``"cpu"`` to run on the CPU.
    """
    dev = resolve_device(device)
    pairs = to_device(packed, dev)
    taus_t = torch.as_tensor(np.asarray(taus, dtype=np.float32), device=dev)
    return run_batch(pairs, taus_t, cfg, bool(verification))
