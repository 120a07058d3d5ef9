"""``repro_torch.ged`` — the public GED API of the PyTorch/CUDA port.

The same facade as ``repro.ged`` (:class:`GedEngine` / :func:`compute` /
:func:`verify`, one :class:`GedOutcome` per pair) over the port's
backends: ``"auto"`` (the default: escalating engine rungs, then the host
solver; always certified), ``"exact"`` (the host solver), ``"cuda"``
(hand-written kernels) and ``"torch"`` (plain PyTorch).  Entry points run
on the card unless given ``device="cpu"``.

>>> from repro_torch import ged
>>> [o.ged for o in ged.compute([(([0], []), ([1], []))], device="cpu")]
[1.0]
"""

from repro_torch.ged.api import GedEngine, compute, verify
from repro_torch.ged.backends import (AutoBackend, ExactBackend,
                                      available_backends, make_backend,
                                      register_backend)
from repro_torch.ged.exec import Executor, PendingBatch, engine_outcome
from repro_torch.ged.plan import Plan, as_graph, build_plan, slot_bucket
from repro_torch.ged.results import GedOutcome
from repro_torch.kernels.autotune import KernelDispatch

__all__ = [
    "GedEngine",
    "GedOutcome",
    "compute",
    "verify",
    "register_backend",
    "available_backends",
    "make_backend",
    "AutoBackend",
    "ExactBackend",
    "as_graph",
    "build_plan",
    "slot_bucket",
    "Plan",
    "Executor",
    "PendingBatch",
    "engine_outcome",
    "KernelDispatch",
]
