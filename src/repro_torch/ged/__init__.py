"""``repro_torch.ged`` — the public GED API of the PyTorch/CUDA port.

The same facade as ``repro.ged`` (:class:`GedEngine` / :func:`compute` /
:func:`verify`, one :class:`GedOutcome` per pair) over the port's
backends: ``"auto"`` (the default: escalating engine rungs, then the host
solver; always certified), ``"exact"`` (the host solver), ``"cuda"``
(hand-written kernels) and ``"torch"`` (plain PyTorch).  Entry points run
on the card unless given ``device="cpu"``.  In front of every backend sits
the result cache (:class:`ResultCache`, keyed on :func:`graph_digest` or
:func:`wl_digest` pair digests, with an optional cross-process tier on
disk), and :meth:`GedEngine.submit` / :meth:`GedEngine.flush` stream
pairs through one engine.  ``deadline_s`` (:class:`Deadline`) makes a call
anytime, ``fault_inject`` (:class:`FaultInjector`) and ``retry``
(:class:`RetryPolicy`) drive the degradation ladder.

>>> from repro_torch import ged
>>> [o.ged for o in ged.compute([(([0], []), ([1], []))], device="cpu")]
[1.0]
"""

from repro_torch.ged.api import GedEngine, compute, verify
from repro_torch.ged.backends import (AutoBackend, ExactBackend,
                                      available_backends, make_backend,
                                      register_backend)
from repro_torch.ged.exec import (Executor, PendingBatch, ResultCache,
                                  engine_outcome, graph_digest, wl_digest)
from repro_torch.ged.faults import (Deadline, FaultInjector, InjectedFault,
                                    Overloaded, RetryPolicy)
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
    "ResultCache",
    "graph_digest",
    "wl_digest",
    "Deadline",
    "RetryPolicy",
    "FaultInjector",
    "InjectedFault",
    "Overloaded",
]
