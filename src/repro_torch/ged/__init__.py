"""``repro_torch.ged`` — the public GED API of the PyTorch/CUDA port.

The same facade as ``repro.ged`` (:class:`GedEngine` / :func:`compute` /
:func:`verify`, one :class:`GedOutcome` per pair) over the port's
backends: ``"auto"`` (the default: escalating engine rungs, then the host
solver; always certified), ``"exact"`` (the host solver), ``"cuda"``
(hand-written kernels), ``"torch"`` (plain PyTorch) and ``"sharded"``
(the plain engine with every batch split over the devices of ``mesh``,
flat or a named ``DeviceMesh``, :class:`ShardedExecutor`; ``"auto"``
takes ``mesh=`` too).
Entry points run on the card unless given ``device="cpu"``.  In front of every backend sits
the result cache (:class:`ResultCache`, keyed on :func:`graph_digest` or
:func:`wl_digest` pair digests, with an optional cross-process tier on
disk), and :meth:`GedEngine.submit` / :meth:`GedEngine.flush` stream
pairs through one engine.  ``deadline_s`` (:class:`Deadline`) makes a call
anytime, ``fault_inject`` (:class:`FaultInjector`) and ``retry``
(:class:`RetryPolicy`) drive the degradation ladder.

Corpus-scale similarity search goes through the same door:
:class:`GraphStore` ingests a graph database once (shared label vocab,
stage-0 feature arrays resident on the device, canonical-digest dedup, a
sublinear :class:`CandidateIndex` over :func:`wl_signature` sketches
(:class:`SketchSpec`, built on the device by :func:`batch_signatures`,
admissible by :func:`sketch_damage`) plus pivot pruning) and answers
``range_search`` / ``top_k`` / ``search_batch`` / ``verify_members``
through a staged filter-verify pipeline whose stage-1 engine pass and
stage-2 verification run the Hopper kernels, returning ranked
:class:`SearchHit` results.  ``GraphStore.save`` / ``GraphStore.open``
persist it in the reference's on-disk format, so a store directory is
read by either package.

>>> from repro_torch import ged
>>> [o.ged for o in ged.compute([(([0], []), ([1], []))], device="cpu")]
[1.0]
"""

from repro_torch.ged.api import GedEngine, compute, verify
from repro_torch.ged.backends import (AutoBackend, ExactBackend,
                                      available_backends, make_backend,
                                      register_backend)
from repro_torch.ged.exec import (Executor, PendingBatch, ResultCache,
                                  ShardedExecutor, SketchSpec,
                                  batch_signatures, engine_outcome,
                                  graph_digest, wl_digest, wl_signature)
from repro_torch.ged.faults import (Deadline, FaultInjector, InjectedFault,
                                    Overloaded, RetryPolicy)
from repro_torch.ged.index import CandidateIndex, sketch_damage
from repro_torch.ged.plan import Plan, as_graph, build_plan, slot_bucket
from repro_torch.ged.results import GedOutcome, SearchHit
from repro_torch.ged.store import GraphStore
from repro_torch.kernels.autotune import KernelDispatch

__all__ = [
    "GedEngine",
    "GedOutcome",
    "GraphStore",
    "CandidateIndex",
    "SearchHit",
    "SketchSpec",
    "sketch_damage",
    "wl_signature",
    "batch_signatures",
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
    "ShardedExecutor",
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
