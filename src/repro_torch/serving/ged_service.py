"""GED serving: pairwise verification and corpus similarity search.

The counterpart of ``repro/serving/ged_service.py``: the same two
services, arguments, store routing, deadline grouping and ``health()``
keys, over the port's ``repro_torch.ged`` facade.  Both take ``device=``
(default: the card; ``"cpu"`` runs on the CPU) and ``mesh=`` (a flat
device sequence, a named ``DeviceMesh`` or a ``torch.distributed`` one,
:class:`repro_torch.ged.ShardedExecutor`).

* :class:`GedVerificationService` — request/response wrapper for
  (q, g, tau) -> "is delta(q, g) <= tau?", certified, over
  ``GedEngine(backend="auto")`` (difficulty prediction, LPT straggler
  packing, the batched engine with the Hopper kernels under
  ``use_kernel=True``, escalation rungs, the host solver as the final
  rung).  Once a corpus is registered (:meth:`~GedVerificationService.
  register_corpus`), requests whose target graph lives in the corpus
  route through the :class:`~repro_torch.ged.GraphStore` filter
  pipeline: resident stage-0 bounds and the stage-1 engine pass decide
  most pairs before full verification runs.
* :class:`GedSimilarityService` — the corpus-search route: ingest a
  database once (or open a saved store directory, written by either
  package), then serve ``range_search`` / ``top_k`` / ``search``
  requests returning ranked :class:`~repro_torch.ged.SearchHit` lists.

Duplicate requests are answered by the engine's result cache
(tau-aware), so repeats cost a hash lookup, not a search.  ``GedResult``
aliases ``GedOutcome`` for readers of the old result type.

Both services sit behind an :class:`AdmissionController`: a bounded
pending-work budget that sheds excess load with
:class:`repro_torch.ged.Overloaded` (carrying a ``retry_after_s`` hint)
*before* any engine work runs, and a ``health()`` surface reporting queue
depth, shed count and p50/p99 request wall time.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.exact.graph import Graph
from repro_torch.device import DeviceLike
from repro_torch.ged import (GedEngine, GedOutcome, GraphStore, SearchHit,
                             as_graph)
from repro_torch.ged.exec import graph_digest
from repro_torch.ged.faults import Overloaded

GedResult = GedOutcome  # read-compatible alias (see module docstring)


@dataclasses.dataclass
class GedRequest:
    """One verification/compute request.  ``deadline_s`` caps this
    request's share of engine wall time (anytime contract: on expiry the
    outcome still carries admissible bounds, ``certified=False``)."""

    q: Graph
    g: Graph
    tau: float = 0.0
    deadline_s: Optional[float] = None


class AdmissionController:
    """Bounded admission for a serving endpoint.

    Tracks pairs currently being answered; a batch that would push the
    pending count past ``capacity`` is shed with :class:`Overloaded`
    *before* any engine work starts — except when the service is idle,
    where an oversized batch is admitted whole rather than being
    undeliverable at any load (capacity bounds *queueing*, not request
    size).  Completed requests feed a bounded window of wall times for
    the p50/p99 health quantiles; ``retry_after_s`` is estimated from
    the recent per-pair service time.

    >>> ac = AdmissionController(capacity=4)
    >>> with ac.admit(3): pass                    # 3 pairs, fits
    >>> with ac.admit(100): pass                  # oversized but idle: ok
    >>> ac.shed
    0
    """

    def __init__(self, capacity: int = 1024, window: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self.pending = 0
        self.shed = 0
        self.admitted = 0
        self._walls: Deque[float] = collections.deque(maxlen=int(window))
        self._pair_s = 0.0          # EWMA seconds per pair, for retry hint

    def admit(self, n_pairs: int):
        """Context manager guarding ``n_pairs`` of engine work; raises
        :class:`Overloaded` when the budget is exhausted."""
        return _Admission(self, max(int(n_pairs), 1))

    def _try_enter(self, n: int) -> None:
        with self._lock:
            if self.pending > 0 and self.pending + n > self.capacity:
                self.shed += 1
                retry = max(self._pair_s, 1e-3) * max(self.pending, 1)
                raise Overloaded(min(retry, 30.0), self.pending,
                                 self.capacity)
            self.pending += n
            self.admitted += 1

    def _leave(self, n: int, wall_s: float) -> None:
        with self._lock:
            self.pending = max(self.pending - n, 0)
            self._walls.append(wall_s)
            per_pair = wall_s / n
            self._pair_s = (per_pair if self._pair_s == 0.0
                            else 0.8 * self._pair_s + 0.2 * per_pair)

    def _quantile(self, q: float) -> float:
        walls = sorted(self._walls)
        if not walls:
            return 0.0
        return walls[min(int(q * len(walls)), len(walls) - 1)]

    @property
    def health(self) -> Dict[str, float]:
        with self._lock:
            return {
                "queue_depth": float(self.pending),
                "capacity": float(self.capacity),
                "shed": float(self.shed),
                "admitted": float(self.admitted),
                "p50_wall_s": self._quantile(0.50),
                "p99_wall_s": self._quantile(0.99),
            }


class _Admission:
    def __init__(self, controller: AdmissionController, n: int):
        self._c, self._n = controller, n

    def __enter__(self):
        self._c._try_enter(self._n)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._c._leave(self._n, time.monotonic() - self._t0)
        return False


@dataclasses.dataclass
class SearchRequest:
    """One corpus-similarity query: range search (``tau``) or ``k``-NN."""

    query: object                # anything ``ged.as_graph`` accepts
    tau: Optional[float] = None  # range search threshold
    k: Optional[int] = None      # top-k (exclusive with tau)


class GedVerificationService:
    """Request/response wrapper over the escalating ``auto`` engine.

    Rides the overlapped rung path by default; ``mesh=`` splits every
    rung's batches over several devices, ``overlap=False`` forces the
    sequential rung loop.  A ``torch.distributed`` mesh goes to the
    engine as it is: every rank builds the service and sends it the same
    requests, each searches its shard, and each returns every answer
    (:class:`~repro_torch.ged.GedEngine`'s ``mesh``).  A corpus registered
    on such a service is a :class:`~repro_torch.ged.GraphStore` over the
    same mesh, sharing the service's engine and executor, so every rank
    registers it at the same point (see the store's SPMD contract).
    ``device`` defaults to the card.  Example::

        svc = GedVerificationService(batch_size=128, use_kernel=True)
        outs = svc.verify([GedRequest(q, g, tau=4.0), ...])

    With a registered corpus, batch verification against known graphs
    goes through the store's staged filter first::

        svc.register_corpus(db_graphs)
        outs = svc.verify(reqs)     # in-corpus targets: filter-then-verify
    """

    def __init__(self, batch_size: int = 256, slots: int = 32,
                 strategy: str = "astar", bound: str = "hybrid",
                 use_kernel: bool = False, cache_size: int = 4096,
                 mesh=None, overlap: bool = True, capacity: int = 1024,
                 deadline_s: Optional[float] = None,
                 device: DeviceLike = None):
        self.engine = GedEngine(
            backend="auto", device=device, mesh=mesh, slots=slots,
            batch_size=batch_size, strategy=strategy, bound=bound,
            use_kernel=use_kernel, cache_size=cache_size, overlap=overlap,
            deadline_s=deadline_s)
        # exposed for tests/tuning: mutating ``scheduler.rungs`` reshapes
        # the escalation ladder of the underlying auto backend.
        self.scheduler = self.engine._backend.scheduler
        self.store: Optional[GraphStore] = None
        self.admission = AdmissionController(capacity=capacity)

    @property
    def stats(self) -> Dict[str, float]:
        """Pipeline counters plus executor / cache hit totals (and the
        registered store's ``store_*`` counters, once a corpus exists)."""
        out = dict(self.engine.stats)
        if self.store is not None:
            out.update({f"store_{k}": v for k, v in self.store.stats.items()
                        if not k.startswith("engine_")})
        return out

    def health(self) -> Dict[str, float]:
        """Liveness snapshot: admission queue depth / shed count, p50/p99
        request wall time, and the engine's robustness counters
        (``timed_out_pairs``, ``degraded_*``, retries).  The port never
        counts ``degraded_kernel`` (its ladder has no unfused step), so
        that key reads 0."""
        out = self.admission.health
        for k in ("timed_out_pairs", "degraded_host", "degraded_kernel",
                  "retries", "shared_cache_lock_timeouts"):
            out[k] = float(self.engine.stats.get(k, 0.0))
        return out

    # ------------------------------------------------------------ public

    def register_corpus(self, graphs=None, *, store_dir: Optional[str]
                        = None, **store_options) -> GraphStore:
        """Ingest a corpus; later batch verification against its members
        routes through the store's filter-verify pipeline.

        ``store_dir=`` warm-starts instead of ingesting: the persisted
        store (:meth:`repro_torch.ged.GraphStore.save`, or the
        reference's) is reopened with its own snapshot-recorded knobs —
        so ``store_options`` must stay empty — and ``graphs`` becomes the
        optional rebuild fallback for a corrupted snapshot.

        Either way the store shares this service's engine — and
        therefore its result cache, kernel build and executor (device and
        mesh included) — so ``store_options`` may only carry store-level
        knobs (``digest``, ``filter_iters``, ``filter_pool``, ``vocab``,
        ``index``); engine-level options raise.  Returns the store for
        direct ``range_search`` / ``top_k`` use.
        """
        if store_dir is not None:
            if store_options:
                raise TypeError(
                    f"store_dir= restores store options from the "
                    f"snapshot; got {sorted(store_options)}")
            self.store = GraphStore.open(store_dir, engine=self.engine,
                                         graphs=graphs)
            return self.store
        if graphs is None:
            raise TypeError("register_corpus needs graphs or store_dir=")
        self.store = GraphStore(graphs, engine=self.engine,
                                **store_options)
        return self.store

    def verify(self, requests: Sequence[GedRequest]) -> List[GedOutcome]:
        """Answer a batch of verification requests.

        Sheds the whole batch with :class:`repro_torch.ged.Overloaded`
        when the admission budget is exhausted (see :attr:`admission`).
        Requests carrying ``deadline_s`` take the direct engine path with
        the deadline propagated — the store's filter-verify route has no
        deadline support, so a deadline-carrying request trades the
        corpus filter's pruning for a hard latency cap.
        """
        with self.admission.admit(len(requests)):
            return self._verify_admitted(requests)

    def _verify_admitted(self, requests: Sequence[GedRequest]
                         ) -> List[GedOutcome]:
        results: List[Optional[GedOutcome]] = [None] * len(requests)
        # Deadline-carrying requests bypass store routing (see verify);
        # group them by budget so one engine call shares one Deadline.
        deadlines: Dict[float, List[int]] = {}
        rest: List[int] = []
        for i, r in enumerate(requests):
            if r.deadline_s is not None:
                deadlines.setdefault(float(r.deadline_s), []).append(i)
            else:
                rest.append(i)
        for budget, idxs in deadlines.items():
            outs = self.engine.verify(
                [(requests[i].q, requests[i].g) for i in idxs],
                [requests[i].tau for i in idxs], deadline_s=budget)
            for i, o in zip(idxs, outs):
                results[i] = o
        if rest and self.store is None:
            outs = self.engine.verify(
                [(requests[i].q, requests[i].g) for i in rest],
                [requests[i].tau for i in rest])
            for i, o in zip(rest, outs):
                results[i] = o
            return results  # type: ignore[return-value]
        # Route in-corpus targets through the staged filter; everything
        # else takes the plain engine path.  Matching and query grouping
        # are byte-exact (graph_digest): a merely-isomorphic rewrite must
        # not be answered with another graph's outcome or mapping.
        in_store: Dict[bytes, List[int]] = {}
        direct: List[int] = []
        member: Dict[int, int] = {}
        for i in rest:
            r = requests[i]
            gid = self.store.member_id(r.g)
            if gid is None:
                direct.append(i)
            else:
                member[i] = gid
                in_store.setdefault(graph_digest(as_graph(r.q)),
                                    []).append(i)
        for idxs in in_store.values():
            outs = self.store.verify_members(
                requests[idxs[0]].q, [member[i] for i in idxs],
                [requests[i].tau for i in idxs])
            for i, o in zip(idxs, outs):
                results[i] = o
        if direct:
            outs = self.engine.verify(
                [(requests[i].q, requests[i].g) for i in direct],
                [requests[i].tau for i in direct])
            for i, o in zip(direct, outs):
                results[i] = o
        return results  # type: ignore[return-value]

    def compute(self, pairs: Sequence[Tuple[Graph, Graph]],
                deadline_s: Optional[float] = None) -> List[GedOutcome]:
        with self.admission.admit(len(pairs)):
            return self.engine.compute(pairs, deadline_s=deadline_s)


class GedSimilarityService:
    """Corpus similarity search as a request/response service.

    A thin route over :class:`repro_torch.ged.GraphStore`: ingest the
    database at construction, then serve ranged and k-NN queries.
    ``index=`` configures the store's stage −1 candidate index
    (:class:`repro_torch.ged.CandidateIndex`): ``"auto"`` (default) builds
    a sound exact-mode index, a knob dict tunes it, ``None`` serves with
    the full-scan pipeline.  ``device`` (default: the card) and ``mesh``
    place the store; on a ``torch.distributed`` mesh every rank builds
    the service and sends it the same requests (the store's SPMD
    contract).  Example::

        svc = GedSimilarityService(db_graphs, index={"recall": 0.95})
        hits = svc.range_search(query, tau=4.0)
        answers = svc.search([SearchRequest(q1, tau=3.0),
                              SearchRequest(q2, k=10)])

    ``store_dir=`` warm-starts serving from a persisted store (written by
    either package) instead of re-ingesting — store-level knobs come from
    the snapshot, remaining keyword options configure the fresh engine,
    and ``graphs`` becomes the optional rebuild fallback for a corrupted
    snapshot::

        svc = GedSimilarityService(store_dir="/var/ged/corpus")
    """

    def __init__(self, graphs=None, *, store_dir: Optional[str] = None,
                 mesh=None, batch_size: int = 256, index="auto",
                 capacity: int = 256, device: DeviceLike = None,
                 **store_options):
        if store_dir is not None:
            self.store = GraphStore.open(
                store_dir, mesh=mesh, device=device, batch_size=batch_size,
                graphs=graphs, **store_options)
        elif graphs is not None:
            self.store = GraphStore(graphs, mesh=mesh, device=device,
                                    batch_size=batch_size, index=index,
                                    **store_options)
        else:
            raise TypeError(
                "GedSimilarityService needs graphs or store_dir=")
        # one admission unit per *query* (a query fans out to a corpus
        # scan, so pair-level accounting would always look oversized).
        self.admission = AdmissionController(capacity=capacity)

    @property
    def stats(self) -> Dict[str, float]:
        """The store's filter/verify counters."""
        return self.store.stats

    def health(self) -> Dict[str, float]:
        """Admission/latency snapshot (queue depth, shed, p50/p99 wall)
        plus the store's timed-out/degraded engine counters
        (``engine_degraded_kernel`` reads 0 in the port)."""
        out = self.admission.health
        stats = self.store.stats
        for k in ("engine_timed_out_pairs", "engine_degraded_host",
                  "engine_degraded_kernel", "engine_retries"):
            out[k] = float(stats.get(k, 0.0))
        return out

    def range_search(self, query, tau: float) -> List[SearchHit]:
        with self.admission.admit(1):
            return self.store.range_search(query, tau)

    def top_k(self, query, k: int) -> List[SearchHit]:
        with self.admission.admit(1):
            return self.store.top_k(query, k)

    def search(self, requests: Sequence[SearchRequest]
               ) -> List[List[SearchHit]]:
        """Answer a mixed batch of range / top-k requests, in order.

        The whole batch is admitted (or shed with
        :class:`repro_torch.ged.Overloaded`) as one unit of
        ``len(requests)`` queries."""
        for r in requests:          # validate before any work runs
            if (r.tau is None) == (r.k is None):
                raise ValueError(
                    "SearchRequest needs exactly one of tau= or k=")
        with self.admission.admit(len(requests)):
            out: List[List[SearchHit]] = []
            for qi, r in enumerate(requests):
                hits = (self.store.range_search(r.query, r.tau)
                        if r.tau is not None else
                        self.store.top_k(r.query, r.k))
                for h in hits:
                    h.query_id = qi
                out.append(hits)
            return out
