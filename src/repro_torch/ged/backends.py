"""Pluggable *policy* backends behind the ``repro_torch.ged`` facade.

Every backend implements ``run(plan, taus, verification, cfg) ->
List[GedOutcome]`` over the bucketed :class:`repro_torch.ged.plan.Plan`;
the executor (:mod:`repro_torch.ged.exec`) owns the device.

* ``"auto"``  — the default: difficulty prediction, LPT batch packing,
  escalation through growing engine rungs, host-solver final rung; every
  answer it returns is certified.  Rungs run *overlapped* (up to
  ``max_in_flight`` batches dispatched, decided pairs drained and
  survivors re-bucketed between rungs, host-solver pairs solved while a
  batch is in flight); ``overlap=False`` is the sequential rung loop.
  It honours ``cfg.use_kernel`` (``"auto"`` included) on its rungs.
* ``"exact"`` — the paper-faithful host solver (AStar+/DFS+ with BMa), one
  pair at a time; always certified.
* ``"torch"`` — the batched engine in plain PyTorch
  (``use_kernel=False``); the reference's ``"jax"``.
* ``"cuda"``  — the same engine with the hand-written CUDA kernels on the
  hot path (``use_kernel=True``); the reference's ``"pallas"``.  On a CPU
  device the kernel wrappers use their plain twins.

The reference's ``"sharded"`` backend is still to port (``ROADMAP.md``,
queue 1).  A failed dispatch raises: the reference's degradation to the
host solver comes with the faults slice, and never hides a failed kernel
behind its plain twin.  New backends register with
:func:`register_backend`.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Protocol

import numpy as np

from repro_torch.core.engine.search import EngineConfig
from repro_torch.core.exact.search import ged as exact_ged
from repro_torch.core.exact.search import ged_verify
from repro_torch.ged.exec import Executor, PendingBatch, engine_outcome
from repro_torch.ged.plan import Bucket, Plan
from repro_torch.ged.results import GedOutcome
from repro_torch.runtime.scheduler import Batch, GedScheduler, difficulty


class Backend(Protocol):
    """What the facade requires of an execution-policy backend."""

    name: str
    # What ``EngineConfig.use_kernel`` must be for this backend; ``None``
    # means the backend honors whatever the config says.
    kernel_default: Optional[bool]

    def run(self, plan: Plan, taus: np.ndarray, verification: bool,
            cfg: EngineConfig) -> List[GedOutcome]:
        """Answer every pair in ``plan`` (in order); ``taus`` is aligned
        with ``plan.pairs`` (zeros in computation mode)."""
        ...


# ----------------------------------------------------------- host solver

def _host_compute_outcome(res, backend: str, wall_s: float,
                          rung: int = 0) -> GedOutcome:
    ged = float(res.ged)
    return GedOutcome(ged=ged, similar=None, certified=True,
                      lower_bound=ged, upper_bound=ged,
                      mapping=res.best_mapping, backend=backend,
                      wall_s=wall_s, stats={"rung": rung,
                                            "expanded": res.stats.expanded})


def _host_verify_outcome(res, tau: float, backend: str, wall_s: float,
                         rung: int = 0) -> GedOutcome:
    similar = bool(res.similar)
    return GedOutcome(
        ged=None, similar=similar, certified=True,
        lower_bound=0.0 if similar else float(np.nextafter(tau, np.inf)),
        upper_bound=float(res.upper_bound) if similar else float("inf"),
        mapping=res.best_mapping if similar else None,
        backend=backend, wall_s=wall_s, tau=tau,
        stats={"rung": rung, "expanded": res.stats.expanded})


def host_solve(q, g, tau: Optional[float], verification: bool,
               cfg: EngineConfig, backend: str, rung: int) -> GedOutcome:
    """One pair through the host solver (AStar+/DFS+ with BMa): certified."""
    t0 = time.perf_counter()
    if verification:
        res = ged_verify(q, g, float(tau), bound="BMa", strategy=cfg.strategy)
        return _host_verify_outcome(res, float(tau), backend,
                                    time.perf_counter() - t0, rung=rung)
    res = exact_ged(q, g, bound="BMa", strategy=cfg.strategy)
    return _host_compute_outcome(res, backend, time.perf_counter() - t0,
                                 rung=rung)


class ExactBackend:
    """Paper-faithful host solver: always certified, yields mappings.

    >>> from repro_torch.ged.plan import build_plan
    >>> plan = build_plan([(([0], []), ([1], []))])   # 1-vertex relabel
    >>> out, = ExactBackend().run(plan, np.zeros(1, np.float32), False,
    ...                           EngineConfig())
    >>> out.ged, out.certified
    (1.0, True)
    """

    name = "exact"
    kernel_default = None  # host solver: kernels irrelevant
    batch_multiple = 1     # host solver: no device batch shape to satisfy

    def run(self, plan: Plan, taus: np.ndarray, verification: bool,
            cfg: EngineConfig) -> List[GedOutcome]:
        return [host_solve(q, g, float(taus[i]) if verification else None,
                           verification, cfg, self.name, 0)
                for i, (q, g) in enumerate(plan.pairs)]


# --------------------------------------------------------- batched engine

class EngineBackend:
    """Bucket-at-a-time policy over an :class:`~repro_torch.ged.exec.Executor`.

    ``cfg.use_kernel`` is taken as-is — ``GedEngine`` defaults it per
    backend name and rejects contradictions.
    """

    name = "torch"
    kernel_default = False

    def __init__(self, device=None, executor: Optional[Executor] = None):
        self.executor = executor or Executor(device)

    @property
    def batch_multiple(self) -> int:
        return self.executor.batch_multiple

    def run(self, plan: Plan, taus: np.ndarray, verification: bool,
            cfg: EngineConfig) -> List[GedOutcome]:
        results: List[Optional[GedOutcome]] = [None] * len(plan.pairs)
        for bucket in plan.buckets:
            t0 = time.perf_counter()
            out = self.executor.run_bucket(bucket, taus, cfg, verification)
            wall = time.perf_counter() - t0
            for bi, gi in enumerate(bucket.indices):
                results[gi] = engine_outcome(
                    out, bucket.packed, bi, verification,
                    float(taus[gi]) if verification else None,
                    self.name, wall, rung=0)
        return results  # type: ignore[return-value]


class CudaBackend(EngineBackend):
    """Engine policy with the CUDA kernels on the hot path; same outcomes
    as ``"torch"``."""

    name = "cuda"
    kernel_default = True


# ------------------------------------------------------------ escalation

@dataclasses.dataclass
class _InFlight:
    """One dispatched rung bucket awaiting its device results."""
    bucket: Bucket
    rung: int
    pending: PendingBatch
    t_dispatch: float


class AutoBackend:
    """Difficulty-scheduled escalation: engine rungs, then the host solver.

    Predict per-pair difficulty, LPT-pack equalised batches, run the
    batched engine, and re-queue uncertified pairs through bigger-pool
    rungs (``scheduler.rungs``) down to the exact host solver, so every
    answer is certified.  With ``overlap=True`` up to ``max_in_flight``
    rung buckets are dispatched at once; the oldest is drained (decided
    pairs become outcomes, survivors are re-bucketed with
    :meth:`~repro_torch.ged.plan.Plan.subset_buckets` for the next rung)
    while host-solver pairs run whenever it is not ready yet.
    ``overlap=False`` drains each batch as soon as it is dispatched.
    Outcomes are identical either way.

    ``stats``: ``pairs``, ``escalated``, ``host_solved``, ``batches``,
    ``dispatches``, ``overlap_saved_s`` (host seconds a batch spent in
    flight outside any blocking drain) and ``survivors_rung_{k}``.  The
    search loop reads its termination flag every iteration, so on the card
    a batch has finished when its dispatch returns and ``overlap_saved_s``
    stays near 0.

    >>> from repro_torch.ged.plan import build_plan
    >>> auto = AutoBackend(device="cpu")
    >>> out, = auto.run(build_plan([(([0, 1], [(0, 1, 1)]),
    ...                              ([0, 2], [(0, 1, 1)]))]),
    ...                 np.zeros(1, np.float32), False, EngineConfig())
    >>> out.ged, out.certified, out.backend, auto.stats["dispatches"]
    (1.0, True, 'auto', 1)
    """

    name = "auto"
    kernel_default = None  # honors cfg.use_kernel on the engine rungs

    def __init__(self, batch_size: int = 256, device=None,
                 executor: Optional[Executor] = None, overlap: bool = True,
                 max_in_flight: int = 4):
        self.scheduler = GedScheduler(batch_size)
        self.executor = executor or Executor(device)
        self.overlap = bool(overlap)
        self.max_in_flight = max(1, int(max_in_flight))
        self.stats: Dict[str, float] = {"pairs": 0, "escalated": 0,
                                        "host_solved": 0, "batches": 0,
                                        "dispatches": 0,
                                        "overlap_saved_s": 0.0}

    @property
    def batch_multiple(self) -> int:
        return self.executor.batch_multiple

    def run(self, plan: Plan, taus: np.ndarray, verification: bool,
            cfg: EngineConfig) -> List[GedOutcome]:
        results: List[Optional[GedOutcome]] = [None] * len(plan.pairs)
        diffs = [difficulty(q.n, g.n, q.m, g.m, q.vlabels, g.vlabels,
                            tau=float(taus[i]) if verification else None)
                 for i, (q, g) in enumerate(plan.pairs)]
        queue = self.scheduler.pack(diffs, rung=0)
        self.stats["pairs"] += len(plan.pairs)
        host_queue: List[int] = []          # pairs awaiting the final rung
        dispatchable: "collections.deque" = collections.deque()  # (bucket, rung)
        inflight: "collections.deque[_InFlight]" = collections.deque()
        last_block_end: Optional[float] = None  # end of last blocking drain

        def solve_host(gi: int) -> None:
            q, g = plan.pairs[gi]
            self.stats["host_solved"] += 1
            results[gi] = host_solve(
                q, g, float(taus[gi]) if verification else None,
                verification, cfg, f"{self.name}/exact", -1)

        def refill() -> None:
            # scheduler batches -> dispatchable rung buckets, regrouped by
            # slot bucket, so max_in_flight counts what reaches the device
            while not dispatchable and queue:
                batch = queue.pop(0)
                self.stats["batches"] += 1
                if self.scheduler.engine_params(batch.rung) is None:
                    host_queue.extend(batch.indices)
                    continue
                for bucket in plan.subset_buckets(batch.indices,
                                                  self.executor.pack):
                    dispatchable.append((bucket, batch.rung))

        def dispatch(bucket: Bucket, rung: int) -> None:
            pool, expand, max_iters = self.scheduler.engine_params(rung)
            rcfg = dataclasses.replace(cfg, pool=pool, expand=expand,
                                       max_iters=max_iters)
            self.stats["dispatches"] += 1
            item = _InFlight(bucket, rung, self.executor.run_bucket_async(
                bucket, taus, rcfg, verification), time.perf_counter())
            if self.overlap:
                inflight.append(item)
            else:
                drain(item)             # sequential baseline: block now

        def drain(item: _InFlight) -> None:
            nonlocal last_block_end
            t_drain = time.perf_counter()
            out = item.pending.result()     # blocks until the batch lands
            now = time.perf_counter()
            # per-batch wall: a pair's wall_s is the cost of its batch
            wall = now - item.t_dispatch
            # overlap credit: time in flight while not blocked in another
            # drain, windows clipped at the previous blocking call
            start = item.t_dispatch if last_block_end is None \
                else max(item.t_dispatch, last_block_end)
            self.stats["overlap_saved_s"] += max(0.0, t_drain - start)
            last_block_end = now
            survivors = []
            for bi, gi in enumerate(item.bucket.indices):
                if bool(out["exact"][bi]):
                    results[gi] = engine_outcome(
                        out, item.bucket.packed, bi, verification,
                        float(taus[gi]) if verification else None,
                        self.name, wall, rung=item.rung)
                else:
                    survivors.append(bi)
            skey = f"survivors_rung_{item.rung}"
            self.stats[skey] = self.stats.get(skey, 0) + len(survivors)
            if survivors:
                self.stats["escalated"] += len(survivors)
                nxt = self.scheduler.escalate(
                    Batch(list(item.bucket.indices), 0.0, item.rung),
                    survivors)
                if nxt is not None:
                    queue.append(nxt)

        while queue or dispatchable or inflight or host_queue:
            refill()
            # keep the device fed: dispatch while there's work and room
            while dispatchable and len(inflight) < self.max_in_flight:
                dispatch(*dispatchable.popleft())
                refill()
            if inflight:
                # host-solve while the oldest batch is in flight
                while host_queue and not inflight[0].pending.ready():
                    solve_host(host_queue.pop(0))
                drain(inflight.popleft())
            elif host_queue:
                solve_host(host_queue.pop(0))
        return results  # type: ignore[return-value]


# -------------------------------------------------------------- registry

_REGISTRY: Dict[str, Callable[..., Backend]] = {}

# reference backends this port does not have yet
_NOT_PORTED = ("sharded",)


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    """Make ``GedEngine(backend=name)`` constructible; ``factory`` receives
    the keyword options its signature names."""
    _REGISTRY[name] = factory


def available_backends() -> tuple:
    """Sorted names ``GedEngine(backend=...)`` accepts right now.

    >>> available_backends()
    ('auto', 'cuda', 'exact', 'torch')
    """
    return tuple(sorted(_REGISTRY))


def make_backend(name: str, **options) -> Backend:
    """Construct a registered backend, dropping options it doesn't take.

    >>> make_backend("torch", device="cpu", unused=1).name
    'torch'
    """
    if name in _NOT_PORTED and name not in _REGISTRY:
        raise ValueError(
            f"backend {name!r} is not ported yet (see ROADMAP.md, queue 1); "
            f"available: {available_backends()}")
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None
    import inspect
    params = inspect.signature(factory).parameters
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
        options = {k: v for k, v in options.items() if k in params}
    return factory(**options)


register_backend("auto", AutoBackend)
register_backend("exact", ExactBackend)
register_backend("torch", EngineBackend)
register_backend("cuda", CudaBackend)
