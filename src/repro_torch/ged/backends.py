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
* ``"sharded"`` — the ``"torch"`` policy on a
  :class:`~repro_torch.ged.exec.ShardedExecutor`: every batch split over
  the devices of a flat ``mesh``; the same outcomes as ``"torch"``.
  ``"auto"`` given a ``mesh`` runs its rungs on one too.  On a
  ``torch.distributed`` mesh the ranks agree on every decision that
  reads a clock or ``ready()`` (:meth:`Executor.agree`) and take the
  first rank's host solves (:func:`agreed_host_solve`), so each returns
  the same outcomes.

Backends take an optional ``ctx``
(:class:`repro_torch.ged.faults.RunContext`): the deadline (a pair the
budget never reached answers uncertified with admissible bounds,
``timed_out``), the fault injector and the retry policy.  A bucket whose
dispatch fails permanently degrades to the host solver
(``degraded_host``); a failed host solve answers from the admissible
floor.  On the card only injected faults degrade
(:func:`repro_torch.ged.faults.degradable`): a real kernel or CUDA failure
is raised.  Nothing swaps a failed kernel for its plain twin.  New backends
register with :func:`register_backend`.
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
from repro_torch.ged import faults
from repro_torch.ged.exec import (Executor, PendingBatch, ShardedExecutor,
                                  engine_outcome)
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
        with ``plan.pairs`` (zeros in computation mode).

        A backend may also take ``ctx`` (keyword,
        :class:`repro_torch.ged.faults.RunContext`) to honour deadlines
        and the fault machinery; the facade passes it only when the
        signature names it."""
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
               cfg: EngineConfig, backend: str, rung: int,
               ctx: Optional[faults.RunContext] = None) -> GedOutcome:
    """One pair through the host solver (AStar+/DFS+ with BMa), under the
    robustness context; the reference's ``_robust_host_solve``.

    ``ctx=None`` runs without a deadline: certified unless a ``host``
    fault is injected process-wide.  With a context the pair runs
    under :meth:`RunContext.pair_deadline` (checked inside the search
    loop), and a timed-out search becomes a sound uncertified best-so-far
    outcome.  The ``host`` fault site simulates a solver failure, which —
    the host solver being the ladder's last step — degrades to the cheap
    admissible floor.
    """
    t0 = time.perf_counter()
    inj = faults.get_injector(ctx)
    if inj is not None:
        try:
            inj.check("host", rung)
        except Exception:
            if ctx is not None:
                ctx.bump("fault_host")
            faults.warn_once(
                "host-fault",
                "host solver failed (injected or real); answering from "
                "the cheap admissible floor, uncertified")
            out = faults.fallback_outcome(
                q, g, verification, tau, backend, timed_out=False,
                stats={"rung": rung, "degraded": True})
            out.wall_s = time.perf_counter() - t0
            return out
    deadline = None
    if ctx is not None and (ctx.has_deadline
                            or ctx.per_pair_deadline_s is not None):
        deadline = ctx.pair_deadline()
    if verification:
        res = ged_verify(q, g, float(tau), bound="BMa",
                         strategy=cfg.strategy, deadline=deadline)
    else:
        res = exact_ged(q, g, bound="BMa", strategy=cfg.strategy,
                        deadline=deadline)
    wall = time.perf_counter() - t0
    if getattr(res, "timed_out", False):
        if ctx is not None:
            ctx.bump("timed_out_pairs")
        out = faults.fallback_outcome(
            q, g, verification, tau, backend,
            lower_bound=res.lower_bound, upper_bound=res.upper_bound,
            stats={"rung": rung, "expanded": res.stats.expanded})
        out.wall_s = wall
        return out
    if verification:
        return _host_verify_outcome(res, float(tau), backend, wall,
                                    rung=rung)
    return _host_compute_outcome(res, backend, wall, rung=rung)


def agreed_host_solve(executor: Executor, q, g, tau: Optional[float],
                      verification: bool, cfg: EngineConfig, backend: str,
                      rung: int, ctx: Optional[faults.RunContext] = None
                      ) -> GedOutcome:
    """:func:`host_solve` on behalf of ``executor``'s ranks.

    On a ``torch.distributed`` mesh (``executor.spmd``) the first rank
    solves and every rank takes its outcome and the counters it bumped,
    since a host search under a deadline reads each rank's own clock.
    One process solves the pair itself.
    """
    if not executor.spmd:
        return host_solve(q, g, tau, verification, cfg, backend, rung, ctx)
    solved = []

    def solve():
        solved.append(True)
        before = dict(ctx.stats) if ctx is not None else {}
        o = host_solve(q, g, tau, verification, cfg, backend, rung, ctx)
        after = ctx.stats if ctx is not None else {}
        return o, {k: v - before.get(k, 0) for k, v in after.items()
                   if v != before.get(k, 0)}

    o, bumped = executor.from_root(solve)
    if not solved and ctx is not None:
        for k, v in bumped.items():
            ctx.bump(k, v)
    return o


def deadline_passed(executor: Executor,
                    ctx: Optional[faults.RunContext]) -> bool:
    """Has ``ctx``'s deadline passed?  Each rank of a mesh reads its own
    clock, so they agree first (one all-reduce); without a deadline this
    makes no collective."""
    return (ctx is not None and ctx.has_deadline
            and executor.agree(ctx.expired())[0])


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
            cfg: EngineConfig, ctx: Optional[faults.RunContext] = None
            ) -> List[GedOutcome]:
        outcomes: List[GedOutcome] = []
        for i, (q, g) in enumerate(plan.pairs):
            tau = float(taus[i]) if verification else None
            if ctx is not None and ctx.expired():
                # budget already spent: cheap admissible floor, no search
                ctx.bump("timed_out_pairs")
                outcomes.append(faults.fallback_outcome(
                    q, g, verification, tau, self.name,
                    stats={"rung": 0}))
                continue
            outcomes.append(host_solve(
                q, g, tau, verification, cfg, self.name, 0, ctx))
        return outcomes


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
            cfg: EngineConfig, ctx: Optional[faults.RunContext] = None
            ) -> List[GedOutcome]:
        results: List[Optional[GedOutcome]] = [None] * len(plan.pairs)
        for bucket in plan.buckets:
            t0 = time.perf_counter()
            if deadline_passed(self.executor, ctx):
                # deadline gone: remaining buckets answer from the cheap
                # admissible floor (one dispatch is the unit of work)
                for gi in bucket.indices:
                    ctx.bump("timed_out_pairs")
                    q, g = plan.pairs[gi]
                    results[gi] = faults.fallback_outcome(
                        q, g, verification,
                        float(taus[gi]) if verification else None,
                        self.name, stats={"rung": 0})
                continue
            try:
                pending = self.executor.run_bucket_async(
                    bucket, taus, cfg, verification, ctx=ctx, rung=0)
                out = pending.result()
            except Exception as exc:
                if not faults.degradable(exc, self.executor.device):
                    raise
                # the engine is gone for this bucket: the ladder's next
                # step is the certified host solver (never the plain twin
                # of a failed kernel)
                faults.warn_once(
                    f"degrade-host-{self.name}",
                    f"{self.name} backend: engine bucket failed "
                    f"({exc!r}); degrading its pairs to the host solver")
                for gi in bucket.indices:
                    if ctx is not None:
                        ctx.bump("degraded_host")
                    q, g = plan.pairs[gi]
                    o = agreed_host_solve(
                        self.executor, q, g,
                        float(taus[gi]) if verification else None,
                        verification, cfg, self.name, 0, ctx)
                    o.stats["degraded"] = True
                    results[gi] = o
                continue
            wall = time.perf_counter() - t0
            for bi, gi in enumerate(bucket.indices):
                o = engine_outcome(
                    out, bucket.packed, bi, verification,
                    float(taus[gi]) if verification else None,
                    self.name, wall, rung=0)
                if pending.flags:
                    o.stats.update(pending.flags)
                results[gi] = o
        return results  # type: ignore[return-value]


class CudaBackend(EngineBackend):
    """Engine policy with the CUDA kernels on the hot path; same outcomes
    as ``"torch"``."""

    name = "cuda"
    kernel_default = True


class ShardedBackend(EngineBackend):
    """The ``"torch"`` policy on a :class:`ShardedExecutor`: each batch is
    split over the devices of ``mesh``, flat or a named ``DeviceMesh``
    (default: every visible card, or the one device ``device`` names).
    Only the placement differs, so outcomes equal ``"torch"``'s.
    ``dispatch=`` puts the kernels on its path.

    >>> ShardedBackend(mesh=["cpu"] * 2).batch_multiple
    2
    """

    name = "sharded"
    kernel_default = False

    def __init__(self, mesh=None, device=None) -> None:
        super().__init__(executor=ShardedExecutor(mesh, device=device))


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

    Under a deadline (``ctx``) the loop stops dispatching once it
    expires, drains what is in flight and answers every pair it has not
    certified with its best-so-far admissible bounds, uncertified and
    ``timed_out``.  A bucket whose dispatch or result fails permanently
    goes to the host solver (``degraded_host``); on the card only an
    injected fault does, a real failure is raised after what is in flight
    has drained.

    ``stats``: ``pairs``, ``escalated``, ``host_solved``, ``batches``,
    ``dispatches``, ``overlap_saved_s`` (host seconds a batch spent in
    flight outside any blocking drain), ``survivors_rung_{k}``, and
    ``degraded_host`` / ``timed_out_pairs`` once they happen.  On the
    card a dispatch returns before its batch ends (the executor's worker
    runs the search), so batches cook while the loop host-solves and
    drains; on the CPU a dispatch returns a finished batch.

    The policy composes with any executor: a single-device
    :class:`~repro_torch.ged.exec.Executor` by default, a
    :class:`~repro_torch.ged.exec.ShardedExecutor` over ``mesh`` when one
    is given (what ``GedEngine("auto", mesh=...)`` builds), or an
    explicit ``executor=``.  Outcomes are the same whatever the placement.
    On a ``torch.distributed`` mesh drains stay first in, first out, which
    puts the ranks' gathers in one order; whether to host-solve while a
    batch cooks and whether the deadline has passed are agreed over the
    ranks, and host solves come from the first rank.

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
                 executor: Optional[Executor] = None, mesh=None,
                 overlap: bool = True, max_in_flight: int = 4):
        if executor is None:
            executor = (ShardedExecutor(mesh, device=device)
                        if mesh is not None else Executor(device))
        self.scheduler = GedScheduler(batch_size)
        self.executor = executor
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
            cfg: EngineConfig, ctx: Optional[faults.RunContext] = None
            ) -> List[GedOutcome]:
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
        has_deadline = ctx is not None and ctx.has_deadline
        # best-so-far admissible bounds per surviving pair, merged across
        # rungs (anytime contract); kept only under a deadline, from the
        # rows drain already holds as numpy, so the no-deadline path does
        # no extra work
        best: Dict[int, tuple] = {}
        degraded: set = set()               # pairs routed around a fault

        def merge_best(gi: int, lb: float, ub: float) -> None:
            plb, pub = best.get(gi, (0.0, float("inf")))
            best[gi] = (max(plb, lb), min(pub, ub))

        def solve_host(gi: int) -> None:
            q, g = plan.pairs[gi]
            self.stats["host_solved"] += 1
            o = agreed_host_solve(
                self.executor, q, g,
                float(taus[gi]) if verification else None,
                verification, cfg, f"{self.name}/exact", -1, ctx)
            if gi in degraded:
                o.stats["degraded"] = True
            if not o.certified and gi in best:
                # fold the engine rungs' best-so-far bounds into an
                # uncertified answer (both sides admissible: still sound)
                lb, ub = best[gi]
                o.lower_bound = max(o.lower_bound, lb)
                o.upper_bound = min(o.upper_bound, ub)
                o.lower_bound = min(o.lower_bound, o.upper_bound)
                if verification and o.similar is None:
                    if o.lower_bound > float(taus[gi]):
                        o.similar = False
                    elif o.upper_bound <= float(taus[gi]):
                        o.similar = True
            results[gi] = o

        def degrade_bucket(bucket: Bucket, exc: Exception) -> None:
            # the engine rung is gone for these pairs: route them to the
            # ladder's next step, the host solver, instead of failing the
            # whole run; a real failure on the card is raised instead
            if not faults.degradable(exc, self.executor.device):
                raise exc
            fresh = [gi for gi in bucket.indices if results[gi] is None]
            degraded.update(fresh)
            host_queue.extend(fresh)
            self.stats["degraded_host"] = \
                self.stats.get("degraded_host", 0) + len(fresh)
            if ctx is not None:
                ctx.bump("degraded_host", len(fresh))
            faults.warn_once(
                "degrade-host-auto",
                f"auto backend: engine rung failed ({exc!r}); routing "
                f"{len(fresh)} pairs to the host solver")

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
            try:
                pending = self.executor.run_bucket_async(
                    bucket, taus, rcfg, verification, ctx=ctx, rung=rung)
            except Exception as exc:
                degrade_bucket(bucket, exc)
                return
            item = _InFlight(bucket, rung, pending, time.perf_counter())
            if self.overlap:
                inflight.append(item)
            else:
                drain(item)             # sequential baseline: block now

        def drain(item: _InFlight) -> None:
            # a batch that fails at materialisation degrades to the host
            # solver; only a real failure on the card raises
            nonlocal last_block_end
            t_drain = time.perf_counter()
            try:
                out = item.pending.result()  # blocks until the batch lands
            except Exception as exc:
                last_block_end = time.perf_counter()
                degrade_bucket(item.bucket, exc)
                return
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
                    o = engine_outcome(
                        out, item.bucket.packed, bi, verification,
                        float(taus[gi]) if verification else None,
                        self.name, wall, rung=item.rung)
                    if item.pending.flags:
                        o.stats.update(item.pending.flags)
                    results[gi] = o
                else:
                    survivors.append(bi)
                    if has_deadline:
                        # the pool floor is admissible; the compute-mode
                        # raw ged is the engine's incumbent full mapping
                        merge_best(
                            gi, float(out["lower_bound"][bi]),
                            float("inf") if verification
                            else float(out["ged"][bi]))
            skey = f"survivors_rung_{item.rung}"
            self.stats[skey] = self.stats.get(skey, 0) + len(survivors)
            if survivors:
                self.stats["escalated"] += len(survivors)
                nxt = self.scheduler.escalate(
                    Batch(list(item.bucket.indices), 0.0, item.rung),
                    survivors)
                if nxt is not None:
                    queue.append(nxt)

        expired = False
        try:
            while queue or dispatchable or inflight or host_queue:
                if deadline_passed(self.executor, ctx):
                    expired = True
                    break
                refill()
                # keep the device fed: dispatch while there's work and room
                while dispatchable and len(inflight) < self.max_in_flight:
                    dispatch(*dispatchable.popleft())
                    refill()
                if inflight:
                    # host-solve while the oldest batch is in flight (on a
                    # mesh: on any rank), until the deadline passes
                    while host_queue:
                        cooking, over = self.executor.agree(
                            not inflight[0].pending.ready(),
                            has_deadline and ctx.expired())
                        if not cooking or over:
                            break
                        solve_host(host_queue.pop(0))
                    drain(inflight.popleft())
                elif host_queue:
                    solve_host(host_queue.pop(0))
        finally:
            # never strand dispatched work or lose its survivors' bounds:
            # on expiry or a mid-flight error, drain what is in flight
            while inflight:
                drain(inflight.popleft())
        if expired or any(r is None for r in results):
            # anytime tail: every pair the budget never reached answers
            # with its best-so-far admissible bounds, uncertified
            for gi, r in enumerate(results):
                if r is not None:
                    continue
                q, g = plan.pairs[gi]
                lb, ub = best.get(gi, (0.0, float("inf")))
                o = faults.fallback_outcome(
                    q, g, verification,
                    float(taus[gi]) if verification else None,
                    self.name, lower_bound=lb, upper_bound=ub)
                if gi in degraded:
                    o.stats["degraded"] = True
                results[gi] = o
                self.stats["timed_out_pairs"] = \
                    self.stats.get("timed_out_pairs", 0) + 1
                if ctx is not None:
                    ctx.bump("timed_out_pairs")
        return results  # type: ignore[return-value]


# -------------------------------------------------------------- registry

_REGISTRY: Dict[str, Callable[..., Backend]] = {}


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    """Make ``GedEngine(backend=name)`` constructible; ``factory`` receives
    the keyword options its signature names."""
    _REGISTRY[name] = factory


def available_backends() -> tuple:
    """Sorted names ``GedEngine(backend=...)`` accepts right now.

    >>> available_backends()
    ('auto', 'cuda', 'exact', 'sharded', 'torch')
    """
    return tuple(sorted(_REGISTRY))


def make_backend(name: str, **options) -> Backend:
    """Construct a registered backend, dropping options it doesn't take.

    >>> make_backend("torch", device="cpu", unused=1).name
    'torch'
    """
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
register_backend("sharded", ShardedBackend)
