"""Robustness primitives for the ``repro_torch.ged`` engine.

The port's copy of ``repro/ged/faults.py``.  The escalation structure
(cheap admissible bounds -> tighter anchor-aware bounds -> exact search)
is *anytime*: at every rung the engine holds valid lower/upper bounds per
pair.  This module turns that shape into a contract:

* :class:`Deadline` — a wall-clock budget threaded from
  ``GedEngine(deadline_s=...)`` through the ``auto`` rung loop, the
  executor and the host solver's cooperative iteration checks.  When it
  expires, every pair still returns a
  :class:`~repro_torch.ged.results.GedOutcome` carrying its best-so-far
  admissible bounds with ``certified=False`` and ``timed_out`` in
  ``stats`` — never an exception, never a missing result.
* :class:`RetryPolicy` — bounded retries with exponential backoff plus
  deterministic jitter, and transient-vs-permanent error classification
  (:func:`classify_transient`).
* :class:`FaultInjector` — deterministic failure injection at every
  degradation site (``REPRO_GED_FAULT_INJECT`` — the same variable the
  reference reads, so one chaos spec drives either package — or
  ``GedEngine(fault_inject=...)``).
* :class:`RunContext` — the per-call bundle (deadline + injector + retry
  policy) the facade hands to backends and the executor; ``None``
  everywhere means the bit-identical path with no robustness work.
* :func:`cheap_lower_bound` / :func:`fallback_outcome` — the admissible
  stage-0-style floor for pairs the budget never reached.

The port's degradation ladder starts *below* the kernels: a dispatch that
fails permanently sends its bucket to the host solver, and a failed host
solve answers from the admissible floor.  On the card only an injected
``dispatch``/``kernel``/``result`` fault takes that step
(:func:`degradable`): a real kernel build or launch error, a CUDA error or
an out-of-memory past its retries is raised to the caller, so work never
moves to the CPU behind a failing kernel.  There is no unfused step — a
failed kernel is never replaced by its plain PyTorch twin — so the
reference's ``degraded_kernel`` counter never appears; the port reports
``degraded_host`` where the reference reports ``degraded_kernel``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "Deadline", "RetryPolicy", "RunContext", "FaultInjector",
    "InjectedFault", "Overloaded", "cheap_lower_bound", "fallback_outcome",
    "classify_transient", "degradable", "get_injector", "install_injector",
    "warn_once", "FAULT_INJECT_ENV",
]

FAULT_INJECT_ENV = "REPRO_GED_FAULT_INJECT"

_LOG = logging.getLogger("repro_torch.ged.faults")
_WARNED: set = set()


def warn_once(key: str, message: str) -> bool:
    """Log ``message`` at WARNING level once per process per ``key``;
    returns whether it was emitted.

    Degradation events repeat under sustained faults; one line per failure
    *class* keeps the signal without flooding logs.

    >>> warn_once("doctest-demo", "something degraded")
    True
    >>> warn_once("doctest-demo", "something degraded")   # suppressed
    False
    """
    if key in _WARNED:
        return False
    _WARNED.add(key)
    _LOG.warning(message)
    return True


# ------------------------------------------------------------- deadlines

class Deadline:
    """A wall-clock budget: ``Deadline(0.5)`` expires 0.5 s after creation.

    ``Deadline(None)`` never expires (every check is a cheap constant), so
    the facade builds one unconditionally.

    >>> d = Deadline(None)
    >>> d.expired(), d.remaining() == float("inf")
    (False, True)
    >>> Deadline(-1.0).expired()        # already spent on arrival
    True
    """

    __slots__ = ("t_end", "t_start")

    def __init__(self, seconds: Optional[float],
                 _now: Optional[float] = None):
        now = time.monotonic() if _now is None else _now
        self.t_start = now
        self.t_end = None if seconds is None else now + float(seconds)

    def expired(self) -> bool:
        """True once the budget is spent (never for ``Deadline(None)``)."""
        return self.t_end is not None and time.monotonic() >= self.t_end

    def remaining(self) -> float:
        """Seconds left (``inf`` for no deadline, clamped at 0)."""
        if self.t_end is None:
            return float("inf")
        return max(0.0, self.t_end - time.monotonic())

    def sub(self, seconds: Optional[float]) -> "Deadline":
        """A child deadline: ``seconds`` from now, capped by this one.

        A per-pair budget composes with the call-level budget this way:
        each host-solver pair gets ``min(per_pair, what the call has
        left)``.
        """
        if seconds is None:
            child = Deadline(None)
            child.t_end = self.t_end
            return child
        child = Deadline(float(seconds))
        if self.t_end is not None:
            child.t_end = min(child.t_end, self.t_end)
        return child


# ------------------------------------------------------ fault injection

class InjectedFault(RuntimeError):
    """A failure raised by :class:`FaultInjector` at a named site.

    ``transient`` drives :func:`classify_transient`: transient faults are
    retried by the :class:`RetryPolicy`, permanent ones degrade at once
    (engine -> host solver -> admissible floor).
    """

    def __init__(self, site: str, transient: bool = False):
        super().__init__(f"injected {'transient' if transient else 'permanent'}"
                         f" fault at {site!r}")
        self.site = site
        self.transient = transient

    def __reduce__(self):
        # pickled intact, so the ranks of a mesh can raise one another's
        return type(self), (self.site, self.transient)


_SITES = frozenset({"dispatch", "kernel", "result", "lock", "host"})


@dataclasses.dataclass
class _FaultSpec:
    site: str                       # dispatch | kernel | result | lock | host
    times: float = 1                # how many matching calls fail (inf ok)
    rung: Optional[int] = None      # only fire at this escalation rung
    transient: bool = False

    def matches(self, site: str, rung: Optional[int]) -> bool:
        if self.site != site or self.times <= 0:
            return False
        if self.rung is not None and rung != self.rung:
            return False
        return True


class FaultInjector:
    """Deterministic failure injection at the engine's degradation sites.

    Specs are ``site[@key=value,...]`` joined by ``;``.  Sites:

    * ``dispatch`` — executor dispatch of a packed bucket;
    * ``kernel``   — the CUDA kernels' build or launch (fires only when the
      dispatched config enables kernels);
    * ``result``   — materialisation of a dispatched batch
      (``PendingBatch.result()``);
    * ``lock``     — shared-cache lock acquisition (raises the timeout
      path);
    * ``host``     — the exact host solver.

    Keys: ``times`` (how many matching calls fail, default 1, ``inf``
    allowed), ``rung`` (only that escalation rung), ``kind``
    (``transient`` | ``permanent``, default permanent).

    >>> inj = FaultInjector("dispatch@times=2,kind=transient")
    >>> try: inj.check("dispatch")
    ... except InjectedFault as exc: print(exc)
    injected transient fault at 'dispatch'
    >>> try: inj.check("dispatch")
    ... except InjectedFault: pass
    >>> inj.check("dispatch")                   # budget spent: no fault
    >>> inj.fired
    2
    """

    def __init__(self, spec: str = ""):
        self.specs: List[_FaultSpec] = []
        self.fired = 0
        for part in str(spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, opts = part.partition("@")
            site = site.strip()
            if site not in _SITES:
                # a typo'd site would never fire and the chaos drill would
                # silently test nothing
                raise ValueError(f"unknown fault site {site!r} in "
                                 f"{part!r}; expected one of "
                                 f"{sorted(_SITES)}")
            fs = _FaultSpec(site=site)
            for kv in opts.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                k, v = k.strip(), v.strip()
                if k == "times":
                    fs.times = float("inf") if v == "inf" else int(v)
                elif k == "rung":
                    fs.rung = int(v)
                elif k == "kind":
                    fs.transient = v == "transient"
                else:
                    raise ValueError(f"unknown fault-spec key {k!r} in "
                                     f"{part!r}")
            self.specs.append(fs)

    def check(self, site: str, rung: Optional[int] = None) -> None:
        """Raise :class:`InjectedFault` when a live spec matches ``site``."""
        for fs in self.specs:
            if fs.matches(site, rung):
                fs.times -= 1
                self.fired += 1
                raise InjectedFault(site, transient=fs.transient)


# Process-global injector (environment-driven chaos testing); engine-level
# injectors ride the RunContext instead and take precedence.  The
# reference keeps a global of its own: the two read one variable.
_GLOBAL_INJECTOR: Optional[FaultInjector] = None
_GLOBAL_ENV: Optional[str] = None


def install_injector(injector: Optional[FaultInjector]) -> None:
    """Pin the process-global injector (``None`` restores env behavior)."""
    global _GLOBAL_INJECTOR, _GLOBAL_ENV
    _GLOBAL_INJECTOR = injector
    _GLOBAL_ENV = None if injector is None else "<installed>"


def get_injector(ctx: Optional["RunContext"] = None
                 ) -> Optional[FaultInjector]:
    """The injector in effect: the context's, the installed one, or the
    ``REPRO_GED_FAULT_INJECT`` environment spec (re-parsed when the
    variable changes, so subprocess tests can flip it per run)."""
    if ctx is not None and ctx.injector is not None:
        return ctx.injector
    global _GLOBAL_INJECTOR, _GLOBAL_ENV
    env = os.environ.get(FAULT_INJECT_ENV) or None
    if _GLOBAL_ENV == "<installed>":
        return _GLOBAL_INJECTOR
    if env != _GLOBAL_ENV:
        _GLOBAL_ENV = env
        _GLOBAL_INJECTOR = FaultInjector(env) if env else None
    return _GLOBAL_INJECTOR


# ----------------------------------------------------------- retry policy

def classify_transient(exc: BaseException) -> bool:
    """Is ``exc`` worth retrying verbatim (vs degrading at once)?

    Injected faults carry their own kind.  Real transients are resource or
    communication shaped: the reference's rules (``OSError``,
    ``TimeoutError``, ``ConnectionError`` and XLA's ``RESOURCE_EXHAUSTED``
    family of status texts), and their CUDA counterpart
    ``torch.cuda.OutOfMemoryError``.  Every other CUDA error is permanent:
    a sticky CUDA error poisons the context, so a retry cannot succeed.
    Kernel build errors are permanent by construction.

    >>> classify_transient(InjectedFault("dispatch", transient=True))
    True
    >>> classify_transient(torch.cuda.OutOfMemoryError("out of memory"))
    True
    >>> classify_transient(RuntimeError("CUDA error: an illegal memory access"))
    False
    >>> classify_transient(ValueError("bad shape"))
    False
    """
    if isinstance(exc, InjectedFault):
        return exc.transient
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, RuntimeError) and "CUDA" in text:
        return False
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return True
    return any(tag in text for tag in (
        "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
        "ABORTED", "INTERNAL: Failed to"))


def degradable(exc: BaseException, device) -> bool:
    """May an engine bucket that failed with ``exc`` on ``device`` go down
    the ladder to the host solver?

    On the card only an injected fault does.  A real failure there — a
    kernel that does not build or launch, a CUDA error, an out-of-memory
    past its retries — is raised to the caller: degrading it would move
    the work to the CPU behind a broken kernel.  On the CPU every failure
    degrades, as in the reference.

    >>> degradable(InjectedFault("kernel"), torch.device("cuda"))
    True
    >>> degradable(RuntimeError("nvcc failed"), torch.device("cuda"))
    False
    >>> degradable(RuntimeError("boom"), torch.device("cpu"))
    True
    """
    return isinstance(exc, InjectedFault) or torch.device(device).type != "cuda"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and deterministic jitter.

    ``backoff_s(attempt)`` grows ``base * 2**attempt`` up to ``cap_s``,
    plus a small attempt-keyed jitter (golden-ratio hash: deterministic,
    so tests replay exactly, yet de-synchronised across attempt counts).
    The same values as the reference's.

    >>> p = RetryPolicy(max_retries=2, base_s=0.1, cap_s=1.0)
    >>> 0.1 <= p.backoff_s(0) < 0.15
    True
    >>> p.backoff_s(5) <= 1.0 * 1.5
    True
    """

    max_retries: int = 2
    base_s: float = 0.05
    cap_s: float = 2.0

    def backoff_s(self, attempt: int) -> float:
        base = min(self.base_s * (2.0 ** attempt), self.cap_s)
        jitter = ((attempt * 0.6180339887498949) % 1.0) * 0.5
        return base * (1.0 + jitter)


# ------------------------------------------------------------ run context

@dataclasses.dataclass
class RunContext:
    """Per-call robustness bundle the facade threads through a run.

    ``deadline`` is the call-level budget (a no-deadline call carries
    ``Deadline(None)``); ``per_pair_deadline_s`` caps each host-solver
    pair on top of it; ``injector`` / ``retry`` configure the fault path.
    ``stats`` collects the fault counters the facade folds into
    ``engine.stats``.
    """

    deadline: Deadline = dataclasses.field(
        default_factory=lambda: Deadline(None))
    per_pair_deadline_s: Optional[float] = None
    injector: Optional[FaultInjector] = None
    retry: RetryPolicy = RetryPolicy()
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    def bump(self, key: str, by: float = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + by

    @property
    def has_deadline(self) -> bool:
        return self.deadline.t_end is not None

    def expired(self) -> bool:
        return self.deadline.expired()

    def pair_deadline(self) -> Deadline:
        """Budget for one host-solver pair: the per-pair cap under the
        call budget (see :meth:`Deadline.sub`)."""
        return self.deadline.sub(self.per_pair_deadline_s)


# ------------------------------------------------- admissible fallbacks

def cheap_lower_bound(q, g) -> float:
    """Admissible O(n + m) GED floor for a pair the budget never reached:
    ``Y_v + max(Y_e, ceil(L1(degree sequences) / 2))``.  Vertex and edge
    costs are disjoint, so the sum stays a sound lower bound.

    >>> from repro_torch.ged.plan import as_graph
    >>> q = as_graph(([0, 0], [(0, 1, 1)]))
    >>> g = as_graph(([0, 1, 1], [(0, 1, 1), (1, 2, 1)]))
    >>> cheap_lower_bound(q, g)
    3.0
    """
    cqv = Counter(np.asarray(q.vlabels).tolist())
    cgv = Counter(np.asarray(g.vlabels).tolist())
    y_v = max(q.n, g.n) - sum(min(cqv[k], cgv[k]) for k in cqv.keys() & cgv)
    cqe = Counter(a for _, _, a in q.edges())
    cge = Counter(a for _, _, a in g.edges())
    y_e = max(q.m, g.m) - sum(min(cqe[k], cge[k]) for k in cqe.keys() & cge)
    k = max(q.n, g.n, 1)
    dq = np.zeros(k)
    dq[: q.n] = np.sort(q.degrees())[::-1]
    dg = np.zeros(k)
    dg[: g.n] = np.sort(g.degrees())[::-1]
    d = np.ceil(np.sum(np.abs(dq - dg)) / 2.0)
    return float(y_v + max(y_e, d))


def fallback_outcome(q, g, verification: bool, tau: Optional[float],
                     backend: str, *, timed_out: bool = True,
                     lower_bound: Optional[float] = None,
                     upper_bound: float = float("inf"),
                     stats: Optional[Dict[str, float]] = None):
    """A sound, uncertified :class:`~repro_torch.ged.results.GedOutcome`
    for a pair the run could not finish (deadline expiry, exhausted
    faults).

    ``lower_bound`` is raised to :func:`cheap_lower_bound` (both floors
    are admissible, so the max is too); ``upper_bound`` is the caller's
    best-so-far incumbent (``inf`` when no full mapping was found).  A
    verification answer stays ``similar=None`` unless the bounds already
    decide it (floor above tau rejects; incumbent at or below tau
    accepts).
    """
    from repro_torch.ged.results import GedOutcome

    lb = cheap_lower_bound(q, g)
    if lower_bound is not None:
        lb = max(lb, float(lower_bound))
    ub = float(upper_bound)
    lb = min(lb, ub)            # a real incumbent caps every floor
    out_stats = {"rung": -2, **(stats or {})}
    if timed_out:
        out_stats["timed_out"] = True
    similar: Optional[bool] = None
    if verification and tau is not None:
        if lb > tau:
            similar = False     # sound reject: floor already above tau
        elif ub <= tau:
            similar = True      # sound accept: a mapping at or below tau
    return GedOutcome(
        ged=None, similar=similar, certified=False,
        lower_bound=lb, upper_bound=ub, mapping=None,
        backend=backend, wall_s=0.0,
        tau=tau if verification else None, stats=out_stats)


# --------------------------------------------------------------- serving

class Overloaded(RuntimeError):
    """Load-shed response: the serving queue is full; retry later.

    Raised by a serving admission controller *before* any engine work
    runs.  ``retry_after_s`` is the caller's backoff hint,
    ``queue_depth`` / ``capacity`` the queue snapshot that shed it.

    >>> err = Overloaded(0.25, 9, 8)
    >>> str(err), err.capacity
    ('serving queue full (9/8 pending); retry after 0.25s', 8)
    """

    def __init__(self, retry_after_s: float, queue_depth: int,
                 capacity: int):
        super().__init__(
            f"serving queue full ({queue_depth}/{capacity} pending); "
            f"retry after {retry_after_s:.2f}s")
        self.retry_after_s = float(retry_after_s)
        self.queue_depth = int(queue_depth)
        self.capacity = int(capacity)
