"""The unified GED search framework (paper Alg. 2, §3/§5).

One loop, instantiated by the priority-queue pop rule:

* ``strategy="astar"`` — pop minimum lower bound, tie-break larger level
  (**AStar+**, §5.1); terminates as soon as the popped bound reaches the
  incumbent upper bound.
* ``strategy="dfs"``  — pop largest level, tie-break smaller bound
  (**DFS+**, §5.2).

Memory model follows the paper: each queue entry stores one partial mapping
plus its *ungenerated siblings* — with the **expand-all** strategy (§5.1)
siblings are materialised (scored once) and attached; without it
(``expand_all=False``, the ``-EO`` variants of Eval-IV) only the candidate
set is kept and the best-extension computation re-runs per sibling request.

Verification (§5.3): initialise the incumbent to ``tau + eps`` and return as
soon as a full mapping with editorial cost <= ``tau`` is found.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.exact.bounds import BoundEvaluator, PairContext, SCORERS
from repro_torch.core.exact.graph import Graph, editorial_cost, pad_pair
from repro_torch.core.exact.order import matching_order

BOUNDS = tuple(SCORERS.keys())  # ("LS", "LSa", "BM", "BMa", "BMaN", "SM", "SMa")

_INF = float("inf")


@dataclasses.dataclass
class SearchStats:
    best_extension_calls: int = 0
    expanded: int = 0
    generated: int = 0
    pops: int = 0
    max_queue: int = 0
    full_mappings_seen: int = 0
    wall_time_s: float = 0.0


@dataclasses.dataclass
class SearchResult:
    ged: Optional[int]            # exact GED (computation mode)
    similar: Optional[bool]       # verification verdict (verification mode)
    best_mapping: Optional[np.ndarray]
    upper_bound: float
    stats: SearchStats
    # Anytime fields (appended with defaults so completed searches are
    # unchanged): on deadline expiry the search stops cooperatively and
    # reports the admissible floor over everything still open.
    lower_bound: Optional[float] = None
    timed_out: bool = False


class _Entry:
    """One queue entry: a partial mapping + its ungenerated siblings."""

    __slots__ = ("img", "level", "g_cost", "lb", "siblings", "cand", "parent_g_cost")

    def __init__(self, img, level, g_cost, lb, siblings, cand, parent_g_cost=0.0):
        self.img = img              # tuple of images of order[:level]
        self.level = level
        self.g_cost = g_cost
        self.lb = lb
        self.siblings = siblings    # sorted [(lb, u, g_cost), ...] or None
        self.cand = cand            # frozenset of remaining candidates (EO mode)
        self.parent_g_cost = parent_g_cost


def _key(strategy: str, lb: float, level: int, n: int) -> Tuple:
    if strategy == "astar":
        return (lb, n - level)
    if strategy == "dfs":
        return (-level, lb)
    raise ValueError(f"unknown strategy {strategy!r}")


def _search(
    q: Graph,
    g: Graph,
    bound: str = "BMa",
    strategy: str = "astar",
    tau: Optional[float] = None,
    expand_all: bool = True,
    order: Optional[np.ndarray] = None,
    deadline=None,
) -> SearchResult:
    t0 = time.perf_counter()
    q, g, _swapped = pad_pair(q, g)
    n = q.n
    stats = SearchStats()
    if n == 0:
        stats.wall_time_s = time.perf_counter() - t0
        verdict = True if tau is not None else None
        return SearchResult(0 if tau is None else None, verdict,
                            np.zeros(0, dtype=np.int64), 0.0, stats)

    if order is None:
        order = matching_order(q, g)
    ctx = PairContext(q, g, order)
    ev = BoundEvaluator(ctx)
    scorer = SCORERS[bound].__get__(ev)

    verification = tau is not None
    ub = (tau + 0.5) if verification else _INF
    best_map: Optional[np.ndarray] = None

    heap: List[Tuple[Tuple, int, _Entry]] = []
    tick = itertools.count()

    def push(entry: _Entry) -> None:
        heapq.heappush(heap, (_key(strategy, entry.lb, entry.level, n), next(tick), entry))
        stats.max_queue = max(stats.max_queue, len(heap))

    def full_mapping_from_order(img: Tuple[int, ...]) -> np.ndarray:
        f = np.full(n, -1, dtype=np.int64)
        for v, u in zip(order, img):
            f[int(v)] = int(u)
        return f

    def try_update_ub(f: np.ndarray, cost: Optional[float] = None) -> Optional[bool]:
        """Update incumbent from a full mapping; returns True on early accept."""
        nonlocal ub, best_map
        if cost is None:
            cost = editorial_cost(q, g, f)
        stats.full_mappings_seen += 1
        if cost < ub:
            ub = float(cost)
            best_map = f.copy()
        if verification and cost <= tau:
            return True
        return None

    def score_children(entry: _Entry, cand_mask: Optional[np.ndarray]):
        stats.best_extension_calls += 1
        return scorer(entry.img, entry.g_cost, cand_mask)

    # -- root ---------------------------------------------------------------
    push(_Entry((), 0, 0.0, 0.0, [], None))
    accepted = False
    timed_out = False
    open_lb = 0.0               # admissible floor over open work at expiry

    while heap:
        key, _, entry = heapq.heappop(heap)
        stats.pops += 1
        # Cooperative deadline check (anytime contract, docs/robustness.md):
        # the first pop and then every 16 keeps the overhead unmeasurable
        # on completed searches while bounding overshoot to a handful of
        # expansions — and guarantees an already-expired deadline stops
        # even a tiny search before real work.  ``deadline`` is duck-typed
        # (anything with ``expired()``) so the core layer stays
        # independent of repro_torch.ged.
        if deadline is not None and (stats.pops & 0xF) == 1 \
                and deadline.expired():
            timed_out = True
            # Every not-yet-enumerated full mapping descends from an open
            # entry (cost >= its lb) or from one pruned at lb >= the ub
            # threshold, so this min is a sound global lower bound.
            open_lb = min(min(e.lb for _, _, e in heap),
                          entry.lb, ub) if heap else min(entry.lb, ub)
            break
        if entry.lb >= ub:
            if strategy == "astar":
                break  # everything left has lb >= this lb >= ub
            continue
        stats.expanded += 1

        # (a) regenerate the best ungenerated sibling (Alg. 2 line 7)
        if entry.level > 0:
            sib = None
            if expand_all:
                while entry.siblings:
                    lb_s, u_s, gc_s = entry.siblings[0]
                    if lb_s >= ub:
                        entry.siblings = []  # sorted: all following are >= ub
                        break
                    entry.siblings = entry.siblings[1:]
                    sib = _Entry(entry.img[:-1] + (u_s,), entry.level, gc_s,
                                 max(lb_s, entry.lb), entry.siblings, None)
                    break
            else:
                if entry.cand:
                    parent_img = entry.img[:-1]
                    mask = np.zeros(n, dtype=bool)
                    mask[list(entry.cand)] = True
                    sc = scorer(parent_img, entry.parent_g_cost, mask)
                    stats.best_extension_calls += 1
                    u_s = int(np.argmin(sc.lb))
                    if np.isfinite(sc.lb[u_s]) and sc.lb[u_s] < ub:
                        sib = _Entry(parent_img + (u_s,), entry.level,
                                     float(sc.g_cost[u_s]),
                                     max(float(sc.lb[u_s]), entry.lb),
                                     None, entry.cand - {u_s},
                                     parent_g_cost=entry.parent_g_cost)
            if sib is not None:
                stats.generated += 1
                push(sib)

        # (b) extend: children of this entry (Alg. 2 line 8)
        if entry.level == n:
            # full mapping reached via the queue: already accounted
            continue
        if entry.level == n - 1:
            # children are leaves: compute exact editorial costs directly
            fr_scores = score_children(entry, None)  # for stats parity
            used = set(entry.img)
            best_cost, best_u = _INF, None
            for u in range(n):
                if u in used:
                    continue
                c = float(fr_scores.g_cost[u])
                if c < best_cost:
                    best_cost, best_u = c, u
            if best_u is not None:
                f = full_mapping_from_order(entry.img + (best_u,))
                if try_update_ub(f, best_cost):
                    accepted = True
                    break
            continue

        scores = score_children(entry, None)
        # Heuristic full-mapping extension (Alg. 2 line 13 / §4.2 remark):
        # only for assignment-based bounds (paper: not for LS/LSa).
        if scores.full_mapping is not None:
            if try_update_ub(scores.full_mapping):
                accepted = True
                break

        lbs = scores.lb
        finite = np.isfinite(lbs)
        if not np.any(finite):
            continue
        # lower bounds are non-decreasing along a root-leaf path (§5.1 note)
        lbs = np.where(finite, np.maximum(lbs, entry.lb), _INF)
        u_best = int(np.argmin(lbs))
        lb_best = float(lbs[u_best])
        if lb_best >= ub:
            continue
        if expand_all:
            sib_list = sorted(
                (float(lbs[u]), u, float(scores.g_cost[u]))
                for u in range(n)
                if finite[u] and u != u_best and lbs[u] < ub
            )
            child = _Entry(entry.img + (u_best,), entry.level + 1,
                           float(scores.g_cost[u_best]), lb_best, sib_list, None,
                           parent_g_cost=entry.g_cost)
        else:
            cand = frozenset(u for u in range(n) if finite[u] and u != u_best)
            child = _Entry(entry.img + (u_best,), entry.level + 1,
                           float(scores.g_cost[u_best]), lb_best, None, cand,
                           parent_g_cost=entry.g_cost)
        stats.generated += 1
        push(child)

    stats.wall_time_s = time.perf_counter() - t0
    if timed_out:
        # Best-so-far result: a real incumbent (if any) is the upper
        # bound; in verification mode the initial ``tau + 0.5`` is only a
        # pruning threshold, not a mapping, so without an incumbent the
        # true upper bound is unknown.
        true_ub = ub if best_map is not None else _INF
        if verification:
            similar: Optional[bool] = None
            if open_lb > tau:
                similar = False     # all remaining possibilities exceed tau
            elif true_ub <= tau:
                similar = True      # an incumbent at or below tau exists
            return SearchResult(None, similar, best_map, true_ub, stats,
                                lower_bound=float(open_lb), timed_out=True)
        return SearchResult(None, None, best_map, true_ub, stats,
                            lower_bound=float(open_lb), timed_out=True)
    if verification:
        similar = accepted or (ub <= tau)
        return SearchResult(None, bool(similar), best_map, ub, stats)
    ged_val = int(round(ub)) if np.isfinite(ub) else None
    return SearchResult(ged_val, None, best_map, ub, stats)


def ged(
    q: Graph,
    g: Graph,
    bound: str = "BMa",
    strategy: str = "astar",
    expand_all: bool = True,
    order: Optional[np.ndarray] = None,
    deadline=None,
) -> SearchResult:
    """GED computation: ``delta(q, g)`` with the chosen bound/strategy."""
    return _search(q, g, bound=bound, strategy=strategy, tau=None,
                   expand_all=expand_all, order=order, deadline=deadline)


def ged_verify(
    q: Graph,
    g: Graph,
    tau: float,
    bound: str = "BMa",
    strategy: str = "astar",
    expand_all: bool = True,
    order: Optional[np.ndarray] = None,
    deadline=None,
) -> SearchResult:
    """GED verification: is ``delta(q, g) <= tau``? (§5.3)."""
    return _search(q, g, bound=bound, strategy=strategy, tau=float(tau),
                   expand_all=expand_all, order=order, deadline=deadline)
