"""Exact minimum-cost perfect matching (Hungarian / Jonker-Volgenant style).

Used by the BM/BMa/SM/SMa lower bounds (paper §4, Alg. 3).  The solver keeps
explicit dual potentials so that the *forced* variants needed by Alg. 3 —
"cost of the optimal assignment with row ``r`` forced to column ``c``, for
every ``c``" — run in one full solve plus one O(n^2) re-augmentation per
column (O(n^3) total), instead of |V(g)| independent solves.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

_INF = float("inf")


class _JVState:
    """Dual potentials + partial assignment supporting row-by-row augmenting."""

    def __init__(self, cost: np.ndarray):
        cost = np.asarray(cost, dtype=np.float64)
        if cost.ndim != 2 or cost.shape[0] != cost.shape[1]:
            raise ValueError("cost must be a square matrix")
        if not np.all(np.isfinite(cost)):
            raise ValueError("cost entries must be finite (use a large BIG)")
        self.cost = cost
        n = cost.shape[0]
        self.n = n
        # 1-indexed potentials / assignment, index 0 is the virtual column.
        self.u = np.zeros(n + 1)
        self.v = np.zeros(n + 1)
        self.p = np.zeros(n + 1, dtype=np.int64)  # p[j] = row (1-idx) on col j

    def clone(self) -> "_JVState":
        s = _JVState.__new__(_JVState)
        s.cost = self.cost
        s.n = self.n
        s.u = self.u.copy()
        s.v = self.v.copy()
        s.p = self.p.copy()
        return s

    def augment(self, row: int, banned_col: int | None = None) -> None:
        """Insert ``row`` (0-indexed) via one shortest-augmenting-path sweep.

        ``banned_col`` (0-indexed) is treated as permanently occupied and can
        never appear on the alternating path.
        """
        n = self.n
        cost, u, v, p = self.cost, self.u, self.v, self.p
        p[0] = row + 1
        j0 = 0
        minv = np.full(n + 1, _INF)
        way = np.zeros(n + 1, dtype=np.int64)
        used = np.zeros(n + 1, dtype=bool)
        if banned_col is not None:
            used[banned_col + 1] = True
        while True:
            used[j0] = True
            i0 = p[j0]
            free = ~used[1:]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            upd = free & (cur < minv[1:])
            if np.any(upd):
                minv1 = minv[1:]
                way1 = way[1:]
                minv1[upd] = cur[upd]
                way1[upd] = j0
            masked = np.where(free, minv[1:], _INF)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            if not np.isfinite(delta):  # pragma: no cover - defensive
                raise RuntimeError("infeasible assignment problem")
            used_js = np.nonzero(used)[0]
            u[p[used_js]] += delta
            v[used_js] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    def col_of_row(self) -> np.ndarray:
        out = np.full(self.n, -1, dtype=np.int64)
        for j in range(1, self.n + 1):
            if self.p[j] > 0:
                out[self.p[j] - 1] = j - 1
        return out

    def total(self, skip_row: int | None = None) -> float:
        tot = 0.0
        for j in range(1, self.n + 1):
            i = self.p[j]
            if i > 0 and (skip_row is None or i - 1 != skip_row):
                tot += self.cost[i - 1, j - 1]
        return tot


def hungarian(cost: np.ndarray) -> Tuple[np.ndarray, float]:
    """Solve min-cost perfect matching.  Returns ``(col_of_row, total)``."""
    st = _JVState(cost)
    for i in range(st.n):
        st.augment(i)
    col = st.col_of_row()
    return col, st.total()


def solve_forced_all(cost: np.ndarray, row: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """For every column ``c``: optimal total with ``row -> c`` forced.

    Returns ``(forced_totals, col_of_row, total)`` where ``col_of_row`` /
    ``total`` describe the *unforced* optimum (the matching ``M`` of Alg. 3,
    also used by the paper's full-mapping upper-bound heuristic).

    Strategy: one full JV solve; for each other column ``c`` displace the row
    currently holding ``c``, free ``row``'s own column, and re-augment the
    displaced row with ``c`` banned — O(n^2) per column, O(n^3) total.
    """
    base = _JVState(cost)
    for i in range(base.n):
        base.augment(i)
    col = base.col_of_row()
    total = base.total()
    n = base.n
    forced = np.empty(n, dtype=np.float64)
    c0 = int(col[row])
    forced[c0] = total
    for c in range(n):
        if c == c0:
            continue
        st = base.clone()
        displaced = int(st.p[c + 1]) - 1  # row currently on column c
        # Remove `row` (it pins column c outside the reduced problem) and
        # free its old column c0; re-insert the displaced row.
        st.p[c0 + 1] = 0
        st.p[c + 1] = 0
        if displaced == row:
            # `row` already sat on c in the optimum; reduced problem unchanged.
            forced[c] = total
            continue
        st.augment(displaced, banned_col=c)
        forced[c] = cost[row, c] + st.total(skip_row=row)
    return forced, col, total


def brute_force_assignment(cost: np.ndarray) -> Tuple[np.ndarray, float]:
    """O(n!) oracle for tests."""
    cost = np.asarray(cost, dtype=np.float64)
    n = cost.shape[0]
    best = None
    best_cost = _INF
    for perm in itertools.permutations(range(n)):
        c = float(sum(cost[i, perm[i]] for i in range(n)))
        if c < best_cost:
            best_cost = c
            best = perm
    return np.asarray(best, dtype=np.int64), best_cost
