"""Brute-force GED oracles for tests (Lemma 2.2: min editorial cost)."""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.exact.graph import Graph, editorial_cost, pad_pair


def brute_force_ged(q: Graph, g: Graph, limit: int = 9) -> int:
    """Exact GED by enumerating all |V(g)|! mappings.  Tiny graphs only."""
    q, g, _ = pad_pair(q, g)
    if q.n > limit:
        raise ValueError(f"brute force limited to n <= {limit}")
    best = np.inf
    for perm in itertools.permutations(range(g.n)):
        best = min(best, editorial_cost(q, g, np.asarray(perm)))
    return int(best)


def brute_force_extension_cost(
    q: Graph, g: Graph, order: np.ndarray, img: Tuple[int, ...],
) -> int:
    """Min editorial cost over all full mappings extending a partial mapping.

    Oracle for admissibility property tests: any lower bound ``lb(f)`` must
    satisfy ``lb(f) <= brute_force_extension_cost(f)``.
    """
    n = g.n
    used = set(img)
    free_g = [u for u in range(n) if u not in used]
    rest_q = [int(v) for v in order[len(img):]]
    f = np.full(n, -1, dtype=np.int64)
    for v, u in zip(order[: len(img)], img):
        f[int(v)] = int(u)
    best = np.inf
    for perm in itertools.permutations(free_g):
        for v, u in zip(rest_q, perm):
            f[v] = u
        best = min(best, editorial_cost(q, g, f))
    return int(best)
