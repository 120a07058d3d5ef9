"""Frequency-aware connected matching order (paper App. A.1).

Infrequency weight of a vertex/edge of ``q`` = 1 - frequency of its label in
``g``.  Greedy: start from the vertex with the largest total weight (vertex +
adjacent edges), then repeatedly append the vertex with the largest total
weight of (its own label + edges connecting it to the chosen prefix),
preferring vertices connected to the prefix.  Padding (``BOTTOM``) vertices
are structureless and are deferred to the end of the order.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np

from repro_torch.core.exact.graph import BOTTOM, Graph


def matching_order(q: Graph, g: Graph) -> np.ndarray:
    n = q.n
    vfreq = Counter(g.vlabels.tolist())
    efreq: Counter = Counter()
    for _, _, a in g.edges():
        efreq[a] += 1
    n_g = max(g.n, 1)
    m_g = max(g.m, 1)

    wv = np.array([1.0 - vfreq.get(int(a), 0) / n_g for a in q.vlabels])
    we = np.where(q.adj > 0,
                  1.0 - np.vectorize(lambda a: efreq.get(int(a), 0))(q.adj) / m_g,
                  0.0)

    is_pad = q.vlabels == BOTTOM
    chosen: List[int] = []
    in_order = np.zeros(n, dtype=bool)

    def total_weight_initial(v: int) -> float:
        return wv[v] + float(we[v].sum())

    def total_weight_to_prefix(v: int) -> float:
        return wv[v] + float(we[v, in_order].sum())

    while len(chosen) < n:
        cands = [v for v in range(n) if not in_order[v] and not is_pad[v]]
        if not cands:
            cands = [v for v in range(n) if not in_order[v]]
        if chosen:
            connected = [v for v in cands if np.any(q.adj[v, in_order] > 0)]
            pool = connected if connected else cands
            best = max(pool, key=total_weight_to_prefix)
        else:
            best = max(cands, key=total_weight_initial)
        chosen.append(best)
        in_order[best] = True
    return np.asarray(chosen, dtype=np.int64)
