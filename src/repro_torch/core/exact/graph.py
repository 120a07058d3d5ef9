"""Labeled undirected graphs and the paper's §2.1 simplifications.

Conventions
-----------
* Vertex labels are integers ``>= 0``; the special label ``BOTTOM = -1`` marks
  padding vertices (the paper's unique label ``_|_`` not in Sigma).
* Edges are stored in a dense symmetric adjacency matrix ``adj`` where
  ``adj[i, j] == 0`` means "no edge" and ``adj[i, j] == a >= 1`` means an edge
  with label ``a``.  No self loops.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np

BOTTOM = -1  # label of padding (inserted isolated) vertices


@dataclasses.dataclass
class Graph:
    """A labeled undirected graph."""

    vlabels: np.ndarray  # (n,) int64
    adj: np.ndarray      # (n, n) int64; 0 = absent, >=1 edge label

    def __post_init__(self) -> None:
        self.vlabels = np.asarray(self.vlabels, dtype=np.int64)
        self.adj = np.asarray(self.adj, dtype=np.int64)
        n = self.vlabels.shape[0]
        if self.adj.shape != (n, n):
            raise ValueError(f"adj shape {self.adj.shape} != ({n},{n})")
        if not np.array_equal(self.adj, self.adj.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(self.adj) != 0):
            raise ValueError("self loops are not supported")

    # -- basic accessors ---------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.vlabels.shape[0])

    @property
    def m(self) -> int:
        return int(np.count_nonzero(self.adj) // 2)

    @property
    def size(self) -> int:
        """``size(g) = |V(g)| + |E(g)|`` (paper §2)."""
        return self.n + self.m

    def degree(self, v: int) -> int:
        return int(np.count_nonzero(self.adj[v]))

    def degrees(self) -> np.ndarray:
        return np.count_nonzero(self.adj, axis=1)

    def edges(self) -> Iterable[Tuple[int, int, int]]:
        """Yield ``(i, j, label)`` with ``i < j``."""
        ii, jj = np.nonzero(np.triu(self.adj, k=1))
        for i, j in zip(ii.tolist(), jj.tolist()):
            yield i, j, int(self.adj[i, j])

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_edges(
        vlabels: Sequence[int],
        edges: Iterable[Tuple[int, int, int]],
    ) -> "Graph":
        n = len(vlabels)
        adj = np.zeros((n, n), dtype=np.int64)
        for i, j, a in edges:
            if i == j:
                raise ValueError("self loop")
            if a <= 0:
                raise ValueError("edge labels must be >= 1")
            adj[i, j] = a
            adj[j, i] = a
        return Graph(np.asarray(vlabels, dtype=np.int64), adj)

    def copy(self) -> "Graph":
        return Graph(self.vlabels.copy(), self.adj.copy())

    def induced(self, keep: Sequence[int]) -> "Graph":
        keep = np.asarray(keep, dtype=np.int64)
        return Graph(self.vlabels[keep], self.adj[np.ix_(keep, keep)])

    def __repr__(self) -> str:  # pragma: no cover - debug helper
        return f"Graph(n={self.n}, m={self.m})"


def pad_pair(q: Graph, g: Graph) -> Tuple[Graph, Graph, bool]:
    """Apply the paper's §2.1 simplifications.

    Ensures ``|V(q)| <= |V(g)|`` (swapping if necessary; GED is symmetric) and
    pads ``q`` with isolated ``BOTTOM``-labeled vertices so both graphs have
    the same vertex count.  Returns ``(q', g', swapped)``.
    """
    swapped = False
    if q.n > g.n:
        q, g = g, q
        swapped = True
    if q.n < g.n:
        pad = g.n - q.n
        vlabels = np.concatenate([q.vlabels, np.full(pad, BOTTOM, dtype=np.int64)])
        adj = np.zeros((g.n, g.n), dtype=np.int64)
        adj[: q.n, : q.n] = q.adj
        q = Graph(vlabels, adj)
    return q, g, swapped


def editorial_cost(q: Graph, g: Graph, f: Sequence[int]) -> int:
    """Algorithm 1: editorial cost of a full mapping ``f`` (uniform costs).

    ``q`` and ``g`` must have the same number of vertices (use :func:`pad_pair`
    first); ``f[v]`` is the vertex of ``g`` that ``v`` maps to.

    Vertex relabels + (edge delete / insert / relabel), where an edge pair
    ``(v, v') -> (f(v), f(v'))`` costs 1 iff the labels differ (absence is
    label 0, so delete/insert fall out of the same comparison).
    """
    f = np.asarray(f, dtype=np.int64)
    if q.n != g.n or f.shape[0] != q.n:
        raise ValueError("editorial_cost requires padded, equal-size graphs")
    cost = int(np.count_nonzero(q.vlabels != g.vlabels[f]))
    mapped = g.adj[np.ix_(f, f)]
    cost += int(np.count_nonzero(np.triu(q.adj != mapped, k=1)))
    return cost


def relabel_compact(q: Graph, g: Graph) -> Tuple[Graph, Graph, int, int]:
    """Jointly re-map vertex/edge labels of a pair to compact ranges.

    Vertex labels become ``0..Lv-1`` (``BOTTOM`` stays ``BOTTOM``); edge
    labels become ``1..Le``.  Returns ``(q', g', Lv, Le)``.  Used by the JAX
    engine, which wants dense histogram bins.
    """
    vset = sorted(set(q.vlabels.tolist() + g.vlabels.tolist()) - {BOTTOM})
    vmap = {a: i for i, a in enumerate(vset)}
    vmap[BOTTOM] = BOTTOM
    eset = sorted(
        (set(np.unique(q.adj).tolist()) | set(np.unique(g.adj).tolist())) - {0}
    )
    emap = {0: 0}
    emap.update({a: i + 1 for i, a in enumerate(eset)})

    def remap(gr: Graph) -> Graph:
        vl = np.array([vmap[int(a)] for a in gr.vlabels], dtype=np.int64)
        adj = np.vectorize(lambda a: emap[int(a)])(gr.adj).astype(np.int64)
        return Graph(vl, adj)

    return remap(q), remap(g), len(vset), len(eset)
