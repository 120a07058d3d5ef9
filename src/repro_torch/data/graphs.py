"""Labeled-graph generators mirroring the paper's §6 experimental setup.

* ``random_graph``  — GraphGen-equivalent: |V| vertices, target edge density,
  ``n_vlabels`` vertex labels, ``n_elabels`` edge labels (paper: density 20%,
  5 vertex labels, 2 edge labels).
* ``perturb``       — apply ``x`` random edit operations to a graph (the
  paper builds each synthetic group by perturbing a seed graph).
* ``aids_like_graph`` — sparse molecule-like graphs (tree + few extra edges,
  skewed label distribution) approximating the AIDS dataset statistics.
* ``graph_pair_groups`` — pair sampler grouped by (|V|, GED-perturbation).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.exact.graph import Graph


def random_graph(
    rng: np.random.Generator,
    n: int,
    density: float = 0.2,
    n_vlabels: int = 5,
    n_elabels: int = 2,
) -> Graph:
    vlabels = rng.integers(0, n_vlabels, size=n)
    adj = np.zeros((n, n), dtype=np.int64)
    iu = np.triu_indices(n, k=1)
    present = rng.random(len(iu[0])) < density
    labels = rng.integers(1, n_elabels + 1, size=len(iu[0]))
    vals = np.where(present, labels, 0)
    adj[iu] = vals
    adj = adj + adj.T
    return Graph(vlabels, adj)


def aids_like_graph(
    rng: np.random.Generator,
    n: int,
    n_vlabels: int = 62,
    n_elabels: int = 3,
) -> Graph:
    """Sparse, molecule-like: random spanning tree + ~8% extra edges, Zipfian
    vertex labels (a few heavy atoms dominate, like C/N/O in AIDS)."""
    # Zipf-ish label distribution over n_vlabels
    ranks = np.arange(1, n_vlabels + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    vlabels = rng.choice(n_vlabels, size=n, p=probs)
    adj = np.zeros((n, n), dtype=np.int64)
    for v in range(1, n):
        u = int(rng.integers(0, v))
        a = int(rng.integers(1, n_elabels + 1))
        adj[u, v] = adj[v, u] = a
    extra = max(0, int(0.08 * n))
    for _ in range(extra):
        u, v = rng.integers(0, n, size=2)
        if u != v and adj[u, v] == 0:
            a = int(rng.integers(1, n_elabels + 1))
            adj[u, v] = adj[v, u] = a
    return Graph(vlabels, adj)


def perturb(
    rng: np.random.Generator,
    g: Graph,
    n_ops: int,
    n_vlabels: int = 5,
    n_elabels: int = 2,
) -> Graph:
    """Apply ``n_ops`` random edit operations (paper's group construction).

    Operations: vertex relabel, edge relabel, edge insert, edge delete.
    (Vertex insert/delete changes |V|; the paper's groups keep |V| within
    +-2, we keep it fixed for determinism of the group's nominal GED.)
    """
    g = g.copy()
    n = g.n
    for _ in range(n_ops):
        op = rng.integers(0, 4)
        if op == 0 and n > 0:  # vertex relabel
            v = int(rng.integers(0, n))
            old = g.vlabels[v]
            new = int(rng.integers(0, n_vlabels))
            if new == old:
                new = (new + 1) % max(n_vlabels, 2)
            g.vlabels[v] = new
        elif op == 1:  # edge relabel
            ii, jj = np.nonzero(np.triu(g.adj, k=1))
            if len(ii) == 0:
                continue
            k = int(rng.integers(0, len(ii)))
            u, v = int(ii[k]), int(jj[k])
            old = int(g.adj[u, v])
            new = int(rng.integers(1, n_elabels + 1))
            if new == old:
                new = 1 + (new % max(n_elabels, 2))
            g.adj[u, v] = g.adj[v, u] = new
        elif op == 2 and n >= 2:  # edge insert
            for _attempt in range(8):
                u, v = rng.integers(0, n, size=2)
                if u != v and g.adj[u, v] == 0:
                    a = int(rng.integers(1, n_elabels + 1))
                    g.adj[u, v] = g.adj[v, u] = a
                    break
        else:  # edge delete
            ii, jj = np.nonzero(np.triu(g.adj, k=1))
            if len(ii) == 0:
                continue
            k = int(rng.integers(0, len(ii)))
            u, v = int(ii[k]), int(jj[k])
            g.adj[u, v] = g.adj[v, u] = 0
    return g


def graph_pair_groups(
    seed: int,
    sizes: Tuple[int, ...] = (10, 15, 20),
    ops: Tuple[int, ...] = (1, 2, 3, 4, 5),
    pairs_per_group: int = 10,
    density: float = 0.2,
    n_vlabels: int = 5,
    n_elabels: int = 2,
) -> Dict[Tuple[int, int], List[Tuple[Graph, Graph]]]:
    """Paper §6 synthetic setup: per (|V|, x) group, ``pairs_per_group``
    pairs of (seed graph, x-edit perturbation)."""
    rng = np.random.default_rng(seed)
    groups: Dict[Tuple[int, int], List[Tuple[Graph, Graph]]] = {}
    for n in sizes:
        for x in ops:
            pairs = []
            for _ in range(pairs_per_group):
                base = random_graph(rng, n, density, n_vlabels, n_elabels)
                other = perturb(rng, base, x, n_vlabels, n_elabels)
                pairs.append((base, other))
            groups[(n, x)] = pairs
    return groups
