"""Corpus-wide stage-0 lower bounds for graph-database search.

The counterpart of ``repro/core/engine/corpus.py``.  The paper frames GED
*verification* as the primitive of graph similarity search: a cheap
filter phase prunes the database, and only survivors reach the expensive
verifier.  This module is the filter phase's arithmetic — per-graph
**features** extracted once at ingest, and one vectorized pass that
scores a query against a whole slot bucket of the corpus with sound lower
bounds:

* ``Y_v`` — vertex-label multiset bound ``max(n_q, n_g) - sum_l min(h_q, h_g)``;
* ``Y_e`` — the same over edge-label multisets;
* ``D``  — degree-sequence bound ``ceil(L1(sorted degrees) / 2)``: every
  edge insertion/deletion changes the sorted degree sequence's L1
  distance by at most 2, and relabels change it not at all.

``Y_e`` and ``D`` both lower-bound the number of edge operations, so the
combined bound is ``Y_v + max(Y_e, D)``, which never exceeds
``delta(q, g)``.  Every value is a small integer in f32, so the torch
pass on the card equals the reference's ``jnp`` pass exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.exact.graph import Graph

# Distinct stage-0 scan shapes met this process (counted by
# ``ged/filters.py``), the counterpart of the reference's trace counter.
_SCAN_TRACES = 0


def scan_traces() -> int:
    """How many distinct stage-0 scan shapes ``(slots, batch, width,
    Lv + 1, Le + 1)`` the filter indexes of this process have met (each
    index counts its own shapes, as each reference index compiles its
    own)."""
    return _SCAN_TRACES


def note_scan_shape() -> None:
    """Count one new scan shape (see :func:`scan_traces`)."""
    global _SCAN_TRACES
    _SCAN_TRACES += 1


@dataclasses.dataclass
class CorpusFeatures:
    """Stage-0 feature arrays for a batch of corpus graphs.

    ``vhist``/``ehist`` use the shared vocabulary plus one trailing
    "other" bin; corpus graphs never populate "other" when the vocab was
    built from the corpus, so query-only labels intersect nothing (the
    bound stays sound either way).  ``degs`` holds descending-sorted
    degree sequences zero-padded to a common width.  Host numpy arrays
    (the on-disk segments of a saved store); a filter index keeps a copy
    of each on its device.
    """

    vhist: np.ndarray   # (B, Lv + 1) float32 vertex-label counts
    ehist: np.ndarray   # (B, Le + 1) float32 edge-label counts
    degs: np.ndarray    # (B, K) float32 degree sequence, sorted desc
    n: np.ndarray       # (B,) float32 vertex counts
    m: np.ndarray       # (B,) float32 edge counts

    @property
    def batch(self) -> int:
        return self.vhist.shape[0]

    @property
    def width(self) -> int:
        return self.degs.shape[1]

    def arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.vhist, self.ehist, self.degs, self.n, self.m)


def graph_features(
    graphs: Sequence[Graph],
    vocab: Tuple[Sequence[int], Sequence[int]],
    width: Optional[int] = None,
) -> CorpusFeatures:
    """Extract :class:`CorpusFeatures` for ``graphs`` under ``vocab``.

    ``width`` — degree-sequence padding width (defaults to the largest
    ``g.n`` in the batch).  Labels outside the vocabulary land in the
    trailing "other" bin.

    >>> g = Graph.from_edges([0, 1], [(0, 1, 1)])
    >>> f = graph_features([g], vocab=((0, 1), (1,)))
    >>> f.vhist[0].tolist(), f.ehist[0].tolist(), f.degs[0].tolist()
    ([1.0, 1.0, 0.0], [1.0, 0.0], [1.0, 1.0])
    """
    vmap = {int(a): i for i, a in enumerate(vocab[0])}
    emap = {int(a): i for i, a in enumerate(vocab[1])}
    lv, le = len(vmap), len(emap)
    if width is None:
        width = max((g.n for g in graphs), default=1)
    B = len(graphs)
    vhist = np.zeros((B, lv + 1), dtype=np.float32)
    ehist = np.zeros((B, le + 1), dtype=np.float32)
    degs = np.zeros((B, width), dtype=np.float32)
    ns = np.zeros((B,), dtype=np.float32)
    ms = np.zeros((B,), dtype=np.float32)
    for b, g in enumerate(graphs):
        if g.n > width:
            raise ValueError(f"graph with {g.n} vertices exceeds width {width}")
        for a in g.vlabels.tolist():
            vhist[b, vmap.get(int(a), lv)] += 1.0
        for _, _, a in g.edges():
            ehist[b, emap.get(int(a), le)] += 1.0
        d = np.sort(g.degrees())[::-1].astype(np.float32)
        degs[b, : g.n] = d
        ns[b] = g.n
        ms[b] = g.m
    return CorpusFeatures(vhist, ehist, degs, ns, ms)


def stage0_lower_bounds(qvh, qeh, qdeg, qn, qm, cvh, ceh, cdeg, cn, cm
                        ) -> torch.Tensor:
    """Sound per-graph GED lower bounds for one query against a batch.

    Query tensors are rank-1 (``qn``/``qm`` scalars); corpus tensors carry
    the batch on their leading axis, ``cdeg`` as wide as ``qdeg``.  All
    f32 on one device; returns ``(B,)`` f32 on it.

    >>> t = torch.tensor
    >>> float(stage0_lower_bounds(
    ...     t([2., 0.]), t([1., 0.]), t([1., 1.]), t(2.), t(1.),
    ...     t([[1., 1.]]), t([[0., 0.]]), t([[0., 0.]]), t([2.]), t([0.]))[0])
    2.0
    """
    inter_v = torch.minimum(qvh[None, :], cvh).sum(dim=-1)
    y_v = torch.maximum(qn, cn) - inter_v
    inter_e = torch.minimum(qeh[None, :], ceh).sum(dim=-1)
    y_e = torch.maximum(qm, cm) - inter_e
    l1 = (qdeg[None, :] - cdeg).abs().sum(dim=-1)
    d = torch.ceil(l1 * 0.5)
    return y_v + torch.maximum(y_e, d)


def stage0_reference(q: Graph, g: Graph) -> float:
    """Host-side oracle for :func:`stage0_lower_bounds` on one pair.

    >>> a = Graph.from_edges([0, 0], [(0, 1, 1)])
    >>> b = Graph.from_edges([0, 1, 1], [(0, 1, 1), (1, 2, 1)])
    >>> stage0_reference(a, b)
    3.0
    """
    from collections import Counter

    cqv, cgv = Counter(q.vlabels.tolist()), Counter(g.vlabels.tolist())
    y_v = max(q.n, g.n) - sum(min(cqv[k], cgv[k]) for k in cqv.keys() & cgv)
    cqe = Counter(a for _, _, a in q.edges())
    cge = Counter(a for _, _, a in g.edges())
    y_e = max(q.m, g.m) - sum(min(cqe[k], cge[k]) for k in cqe.keys() & cge)
    k = max(q.n, g.n)
    dq = np.zeros(k)
    dq[: q.n] = np.sort(q.degrees())[::-1]
    dg = np.zeros(k)
    dg[: g.n] = np.sort(g.degrees())[::-1]
    d = np.ceil(np.sum(np.abs(dq - dg)) / 2.0)
    return float(y_v + max(y_e, d))
