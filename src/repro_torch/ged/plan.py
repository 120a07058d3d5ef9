"""Workload planning for the ``repro_torch.ged`` facade.

Two jobs, both shape-related (the counterpart of ``repro/ged/plan.py``):

1. **Ingestion** — :func:`as_graph` accepts the formats users actually have
   (``Graph`` objects, ``(vlabels, edges)`` tuples, adjacency dicts), and
   :func:`graphs_vocab` / :func:`merge_vocab` give a corpus its shared
   label vocabulary.
2. **Bucketing** — :func:`build_plan` groups pairs by power-of-two slot
   count and pads each bucket's batch dimension to a power of two, with
   one label vocabulary shared by every bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine.tensor_graphs import (GraphPairTensors,
                                                   label_vocab, pack_pairs)
from repro_torch.core.exact.graph import Graph

MIN_SLOTS = 4

Vocab = Tuple[Tuple[int, ...], Tuple[int, ...]]


# ------------------------------------------------------------- ingestion

def as_graph(obj) -> Graph:
    """Coerce a user-facing graph description into a :class:`Graph`.

    Accepted forms:

    * ``Graph`` — returned as-is;
    * ``(vlabels, edges)`` tuple/list with ``edges`` of ``(i, j, elabel)``;
    * ``{"vlabels": [...], "edges": [...]}`` or ``{"vlabels": [...],
      "adj": matrix}`` dicts;
    * adjacency dict ``{node: (vlabel, [(neighbor, elabel), ...])}`` with
      arbitrary hashable node ids (indexed in sorted order).

    >>> g = as_graph(([0, 1, 1], [(0, 1, 1), (1, 2, 2)]))
    >>> g.n, g.m
    (3, 2)
    >>> as_graph({"a": (0, [("b", 1)]), "b": (1, [("a", 1)])}).n
    2
    """
    if isinstance(obj, Graph):
        return obj
    if isinstance(obj, dict):
        if "vlabels" in obj:
            if "adj" in obj:
                return Graph(np.asarray(obj["vlabels"]), np.asarray(obj["adj"]))
            return Graph.from_edges(list(obj["vlabels"]),
                                    list(obj.get("edges", ())))
        nodes = sorted(obj)
        index = {v: i for i, v in enumerate(nodes)}
        vlabels = [int(obj[v][0]) for v in nodes]
        edges, seen = [], set()
        for v in nodes:
            for nbr, lab in obj[v][1]:
                i, j = index[v], index[nbr]
                key = (min(i, j), max(i, j))
                if i == j or key in seen:
                    continue
                seen.add(key)
                edges.append((i, j, int(lab)))
        return Graph.from_edges(vlabels, edges)
    if isinstance(obj, (tuple, list)) and len(obj) == 2:
        vlabels, edges = obj
        return Graph.from_edges(list(vlabels), list(edges))
    raise TypeError(
        f"cannot interpret {type(obj).__name__} as a graph; expected Graph, "
        "(vlabels, edges), or an adjacency dict")


def as_pairs(pairs) -> List[Tuple[Graph, Graph]]:
    out = []
    for p in pairs:
        q, g = p
        out.append((as_graph(q), as_graph(g)))
    return out


def graphs_vocab(graphs: Sequence[Graph]) -> Vocab:
    """Shared ``(vertex_labels, edge_labels)`` vocabulary for a corpus.

    The single-graph analogue of
    :func:`repro_torch.core.engine.tensor_graphs.label_vocab` — a
    :class:`repro_torch.ged.GraphStore` computes it once at ingest so
    every query bucket (and the stage-0 feature histograms) share one
    compact label space.

    >>> g = as_graph(([0, 5], [(0, 1, 2)]))
    >>> graphs_vocab([g])
    ((0, 5), (2,))
    """
    return label_vocab([(g, g) for g in graphs])


def merge_vocab(vocab: Vocab, graphs: Sequence[Graph]) -> Vocab:
    """``vocab`` extended with any labels ``graphs`` introduce.

    Queries against an ingested corpus may carry labels the corpus never
    uses; packing with the merged vocabulary keeps every bucket's coverage
    check satisfied while staying stable for the common all-known-labels
    case.

    >>> merge_vocab(((0,), (1,)), [as_graph(([0, 7], [(0, 1, 3)]))])
    ((0, 7), (1, 3))
    """
    extra_v, extra_e = graphs_vocab(graphs)
    return (tuple(sorted(set(vocab[0]) | set(extra_v))),
            tuple(sorted(set(vocab[1]) | set(extra_e))))


# -------------------------------------------------------------- bucketing

def _pow2(n: int) -> int:
    return max(1, 1 << (int(n) - 1).bit_length())


def slot_bucket(n: int, min_slots: int = MIN_SLOTS) -> int:
    """Power-of-two slot count for a padded pair of ``n`` vertices.

    >>> [slot_bucket(n) for n in (1, 4, 5, 9)]
    [4, 4, 8, 16]
    """
    return max(min_slots, _pow2(max(n, 1)))


def pad_tail(values: np.ndarray, batch: int) -> np.ndarray:
    """Pad a per-pair value array to ``batch`` by repeating the last entry —
    the same rule :func:`pack_bucket` uses for the pairs themselves."""
    arr = np.asarray(values)
    return np.concatenate([arr, np.repeat(arr[-1:], batch - arr.shape[0],
                                          axis=0)])


def padded_batch(real: int, batch_multiple: int = 1) -> int:
    """Batch size after padding: the power of two >= ``real``, rounded up to
    a multiple of ``batch_multiple`` (the executor's shard count).

    >>> [padded_batch(r) for r in (1, 3, 5)]
    [1, 4, 8]
    >>> padded_batch(9, batch_multiple=8)
    16
    """
    b = _pow2(real)
    if b % batch_multiple:
        b = -(-b // batch_multiple) * batch_multiple
    return b


def pack_bucket(
    pairs: Sequence[Tuple[Graph, Graph]],
    slots: int,
    vocab: Optional[Vocab],
    batch_multiple: int = 1,
) -> Tuple[GraphPairTensors, int]:
    """Pack ``pairs`` at ``slots``, padding the batch dim to
    :func:`padded_batch` (the filler repeats the last pair).  Returns
    ``(tensors, real_count)``."""
    real = len(pairs)
    padded = list(pairs) + [pairs[-1]] * (padded_batch(real, batch_multiple)
                                          - real)
    return pack_pairs(padded, slots=slots, vocab=vocab), real


@dataclasses.dataclass
class Bucket:
    slots: int
    indices: List[int]          # positions in the plan's pair list
    packed: GraphPairTensors    # batch padded to a power of two
    real: int                   # pairs before batch padding

    def pad_values(self, values: np.ndarray) -> np.ndarray:
        """Gather per-pair values for this bucket, padded like the batch."""
        return pad_tail(np.asarray(values)[self.indices], self.packed.batch)


@dataclasses.dataclass
class Plan:
    pairs: List[Tuple[Graph, Graph]]
    buckets: List[Bucket]
    vocab: Vocab
    fixed_slots: Optional[int]  # user-pinned slot count (disables bucketing)

    @classmethod
    def lazy(cls, pairs, vocab: Optional[Vocab] = None,
             slots: Optional[int] = None) -> "Plan":
        """A plan with *no* packed buckets: pack subsets on demand with
        :meth:`subset_buckets`.

        >>> plan = Plan.lazy([(([0], []), ([1], []))])
        >>> plan.buckets, plan.vocab
        ([], ((0, 1), ()))
        """
        pairs = as_pairs(pairs)
        if vocab is None:
            vocab = label_vocab(pairs)
        return cls(pairs, [], vocab, slots)

    def subset_buckets(self, indices: Sequence[int], packer) -> List[Bucket]:
        """Re-bucket a subset of this plan's pairs.

        The overlapped ``auto`` backend calls this between escalation
        rungs: survivors of rung *k* are regrouped by slot bucket
        (honouring ``fixed_slots``) and re-packed with the plan's shared
        vocab.  ``packer`` is :meth:`repro_torch.ged.exec.Executor.pack`
        shaped: ``packer(pairs, slots, vocab) -> (tensors, real)``.

        >>> plan = build_plan([(([0], []), ([1], [])),
        ...                    (([0] * 6, []), ([0] * 5, []))])
        >>> [(b.slots, b.indices) for b in plan.subset_buckets(
        ...     [1, 0], lambda p, s, v: pack_bucket(p, s, v))]
        [(4, [0]), (8, [1])]
        """
        by_slots: Dict[int, List[int]] = {}
        for gi in indices:
            q, g = self.pairs[gi]
            s = self.fixed_slots or slot_bucket(max(q.n, g.n))
            by_slots.setdefault(s, []).append(gi)
        out = []
        for s in sorted(by_slots):
            idxs = by_slots[s]
            packed, real = packer([self.pairs[i] for i in idxs], s,
                                  self.vocab)
            out.append(Bucket(s, idxs, packed, real))
        return out


def build_plan(
    raw_pairs,
    slots: Optional[int] = None,
    vocab: Optional[Vocab] = None,
    batch_multiple: int = 1,
) -> Plan:
    """Ingest ``raw_pairs`` and group them into canonical-shape buckets.

    ``batch_multiple`` pads every bucket's batch to a multiple of it.

    >>> plan = build_plan([(([0], []), ([1], [])),
    ...                    (([0] * 6, []), ([0] * 5, []))])
    >>> [(b.slots, b.indices, b.packed.batch) for b in plan.buckets]
    [(4, [0], 1), (8, [1], 1)]
    """
    pairs = as_pairs(raw_pairs)
    if vocab is None:
        vocab = label_vocab(pairs)
    else:
        vocab = tuple(sorted(int(a) for a in vocab[0])), \
            tuple(sorted(int(a) for a in vocab[1]))
    by_slots: Dict[int, List[int]] = {}
    for i, (q, g) in enumerate(pairs):
        s = slots if slots is not None else slot_bucket(max(q.n, g.n))
        by_slots.setdefault(s, []).append(i)
    buckets = []
    for s in sorted(by_slots):
        idxs = by_slots[s]
        packed, real = pack_bucket([pairs[i] for i in idxs], s, vocab,
                                   batch_multiple)
        buckets.append(Bucket(s, idxs, packed, real))
    return Plan(pairs, buckets, vocab, slots)
