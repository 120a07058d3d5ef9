"""Dense padded tensor representation of (q, g) pairs.

Label conventions (compact, per *batch*):
* vertex labels ``0 .. Lv-1`` are real, ``Lv`` is the BOTTOM padding label
  (paper's ``_|_``), ``Lv+1`` marks PAD slots (non-vertices beyond ``n``).
* edge labels ``1 .. Le`` real, ``0`` = no edge.  PAD slots have no edges.

All pairs in a batch share the static size ``N`` (max vertices) and the label
vocabularies ``Lv`` / ``Le``; the per-pair true size ``n`` is data.

Packing happens on the host in numpy and yields arrays byte-equal to the
reference's ``pack_pairs``; :func:`to_device` moves a packed batch onto a
torch device.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.exact.graph import BOTTOM, Graph, pad_pair
from repro_torch.core.exact.order import matching_order


@dataclasses.dataclass
class GraphPairTensors:
    """A batch of B graph pairs, padded to N slots (host numpy arrays)."""

    qv: np.ndarray      # (B, N) int32 vertex labels of q (compact)
    gv: np.ndarray      # (B, N) int32 vertex labels of g
    qa: np.ndarray      # (B, N, N) int32 edge labels of q (0 = absent)
    ga: np.ndarray      # (B, N, N) int32 edge labels of g
    order: np.ndarray   # (B, N) int32 matching order of q (PAD slots at end)
    n: np.ndarray       # (B,) int32 true vertex count per pair
    n_vlabels: int      # Lv (real labels); BOTTOM = Lv, PAD = Lv + 1
    n_elabels: int      # Le (real labels); absent = 0

    @property
    def batch(self) -> int:
        return self.qv.shape[0]

    @property
    def slots(self) -> int:
        return self.qv.shape[1]


class DevicePairs(NamedTuple):
    """A packed batch as torch tensors on one device (int32 throughout)."""

    qv: torch.Tensor      # (B, N)
    gv: torch.Tensor      # (B, N)
    qa: torch.Tensor      # (B, N, N)
    ga: torch.Tensor      # (B, N, N)
    order: torch.Tensor   # (B, N)
    n: torch.Tensor       # (B,)
    n_vlabels: int
    n_elabels: int


def label_vocab(
    pairs: Sequence[Tuple[Graph, Graph]],
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Joint (vertex, edge) label vocabularies across a set of pairs.

    Sharing one vocabulary across several ``pack_pairs`` calls keeps
    ``n_vlabels`` / ``n_elabels`` identical between batches.
    """
    vset = sorted(
        {int(a) for q, g in pairs for a in q.vlabels if a != BOTTOM}
        | {int(a) for q, g in pairs for a in g.vlabels if a != BOTTOM}
    )
    eset = sorted(
        {int(a) for q, g in pairs for a in np.unique(q.adj) if a != 0}
        | {int(a) for q, g in pairs for a in np.unique(g.adj) if a != 0}
    )
    return tuple(vset), tuple(eset)


def pack_pairs(
    pairs: Sequence[Tuple[Graph, Graph]],
    slots: int | None = None,
    vocab: Tuple[Sequence[int], Sequence[int]] | None = None,
) -> GraphPairTensors:
    """Pad, relabel and stack a list of (q, g) pairs into batch arrays.

    ``vocab`` — optional ``(vertex_labels, edge_labels)`` from
    :func:`label_vocab`; when given it must cover every label in the batch
    and is used verbatim so batches packed with the same vocab share the
    compact label space.
    """
    padded: List[Tuple[Graph, Graph]] = []
    for q, g in pairs:
        qp, gp, _ = pad_pair(q, g)
        padded.append((qp, gp))

    # Joint compact label maps across the batch (or the caller's vocab).
    if vocab is not None:
        vset, eset = sorted(int(a) for a in vocab[0]), sorted(int(a) for a in vocab[1])
        observed_v, observed_e = label_vocab(padded)
        missing = (set(observed_v) - set(vset)) | (set(observed_e) - set(eset))
        if missing:
            raise ValueError(f"vocab does not cover batch labels: {sorted(missing)}")
    else:
        vset, eset = (list(s) for s in label_vocab(padded))
    vmap = {a: i for i, a in enumerate(vset)}
    emap = {a: i + 1 for i, a in enumerate(eset)}
    emap[0] = 0
    lv, le = len(vset), len(eset)
    bottom, pad = lv, lv + 1

    nmax = max(gp.n for _, gp in padded)
    if slots is None:
        slots = max(4, int(2 ** np.ceil(np.log2(max(nmax, 1)))))
    if nmax > slots:
        raise ValueError(f"pair with {nmax} vertices does not fit {slots} slots")

    B = len(padded)
    qv = np.full((B, slots), pad, dtype=np.int32)
    gv = np.full((B, slots), pad, dtype=np.int32)
    qa = np.zeros((B, slots, slots), dtype=np.int32)
    ga = np.zeros((B, slots, slots), dtype=np.int32)
    order = np.zeros((B, slots), dtype=np.int32)
    ns = np.zeros((B,), dtype=np.int32)

    for b, (qp, gp) in enumerate(padded):
        n = gp.n
        ns[b] = n
        qv[b, :n] = [bottom if int(a) == BOTTOM else vmap[int(a)] for a in qp.vlabels]
        gv[b, :n] = [bottom if int(a) == BOTTOM else vmap[int(a)] for a in gp.vlabels]
        qa[b, :n, :n] = np.vectorize(lambda a: emap[int(a)])(qp.adj)
        ga[b, :n, :n] = np.vectorize(lambda a: emap[int(a)])(gp.adj)
        ordv = matching_order(qp, gp)
        order[b, :n] = ordv
        order[b, n:] = np.arange(n, slots)  # PAD positions map to themselves

    return GraphPairTensors(qv, gv, qa, ga, order, ns, lv, le)


def from_reference(ref_packed) -> GraphPairTensors:
    """The port's packed batch from any object with the reference
    ``GraphPairTensors`` fields (numpy arrays or array-likes).

    Lets a test feed both engines the identical packed input.
    """
    def arr(name, ndim):
        a = np.asarray(getattr(ref_packed, name), dtype=np.int32)
        if a.ndim != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got {a.shape}")
        return a

    return GraphPairTensors(
        arr("qv", 2), arr("gv", 2), arr("qa", 3), arr("ga", 3),
        arr("order", 2), arr("n", 1),
        int(ref_packed.n_vlabels), int(ref_packed.n_elabels))


def to_device(packed: GraphPairTensors, device) -> DevicePairs:
    """Move a packed batch onto ``device`` as int32 tensors."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return DevicePairs(t(packed.qv), t(packed.gv), t(packed.qa), t(packed.ga),
                       t(packed.order), t(packed.n),
                       int(packed.n_vlabels), int(packed.n_elabels))
