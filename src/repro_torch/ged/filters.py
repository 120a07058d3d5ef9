"""The filter half of the corpus filter-verify pipeline.

:class:`FilterIndex` is what a :class:`repro_torch.ged.GraphStore` builds
at ingest time: corpus graphs grouped per slot bucket, their stage-0
features (:mod:`repro_torch.core.engine.corpus`) packed once and kept
resident on the executor's device, and one vectorized scan per bucket
that scores a query against the whole bucket with sound lower bounds.  A
scan uploads only the query's feature row; the reference re-uploads the
bucket's arrays on every scan.  The counterpart of
``repro/ged/filters.py``; the reference's ``shard_map`` branch waits for
the port's ``ShardedExecutor``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import corpus
from repro_torch.core.engine.corpus import (CorpusFeatures, graph_features,
                                            stage0_lower_bounds)
from repro_torch.core.exact.graph import Graph
from repro_torch.ged.exec import Executor
from repro_torch.ged.plan import Vocab, slot_bucket


@dataclasses.dataclass
class FeatureBucket:
    """One slot bucket of the corpus: ids, host feature arrays (possibly
    mmap-backed after a warm open) and their copies on the device."""

    slots: int
    ids: List[int]                      # corpus positions, ingest order
    features: CorpusFeatures
    resident: Tuple[torch.Tensor, ...]  # the features' arrays on device


class FilterIndex:
    """Stage-0 scan over an ingested corpus.

    >>> from repro_torch.ged.plan import as_graph, graphs_vocab
    >>> corpus = [as_graph(([0, 1], [(0, 1, 1)])), as_graph(([5], []))]
    >>> idx = FilterIndex(corpus, list(range(2)), graphs_vocab(corpus),
    ...                   Executor(device="cpu"))
    >>> lbs = idx.scan(as_graph(([0, 1], [(0, 1, 1)])))
    >>> float(lbs[0]), bool(lbs[1] >= 2.0)   # identical graph; far singleton
    (0.0, True)
    """

    def __init__(self, graphs: Sequence[Graph], ids: Sequence[int],
                 vocab: Vocab, executor: Optional[Executor] = None,
                 features: Optional[Dict[int, Tuple[Sequence[int],
                                                    CorpusFeatures]]] = None):
        self.vocab = vocab
        self.executor = executor or Executor()
        self.buckets: List[FeatureBucket] = []
        self._shapes: Set[tuple] = set()
        self.stats: Dict[str, float] = {"scans": 0, "scanned": 0,
                                        "subset_scans": 0, "packed_rows": 0}
        if features is None:
            by_slots: Dict[int, List[int]] = {}
            for gid in ids:
                by_slots.setdefault(slot_bucket(graphs[gid].n),
                                    []).append(gid)
            for s in sorted(by_slots):
                bids = by_slots[s]
                feats = graph_features([graphs[i] for i in bids], vocab,
                                       width=s)
                self.stats["packed_rows"] += feats.batch
                self.buckets.append(self._bucket(s, bids, feats))
        else:
            # warm open: per-bucket arrays come off disk (mmap-backed, see
            # repro_torch.store_io.graphstore_io), so no feature packing
            # runs; copying them to the device once is the only work
            for s in sorted(features):
                bids, feats = features[s]
                self.buckets.append(self._bucket(int(s), list(bids), feats))
        self._reindex()

    def _bucket(self, slots: int, bids: List[int],
                feats: CorpusFeatures) -> FeatureBucket:
        dev = self.executor.device
        resident = tuple(torch.from_numpy(np.array(a, dtype=np.float32))
                         .to(dev) for a in feats.arrays())
        return FeatureBucket(slots, bids, feats, resident)

    def _reindex(self) -> None:
        # id order the scan output follows (bucket construction order)
        self.ids: List[int] = [gid for b in self.buckets for gid in b.ids]
        # id -> (bucket index, row within bucket), for subset gathers
        self._where: Dict[int, Tuple[int, int]] = {
            gid: (bi, ri) for bi, b in enumerate(self.buckets)
            for ri, gid in enumerate(b.ids)}

    def extend(self, graphs: Sequence[Graph], new_ids: Sequence[int]
               ) -> None:
        """Incrementally index ``new_ids``: pack only the new rows and
        append them to their slot buckets (creating buckets as needed) —
        the store's ``add()`` path, no full re-pack."""
        by_slots: Dict[int, List[int]] = {}
        for gid in new_ids:
            by_slots.setdefault(slot_bucket(graphs[gid].n), []).append(gid)
        at = {b.slots: bi for bi, b in enumerate(self.buckets)}
        for s in sorted(by_slots):
            bids = by_slots[s]
            feats = graph_features([graphs[i] for i in bids], self.vocab,
                                   width=s)
            self.stats["packed_rows"] += feats.batch
            bi = at.get(s)
            if bi is None:
                self.buckets.append(self._bucket(s, bids, feats))
                self.buckets.sort(key=lambda b: b.slots)
            else:
                old = self.buckets[bi]
                merged = CorpusFeatures(
                    *(np.concatenate([np.asarray(a), b]) for a, b in zip(
                        old.features.arrays(), feats.arrays())))
                self.buckets[bi] = self._bucket(s, old.ids + bids, merged)
        self._reindex()

    def __len__(self) -> int:
        return len(self.ids)

    # ------------------------------------------------------------- scan

    def scan(self, query: Graph) -> np.ndarray:
        """Stage-0 lower bound of ``delta(query, g)`` for every indexed id.

        Returns an array aligned with :attr:`ids` (bucket construction
        order): one vectorized pass per bucket over its resident
        features, the degree width the max of the bucket's slots and the
        query's slot bucket.
        """
        self.stats["scans"] += 1
        parts = []
        for b in self.buckets:
            parts.append(self._dispatch(query, b.resident, b.slots))
            self.stats["scanned"] += len(b.ids)
        return np.concatenate(parts) if parts \
            else np.zeros(0, dtype=np.float32)

    def scan_by_id(self, query: Graph) -> Dict[int, float]:
        """:meth:`scan` keyed by corpus id instead of position."""
        return dict(zip(self.ids, self.scan(query).tolist()))

    def scan_subset(self, query: Graph, ids: Sequence[int]
                    ) -> Dict[int, float]:
        """Stage-0 lower bounds for ``ids`` only — the scan a store runs
        after a candidate index already pruned the rest of the corpus.

        The requested rows are gathered out of the resident per-bucket
        feature tensors on the device and scored like a full bucket.
        ``stats["scanned"]`` counts the *requested* rows, which is what
        makes the store's funnel ratios honest about index savings.
        """
        self.stats["scans"] += 1
        self.stats["subset_scans"] += 1
        out: Dict[int, float] = {}
        by_bucket: Dict[int, List[int]] = {}
        for gid in ids:
            by_bucket.setdefault(self._where[gid][0], []).append(gid)
        for bi in sorted(by_bucket):
            b = self.buckets[bi]
            gids = by_bucket[bi]
            rows = torch.as_tensor([self._where[g][1] for g in gids],
                                   dtype=torch.int64,
                                   device=self.executor.device)
            feats = tuple(a.index_select(0, rows) for a in b.resident)
            vals = self._dispatch(query, feats, b.slots)
            self.stats["scanned"] += len(gids)
            out.update(zip(gids, vals.tolist()))
        return out

    # --------------------------------------------------------- internal

    def _dispatch(self, query: Graph, cf: Tuple[torch.Tensor, ...],
                  slots: int) -> np.ndarray:
        """Score ``query`` against one bucket's device tensors; host f32."""
        cvh, ceh, cdeg, cn, cm = cf
        width = max(slots, slot_bucket(query.n))
        shape = (slots, cvh.shape[0], width, cvh.shape[1], ceh.shape[1])
        if shape not in self._shapes:
            self._shapes.add(shape)
            corpus.note_scan_shape()
        qf = graph_features([query], self.vocab, width=width)
        dev = self.executor.device
        q = [torch.as_tensor(a[0], device=dev) for a in qf.arrays()]
        if width > cdeg.shape[1]:
            cdeg = F.pad(cdeg, (0, width - cdeg.shape[1]))
        return stage0_lower_bounds(*q, cvh, ceh, cdeg, cn, cm).cpu().numpy()
