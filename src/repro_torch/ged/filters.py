"""The filter half of the corpus filter-verify pipeline.

:class:`FilterIndex` is what a :class:`repro_torch.ged.GraphStore` builds
at ingest time: corpus graphs grouped per slot bucket, their stage-0
features (:mod:`repro_torch.core.engine.corpus`) packed once and kept
resident on the executor's device, and one vectorized scan per bucket
that scores a query against the whole bucket with sound lower bounds.  A
scan uploads only the query's feature row; the reference re-uploads the
bucket's arrays on every scan.  The counterpart of
``repro/ged/filters.py``.

On a :class:`~repro_torch.ged.exec.ShardedExecutor` each bucket's rows
are split into one contiguous slice per pair shard of the mesh, each
resident on its device and padded to one length (the resident rows are a
multiple of the shard count; the host arrays stay whole and unpadded,
since persistence and ``packed_rows`` read them); a scan copies the
query's row to every device and gathers the bounds in row order, so
``GraphStore(mesh=...)`` splits the stage-0 scan as it splits
verification batches, as the reference ``shard_map``s its scan.  On a
``torch.distributed`` mesh a rank holds only its own shard's slice
(:meth:`~repro_torch.ged.exec.Executor.local_rows`) on its card, scores
it, and one gather a scan
(:meth:`~repro_torch.ged.exec.Executor.gather_shards`) hands every rank
all the bounds; every rank enters it, also one whose slice holds none
of the requested rows.
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
    mmap-backed after a warm open) and the rows this process holds on its
    devices, one contiguous slice a device, each padded to the length
    every shard of the mesh has."""

    slots: int
    ids: List[int]                      # corpus positions, ingest order
    features: CorpusFeatures
    shards: List[Tuple[torch.Tensor, ...]]  # per local device, in order
    first: int = 0                      # mesh shard of shards[0]

    @property
    def resident(self) -> Tuple[torch.Tensor, ...]:
        """Every resident feature tensor, shard after shard."""
        return tuple(t for shard in self.shards for t in shard)


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
        """Put this process's rows of the bucket on the executor's
        devices, one contiguous slice each, every slice of the mesh
        padded to one length (the filler repeats the last row; nothing
        on one device)."""
        devices = self.executor.devices
        lo, hi = self.executor.local_rows(feats.batch)
        size = (hi - lo) // len(devices)
        take = np.minimum(np.arange(lo, hi), max(feats.batch - 1, 0))
        shards = [tuple(torch.from_numpy(np.asarray(
                      a[take[i * size:(i + 1) * size]], dtype=np.float32))
                        .to(d) for a in feats.arrays())
                  for i, d in enumerate(devices)]
        return FeatureBucket(slots, bids, feats, shards,
                             lo // size if size else 0)

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
        parts = self.executor.gather_shards(lambda: [
            self._scan_shards(query, b.shards, b.slots)
            for b in self.buckets])
        out = []
        for bi, b in enumerate(self.buckets):
            out.append(np.concatenate([p[bi] for p in parts])[:len(b.ids)])
            self.stats["scanned"] += len(b.ids)
        return np.concatenate(out) if out \
            else np.zeros(0, dtype=np.float32)

    def scan_by_id(self, query: Graph) -> Dict[int, float]:
        """:meth:`scan` keyed by corpus id instead of position."""
        return dict(zip(self.ids, self.scan(query).tolist()))

    def scan_subset(self, query: Graph, ids: Sequence[int]
                    ) -> Dict[int, float]:
        """Stage-0 lower bounds for ``ids`` only — the scan a store runs
        after a candidate index already pruned the rest of the corpus.

        The requested rows are gathered out of the resident per-bucket
        feature tensors on the devices that hold them and scored like a
        full bucket.  ``stats["scanned"]`` counts the *requested* rows,
        which is what makes the store's funnel ratios honest about index
        savings.
        """
        self.stats["scans"] += 1
        self.stats["subset_scans"] += 1
        out: Dict[int, float] = {}
        by_bucket: Dict[int, List[int]] = {}
        for gid in ids:
            by_bucket.setdefault(self._where[gid][0], []).append(gid)
        buckets = sorted(by_bucket)
        # per bucket, the requested positions in mesh shard order, and the
        # (slice of this process, row in it) of the ones it holds
        order: List[List[int]] = []
        picks: List[List[Tuple[int, int]]] = []
        for bi in buckets:
            b, gids = self.buckets[bi], by_bucket[bi]
            size = b.shards[0][0].shape[0]
            ranked = sorted(enumerate(divmod(self._where[g][1], size)
                                      for g in gids),
                            key=lambda kw: kw[1][0])
            order.append([k for k, _ in ranked])
            picks.append([(s - b.first, r) for _, (s, r) in ranked
                          if 0 <= s - b.first < len(b.shards)])

        def local() -> List[np.ndarray]:
            vals = []
            for bi, mine in zip(buckets, picks):
                b = self.buckets[bi]
                picked = []
                for si, shard in enumerate(b.shards):
                    rows = [r for s, r in mine if s == si]
                    if rows:
                        at = torch.as_tensor(rows, dtype=torch.int64,
                                             device=shard[0].device)
                        picked.append(tuple(a.index_select(0, at)
                                            for a in shard))
                vals.append(self._scan_shards(query, picked, b.slots))
            return vals

        parts = self.executor.gather_shards(local)
        for n, bi in enumerate(buckets):
            gids = by_bucket[bi]
            vals = np.empty(len(gids), dtype=np.float32)
            vals[np.asarray(order[n], dtype=np.int64)] = np.concatenate(
                [p[n] for p in parts])
            self.stats["scanned"] += len(gids)
            out.update(zip(gids, vals.tolist()))
        return out

    # --------------------------------------------------------- internal

    def _scan_shards(self, query: Graph,
                     shards: Sequence[Tuple[torch.Tensor, ...]],
                     slots: int) -> np.ndarray:
        """Score ``query`` against each shard's tensors on its own device;
        host f32 in shard order (empty without a shard).  Every shard is
        started before any is read back."""
        if not shards:
            return np.zeros(0, dtype=np.float32)
        cvh = shards[0][0]
        width = max(slots, slot_bucket(query.n))
        shape = (slots, sum(s[0].shape[0] for s in shards), width,
                 cvh.shape[1], shards[0][1].shape[1])
        if shape not in self._shapes:
            self._shapes.add(shape)
            corpus.note_scan_shape()
        qf = graph_features([query], self.vocab, width=width)
        on: Dict[torch.device, list] = {}
        outs = []
        for cvh, ceh, cdeg, cn, cm in shards:
            dev = cvh.device
            if dev not in on:
                on[dev] = [torch.as_tensor(a[0], device=dev)
                           for a in qf.arrays()]
            if width > cdeg.shape[1]:
                cdeg = F.pad(cdeg, (0, width - cdeg.shape[1]))
            outs.append(stage0_lower_bounds(*on[dev], cvh, ceh, cdeg, cn,
                                            cm))
        return np.concatenate([o.cpu().numpy() for o in outs])
