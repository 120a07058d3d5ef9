"""``ged.CandidateIndex`` — the sublinear stage −1 of the search pipeline.

The counterpart of ``repro/ged/index.py``, with the same probes, band
tables, seeded permutations and pivot bounds.  Every other stage a
:class:`repro_torch.ged.GraphStore` runs is O(|DB|) per query; this index
generates candidates in (near-)sublinear time and hands the rest of the
pipeline only the survivors.  Two pruning families compose:

**Banded WL-sketch LSH.**  Every corpus graph gets an integer sketch
(:func:`repro_torch.ged.exec.wl_signature`; the corpus side is built on
the executor's device by :func:`repro_torch.ged.exec.batch_signatures`).
One unit edit moves a sketch's L1 norm by at most a *damage factor*
(:func:`sketch_damage`; 2 at the default depth-0 sketch).  ``exact``
mode (the default) stays **sound** by widening bands from that bound: if
``GED(q, g) <= tau`` the sketches differ by at most ``budget = damage *
tau`` in L1, so splitting the sketch into ``budget + 1`` bands
pigeonholes at least one band into exact equality.  Independent shuffled
band partitions (``reps``) are intersected.  Probabilistic mode
(``recall=r``) keeps only ``ceil(r * (budget + 1))`` bands and its
rejections come back uncertified.  Colliding candidates are
post-filtered by the full-sketch bound ``ceil(L1 / damage) > tau``.

**Distance-reuse pivot pruning.**  GED is a metric, so for any pivot
``p``, ``|GED(q, p) - GED(p, y)| <= GED(q, y)``.  DB–DB distances live in
the engine's :class:`~repro_torch.ged.exec.ResultCache` (read back with
:meth:`repro_torch.ged.GedEngine.cached_distance`), seeded at ingest
(``pivot_seeds``) and grown by query traffic.

Band tables and probes are host numpy, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.exact.graph import Graph
from repro_torch.ged.exec import (DIGESTS, Executor, SketchSpec,
                                  batch_signatures, wl_signature)

__all__ = ["CandidateIndex", "sketch_damage"]


def sketch_damage(spec: SketchSpec, max_degree: int = 0) -> float:
    """Max L1 movement of a :func:`~repro_torch.ged.exec.wl_signature` sketch
    under one unit edit operation — the admissibility constant behind
    every bound the index certifies.

    At ``wl_iters=0`` the sketch is a plain (hashed) label histogram plus
    ``(n, m)``: a vertex relabel moves one unit between two vertex bins
    (2), an edge insert/delete touches one edge bin plus ``m`` (2), an
    edge relabel two edge bins (2), a vertex insert/delete one vertex bin
    plus ``n`` (2) — so the damage is 2 regardless of structure.

    At depth ``r >= 1`` an edit can recolor every vertex whose ``r``-hop
    ball sees it, so the factor grows with the degree bound ``max_degree``
    (callers pass the corpus/query max degree plus tau, covering every
    intermediate graph along an optimal edit path): a relabel recolors at
    most ``B_r`` vertices (ball volume), an edge edit at most ``2 B_{r-1}``
    plus its edge-part damage.

    >>> sketch_damage(SketchSpec())                    # depth 0
    2.0
    >>> sketch_damage(SketchSpec(wl_iters=1), max_degree=3)
    8.0
    """
    r = spec.wl_iters
    if r == 0:
        return 2.0
    d = max(int(max_degree), 1)

    def ball(k: int) -> int:
        return sum(d ** i for i in range(k + 1))

    return float(max(2 * ball(r), 4 * ball(r - 1) + 2))


class CandidateIndex:
    """Banded WL-sketch LSH + pivot pruning over an ingested corpus.

    Parameters
    ----------
    graphs : the store's corpus (full list; ``ids`` selects the indexed
        representatives).
    ids : corpus positions to index — the store passes its dedup
        representatives.
    executor : the :class:`~repro_torch.ged.exec.Executor` whose device
        builds the signatures (default: a new one on the card).
    dims_v / dims_e / wl_iters : sketch shape
        (:class:`~repro_torch.ged.exec.SketchSpec`).
    reps : independent shuffled band partitions; candidates must collide
        in *every* rep (each rep is sound on its own, so the intersection
        is too).
    recall : ``None`` (default) = exact mode — band count comes from the
        admissible pigeonhole bound and a probe can never drop a graph
        within tau.  A float in (0, 1] opts out of exactness: only
        ``ceil(recall * (budget + 1))`` bands are probed and rejections
        are uncertified.  ``recall=1.0`` coincides with exact mode.
    max_pivots / pivot_seeds / pivot_coverage : distance-reuse knobs —
        how many pivots a probe consults, how many pivots to seed
        eagerly at ingest, and how many sketch-nearest neighbors each
        seeded pivot pre-computes distances to (through the engine, into
        its result cache).
    pivot_min_candidates : skip pivot probing (and its engine calls)
        when fewer candidates than this survive the sketch — the
        triangle bound can't pay for its ``GED(q, p)`` computations on a
        handful of survivors.
    seed : RNG seed for the band shuffles and pivot selection.
    sigs / max_deg : restored state of a persisted store
        (:mod:`repro_torch.store_io.graphstore_io`): no signature build
        runs.

    >>> from repro_torch.ged.plan import as_graph
    >>> corpus = [as_graph(([0, 1], [(0, 1, 1)])), as_graph(([5, 5], []))]
    >>> idx = CandidateIndex(corpus, [0, 1], executor=Executor(device="cpu"))
    >>> sorted(idx.probe(as_graph(([0, 1], [(0, 1, 1)])), tau=0.0))
    [0]
    """

    def __init__(self, graphs: Sequence[Graph], ids: Sequence[int], *,
                 executor: Optional[Executor] = None,
                 dims_v: int = 64, dims_e: int = 16, wl_iters: int = 0,
                 reps: int = 2, recall: Optional[float] = None,
                 max_pivots: int = 4, pivot_seeds: int = 0,
                 pivot_coverage: int = 32, pivot_min_candidates: int = 8,
                 seed: int = 7, sigs: Optional[np.ndarray] = None,
                 max_deg: Optional[int] = None):
        if recall is not None and not 0.0 < recall <= 1.0:
            raise ValueError(f"recall must be in (0, 1], got {recall!r}")
        if reps < 1:
            raise ValueError("reps must be >= 1")
        self.spec = SketchSpec(dims_v=int(dims_v), dims_e=int(dims_e),
                               wl_iters=int(wl_iters))
        self.recall = None if recall is None else float(recall)
        self.reps = int(reps)
        self.max_pivots = int(max_pivots)
        self.pivot_seeds = int(pivot_seeds)
        self.pivot_coverage = int(pivot_coverage)
        self.pivot_min_candidates = int(pivot_min_candidates)
        self.seed = int(seed)
        self._graphs = graphs
        self.ids: List[int] = [int(i) for i in ids]
        self._pos_of: Dict[int, int] = {g: i for i, g in enumerate(self.ids)}
        self.stats: Dict[str, float] = {
            "probes": 0, "probe_candidates": 0, "probe_fallbacks": 0,
            "tables_built": 0, "pivot_queries": 0, "pivot_lookups": 0,
            "pivots": 0, "seeded_pairs": 0, "nearest_calls": 0,
            "signatures_built": 0,
        }
        if sigs is not None:
            # restored from a persisted store (repro_torch.store_io): the
            # signature matrix comes off disk — possibly mmap-backed —
            # so no device build runs; band tables rebuild lazily from
            # it, bit-identical (they are a deterministic function of
            # sigs + the seeded permutations)
            sigs = np.asarray(sigs)
            if sigs.shape != (len(self.ids), self.spec.dims):
                raise ValueError(
                    f"restored sigs shape {sigs.shape} does not match "
                    f"({len(self.ids)}, {self.spec.dims})")
            self.sigs = sigs
        else:
            self.sigs = batch_signatures([graphs[i] for i in self.ids],
                                         self.spec, executor)
            self.stats["signatures_built"] += len(self.ids)
        if max_deg is not None:
            self._max_deg = int(max_deg)
        else:
            self._max_deg = max(
                (int(graphs[i].degrees().max()) for i in self.ids
                 if graphs[i].n), default=0)
        rng = np.random.default_rng(self.seed)
        self._perms = [rng.permutation(self.spec.dims)
                       for _ in range(self.reps)]
        self._rng = rng
        # band tables built lazily per (rep, band count) on probe traffic
        self._tables: Dict[Tuple[int, int], List[Dict[bytes, np.ndarray]]] \
            = {}
        # pivots in insertion order (most recent consulted first); their
        # distances live in the *engine's* result cache, nowhere else
        self._pivots: Dict[int, None] = {}
        self._engine = None
        self._digests: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self.ids)

    def extend(self, graphs: Sequence[Graph], new_ids: Sequence[int],
               executor: Optional[Executor] = None) -> None:
        """Incrementally index ``new_ids``: build signatures for the new
        rows only, append them to the resident matrix, and invalidate
        the lazily-built band tables (they rebuild on the next probe
        from the merged matrix — deterministic, so probes after an
        ``extend`` match a from-scratch build over the same ids)."""
        new_ids = [int(i) for i in new_ids]
        if not new_ids:
            return
        new_sigs = batch_signatures([graphs[i] for i in new_ids],
                                    self.spec, executor)
        self.stats["signatures_built"] += len(new_ids)
        self.sigs = np.concatenate([np.asarray(self.sigs), new_sigs]) \
            if len(self.sigs) else new_sigs
        for gid in new_ids:
            self._pos_of[gid] = len(self.ids)
            self.ids.append(gid)
        self._tables.clear()
        deg = max((int(graphs[i].degrees().max()) for i in new_ids
                   if graphs[i].n), default=0)
        self._max_deg = max(self._max_deg, deg)

    @property
    def exact(self) -> bool:
        """True when probes are sound (no ``recall`` opt-out)."""
        return self.recall is None

    # ------------------------------------------------------------- probe

    def damage(self, query: Optional[Graph] = None,
               tau: float = 0.0) -> float:
        """Per-edit sketch damage for this corpus + ``query`` at ``tau``
        (degree bound covers intermediate graphs along the edit path)."""
        deg = self._max_deg
        if query is not None and query.n:
            deg = max(deg, int(query.degrees().max()))
        return sketch_damage(self.spec, deg + int(math.ceil(tau)))

    def probe(self, query: Graph, tau: float) -> Dict[int, float]:
        """Stage −1 candidate generation: surviving corpus ids with their
        admissible sketch lower bounds.

        In exact mode the result is a *superset* of every indexed graph
        within ``tau`` of ``query`` (pigeonhole over ``budget + 1`` bands;
        see the module docstring) — ids absent from the dict are proven
        to satisfy ``GED > tau``.  In probabilistic mode absence is only
        probable.  Either way, present ids carry
        ``lb = ceil(L1 / damage) <= tau``, a certified bound the caller
        may reuse against smaller per-job taus.
        """
        self.stats["probes"] += 1
        n_reps = len(self.sigs)
        if not n_reps:
            return {}
        sig = wl_signature(query, self.spec)
        damage = self.damage(query, tau)
        budget = int(math.floor(damage * float(tau) + 1e-9))
        need = budget + 1
        if need > self.spec.dims:
            # more bands than dims: banding cannot certify anything, so
            # fall back to the linear (still vectorized) sketch scan —
            # sound, just not sublinear at this tau/damage combination
            self.stats["probe_fallbacks"] += 1
            mask = np.ones(n_reps, dtype=bool)
        else:
            bands = need if self.recall is None \
                else max(1, int(math.ceil(self.recall * need)))
            mask = np.ones(n_reps, dtype=bool)
            for ri in range(self.reps):
                table = self._table(ri, bands)
                hit = np.zeros(n_reps, dtype=bool)
                for band, cols in zip(table,
                                      np.array_split(self._perms[ri],
                                                     bands)):
                    rows = band.get(
                        np.ascontiguousarray(sig[cols]).tobytes())
                    if rows is not None:
                        hit[rows] = True
                mask &= hit
                if not mask.any():
                    break
        cand = np.nonzero(mask)[0]
        if not len(cand):
            return {}
        l1 = np.abs(self.sigs[cand] - sig[None, :]).sum(axis=1)
        lb = np.ceil(l1 / damage - 1e-9)
        keep = lb <= float(tau) + 1e-9
        self.stats["probe_candidates"] += int(keep.sum())
        return {self.ids[int(i)]: float(b)
                for i, b in zip(cand[keep], lb[keep])}

    def nearest(self, query: Graph, limit: int) -> List[int]:
        """Corpus ids ordered by full-sketch L1 distance to ``query`` —
        the seed list a top-k walk verifies first to warm its k-th-best
        cutoff.  A linear (vectorized) pass over the resident signature
        matrix: candidate *ordering* needs no banding, and the caller's
        exactness never depends on it."""
        self.stats["nearest_calls"] += 1
        if not len(self.sigs):
            return []
        sig = wl_signature(query, self.spec)
        l1 = np.abs(self.sigs - sig[None, :]).sum(axis=1)
        order = np.argsort(l1, kind="stable")[:max(int(limit), 0)]
        return [self.ids[int(i)] for i in order]

    # ------------------------------------------------------------ pivots

    def bind_engine(self, engine, digests: Optional[Dict[int, bytes]] = None
                    ) -> None:
        """Attach the engine whose :class:`~repro_torch.ged.exec.ResultCache`
        holds (and will keep accumulating) the DB–DB distances pivots
        prune with.  ``digests`` pre-seeds the per-id digest memo (the
        store passes its ingest-time exact digests, so pivot lookups
        never re-hash the corpus)."""
        self._engine = engine
        if digests:
            self._digests.update(digests)

    def note_pivot(self, rep_id: int) -> None:
        """Mark a corpus representative as a pivot — called by the store
        whenever a query turns out to be a corpus member, because that
        query's computed distances are now cache-resident and reusable."""
        if rep_id in self._pos_of and rep_id not in self._pivots:
            self._pivots[rep_id] = None
            self.stats["pivots"] = len(self._pivots)

    def seed_pivots(self, vocab=None) -> int:
        """Eager ingest-time pivot seeding: pick ``pivot_seeds`` spread-out
        representatives (greedy k-center on sketch L1) and compute each
        one's distance to its ``pivot_coverage`` sketch-nearest neighbors
        through the engine — the outcomes land in the engine's result
        cache, which *is* the index's distance store.  Returns the number
        of seeded DB–DB pairs; a cache-less engine seeds nothing."""
        if (self._engine is None or self._engine._cache is None
                or self.pivot_seeds <= 0 or len(self.sigs) < 2):
            return 0
        chosen: List[int] = [0]
        dist = np.abs(self.sigs - self.sigs[0][None, :]).sum(axis=1)
        while len(chosen) < min(self.pivot_seeds, len(self.sigs)):
            far = int(np.argmax(dist))
            if dist[far] <= 0:
                break
            chosen.append(far)
            dist = np.minimum(
                dist, np.abs(self.sigs - self.sigs[far][None, :])
                .sum(axis=1))
        seeded = 0
        for pos in chosen:
            l1 = np.abs(self.sigs - self.sigs[pos][None, :]).sum(axis=1)
            order = np.argsort(l1, kind="stable")
            near = [int(i) for i in order[:self.pivot_coverage + 1]
                    if int(i) != pos][:self.pivot_coverage]
            if near:
                p = self.ids[pos]
                self._engine.compute(
                    [(self._graphs[p], self._graphs[self.ids[i]])
                     for i in near], vocab=vocab)
                seeded += len(near)
            self.note_pivot(self.ids[pos])
        self.stats["seeded_pairs"] += seeded
        return seeded

    @property
    def use_pivots(self) -> bool:
        """Pivot pruning can run: an engine with a cache is bound, and at
        least one pivot exists."""
        return (self._engine is not None
                and self._engine._cache is not None
                and self.max_pivots > 0 and bool(self._pivots))

    def pivot_bounds(self, query: Graph, rep_ids: Sequence[int],
                     vocab=None) -> Dict[int, float]:
        """Certified triangle lower bounds ``|d(q,p) - d(p,y)|`` for the
        candidates in ``rep_ids``, via cached DB–DB distances.

        Computes ``GED(q, p)`` for up to ``max_pivots`` pivots (one
        engine batch — itself cached, so repeated queries pay nothing)
        and reads ``GED(p, y)`` back from the engine's result cache.
        Candidates with no cache-covered pivot simply get no bound; the
        returned dict only contains ids with a non-trivial bound.
        """
        if not self.use_pivots or len(rep_ids) < self.pivot_min_candidates:
            return {}
        pivots = list(self._pivots)[-self.max_pivots:]
        self.stats["pivot_queries"] += len(pivots)
        outs = self._engine.compute(
            [(query, self._graphs[p]) for p in pivots], vocab=vocab)
        dq = {p: float(o.ged) for p, o in zip(pivots, outs)
              if o.certified and o.ged is not None}
        if not dq:
            return {}
        bounds: Dict[int, float] = {}
        for y in rep_ids:
            dy = self._digest_of(y)
            best = 0.0
            for p, d in dq.items():
                if p == y:
                    continue
                self.stats["pivot_lookups"] += 1
                dpy = self._engine.cached_distance(
                    digests=(self._digest_of(p), dy))
                if dpy is not None:
                    best = max(best, abs(d - dpy))
            if best > 0.0:
                bounds[y] = best
        return bounds

    # ---------------------------------------------------------- internal

    def _digest_of(self, rep_id: int) -> bytes:
        d = self._digests.get(rep_id)
        if d is None:
            fn = DIGESTS[self._engine.digest if self._engine is not None
                         else "exact"]
            d = fn(self._graphs[rep_id])
            self._digests[rep_id] = d
        return d

    def _table(self, rep_idx: int, bands: int
               ) -> List[Dict[bytes, np.ndarray]]:
        key = (rep_idx, int(bands))
        table = self._tables.get(key)
        if table is None:
            table = self._build_table(rep_idx, int(bands))
            self._tables[key] = table
        return table

    def _build_table(self, rep_idx: int, bands: int
                     ) -> List[Dict[bytes, np.ndarray]]:
        """One banded hash table: for each band (a shuffled column slice
        of the signature matrix), group identical rows via a single
        ``np.unique(axis=0)`` sort — O(R log R) per band, no Python-level
        row hashing."""
        self.stats["tables_built"] += 1
        out: List[Dict[bytes, np.ndarray]] = []
        for cols in np.array_split(self._perms[rep_idx], bands):
            sub = np.ascontiguousarray(self.sigs[:, cols])
            uq, inv = np.unique(sub, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            order = np.argsort(inv, kind="stable")
            splits = np.searchsorted(inv[order], np.arange(1, len(uq)))
            groups = np.split(order, splits)
            out.append({np.ascontiguousarray(uq[k]).tobytes(): grp
                        for k, grp in enumerate(groups)})
        return out
