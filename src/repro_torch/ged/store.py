"""``ged.GraphStore`` — from pairs to corpora, on the card.

The counterpart of ``repro/ged/store.py``, with the same answers, stats
and on-disk format.  The paper's target workload is graph-database
similarity search: a filter phase prunes the corpus with cheap lower
bounds and only survivors reach the expensive verifier.  ``GraphStore``
is that workload's front door: ingest a corpus once (one shared label
vocabulary, per-slot-bucket feature arrays resident on the device,
per-graph canonical digests for dedup), then ask corpus-level
questions::

    store = ged.GraphStore(db_graphs)
    hits = store.range_search(query, tau=4.0)     # all g: delta(q, g) <= tau
    near = store.top_k(query, k=10)               # 10 nearest by GED
    per_q = store.search_batch(queries, tau=4.0)  # one hit list per query

Queries run a staged filter-verify pipeline:

* **stage −1** — the sublinear candidate index
  (:class:`repro_torch.ged.CandidateIndex`, on by default): banded
  WL-sketch LSH and pivot triangle bounds through the engine's result
  cache.  Exact mode (default) is sound; ``index={"recall": r}`` is the
  probabilistic opt-out; ``index=None`` disables stage −1.
* **stage 0** — label-multiset / degree-sequence / size lower bounds
  over the resident corpus features
  (:class:`repro_torch.ged.filters.FilterIndex`), restricted to stage
  −1's survivors when the index is on.  Sound: never prunes a true hit.
* **stage 1** — the anchor-aware batched engine on the survivors at a
  tiny search budget (``filter_pool`` / ``filter_iters``, ``expand=2``),
  one packed pass per slot bucket on the store's executor; with
  ``use_kernel=True`` it runs the Hopper kernels.  Pairs it certifies are
  done.
* **stage 2** — full verification of whatever remains through the
  store's :class:`~repro_torch.ged.GedEngine` (``auto`` backend by
  default, so every answer is certified).

Results come back as ranked :class:`~repro_torch.ged.results.SearchHit`
objects; ``store.stats`` (candidates per stage, filter ratio, walls) is
part of the API contract.  :meth:`GraphStore.save` /
:meth:`GraphStore.open` persist the store in the reference's format
(:mod:`repro_torch.store_io.graphstore_io`); a warm open re-packs and
re-hashes nothing.  :meth:`add` / :meth:`remove` journal mutations,
folded by :meth:`compact`.  The store runs on the card unless given
``device="cpu"`` (or a CPU ``mesh``); ``mesh=`` splits the stage-0
features, the signature build, stage 1 and stage 2 over several devices.

``mesh`` may be a ``torch.distributed`` ``DeviceMesh`` (from
:mod:`repro_torch.launch.mesh`, one process per card), used SPMD as
:class:`~repro_torch.ged.GedEngine` uses one: every rank builds the store
at the same point and calls the same methods with the same arguments in
the same order, and every ``store_dir`` it is given must be readable by
every rank.  Each rank holds only its shard's slice of the stage-0
features on its card and hashes only its shard of the signatures; the
bounds, signatures and engine rows are gathered, so every rank returns
the same hits.  The first rank alone writes snapshots and journal
entries (:meth:`~repro_torch.ged.exec.Executor.from_root`), the others
wait for it, and a write error raises on every rank; :meth:`open` reads
on every rank and takes its fallbacks on every rank or on none.  The
WL dedup checks are host work that each rank repeats.  A shared
result-cache tier is refused on such a mesh (``GedEngine``).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.exact.graph import Graph
from repro_torch.core.exact.search import ged_verify
from repro_torch.device import DeviceLike
from repro_torch.ged.api import GedEngine
from repro_torch.ged.exec import (DIGESTS, Executor, ShardedExecutor,
                                  detached, engine_outcome, graph_digest,
                                  wl_digest)
from repro_torch.ged.filters import FilterIndex
from repro_torch.ged.index import CandidateIndex
from repro_torch.ged.plan import (Plan, Vocab, as_graph, graphs_vocab,
                                  merge_vocab)
from repro_torch.ged.results import (STAGE_BOUND, STAGE_FILTER, STAGE_INDEX,
                                     STAGE_VERIFY, GedOutcome, SearchHit)

_INF = float("inf")
_ZERO16 = b"\x00" * 16


class GraphStore:
    """An ingested graph corpus with staged similarity search.

    Parameters
    ----------
    graphs : corpus in any :func:`repro_torch.ged.plan.as_graph` form.
    vocab : optional label universe; extended automatically when the
        corpus (or a query) introduces labels beyond it.
    backend / device / mesh / engine : verification engine for stage 2 —
        default a fresh ``GedEngine("auto", device=device, mesh=mesh)``
        (certified answers).  ``device`` (default: the card) also places
        the stage-0 features, the signature build and the stage-1 pass;
        ``mesh`` (a flat device sequence, a named ``DeviceMesh`` or a
        ``torch.distributed`` one, see
        :class:`~repro_torch.ged.exec.ShardedExecutor` and the module
        docstring) splits all of them over its pair shards.  Pass an
        existing ``engine=`` to share its executor and result cache —
        exclusive with ``backend``, ``mesh`` and engine keyword options
        (and with ``device`` when the engine has its own executor),
        which would otherwise be silently ignored.
    digest : ``"wl"`` (default) additionally dedups *isomorphic* corpus
        entries: WL-digest collisions are candidate groups, and every
        candidate merge is confirmed by a certified zero-distance check
        with the exact host solver at ingest (WL refinement alone is an
        incomplete isomorphism test — unconfirmed collisions stay
        separate, so search answers are never aliased).  ``"exact"`` is
        the byte-identical fallback knob, skipping WL grouping entirely.
    filter_iters / filter_pool : stage-1 engine budget (``filter_iters=0``
        disables stage 1).
    index : the stage −1 candidate index (:class:`repro_torch.ged.
        CandidateIndex`).  ``"auto"`` (default) builds one in sound exact
        mode; a dict carries its knobs (``{"recall": 0.9}`` opts into the
        probabilistic probe, ``{"pivot_seeds": 4}`` seeds distance-reuse
        pivots at ingest, ``{"wl_iters": 1}`` deepens the sketch, ...); a
        prebuilt :class:`~repro_torch.ged.CandidateIndex` over this corpus is
        used as-is; ``None`` disables stage −1 — every query then runs
        the previous full-scan pipeline bit-for-bit.
    Remaining keyword arguments go to the :class:`GedEngine` constructor
    (``cache=``, ``pool=``, ``batch_size=``, ``use_kernel=`` ...).

    Corpus ids are stable handles: :meth:`add` assigns fresh ids past
    every id ever issued and :meth:`remove` tombstones (ids are never
    reused), so persisted results, journals and shared caches stay valid
    across mutations.

    Examples
    --------
    >>> from repro_torch import ged
    >>> store = ged.GraphStore([([0, 1], [(0, 1, 1)]), ([0, 5], [])],
    ...                        backend="exact", filter_iters=0, device="cpu")
    >>> [h.graph_id for h in store.range_search(([0, 1], [(0, 1, 1)]), 0.5)]
    [0]
    >>> s = store.stats
    >>> s["candidates"], s["index_pruned"] + s["stage0_pruned"]
    (2, 1)
    >>> flat = ged.GraphStore([([0], [])], backend="exact", index=None,
    ...                       device="cpu")
    >>> flat.stats["candidates_stage_-1"]      # stage -1 never runs
    0
    >>> import tempfile                        # durable round trip
    >>> path = store.save(tempfile.mkdtemp())
    >>> warm = ged.GraphStore.open(path, backend="exact", device="cpu")
    >>> [h.graph_id for h in warm.range_search(([0, 1], [(0, 1, 1)]), 0.5)]
    [0]
    """

    def __init__(self, graphs, *, vocab: Optional[Vocab] = None,
                 backend: str = "auto", device: DeviceLike = None,
                 mesh=None, engine: Optional[GedEngine] = None,
                 digest: str = "wl", filter_iters: int = 2,
                 filter_pool: int = 32, index="auto", **engine_options):
        if digest not in DIGESTS:
            raise ValueError(f"unknown digest {digest!r}; "
                             f"expected one of {sorted(DIGESTS)}")
        self.digest = digest
        self.filter_iters = int(filter_iters)
        self.filter_pool = int(filter_pool)
        self._index_spec = self._normalize_index(index)
        self.graphs: List[Optional[Graph]] = [as_graph(g) for g in graphs]
        self._tombstones: Set[int] = set()
        self._store_dir: Optional[str] = None
        self._journal_seq = 0
        self._journal_base = 0
        self.compact_every = 64
        self._dedup_checks = 0
        self._init_engine(backend, device, mesh, engine, engine_options)
        self._init_filter_cfg()
        self._init_counts()
        t0 = time.perf_counter()
        self._ingest(range(len(self.graphs)), vocab)
        self._counts["ingest_wall_s"] += time.perf_counter() - t0
        self._n_live = len(self.graphs)

    # ------------------------------------------------------------- setup

    @staticmethod
    def _normalize_index(index):
        """``index=`` argument -> ``None`` | knob dict | prebuilt index."""
        if index is None or isinstance(index, CandidateIndex):
            return index
        if isinstance(index, dict):
            return dict(index)
        if index in ("auto", True):
            return {}
        raise ValueError(
            f"index= expects None, 'auto', a knob dict, or a "
            f"CandidateIndex; got {index!r}")

    def _init_engine(self, backend: str, device: DeviceLike, mesh,
                     engine: Optional[GedEngine],
                     engine_options: Dict) -> None:
        executor = getattr(getattr(engine, "_backend", None), "executor",
                           None)
        placed = device is not None and executor is not None
        if engine is not None and (backend != "auto" or placed
                                   or mesh is not None or engine_options):
            # a supplied engine brings its own backend, placement and
            # config — accepting these too would silently ignore them
            clash = sorted(engine_options) + \
                (["device"] if placed else []) + \
                (["mesh"] if mesh is not None else []) + \
                ([f"backend={backend!r}"] if backend != "auto" else [])
            raise TypeError(
                f"engine= is exclusive with engine construction options "
                f"(got {clash}); configure the engine you pass in")
        if engine is None:
            # The engine's result cache stays on exact digests: WL keys
            # would alias WL-equivalent non-isomorphic pairs *without*
            # the certified confirmation the store's dedup gets.
            engine = GedEngine(backend, device=device, mesh=mesh,
                               **engine_options)
            executor = getattr(engine._backend, "executor", None)
        self.engine = engine
        # the host-solver backend has no executor: the store's own one
        # places the stage-0 features, the signatures and stage 1 (on a
        # torch.distributed mesh making it is a collective, at the same
        # point on every rank)
        if executor is None:
            executor = (ShardedExecutor(mesh, device=device)
                        if mesh is not None else Executor(device))
        self.executor = executor

    def _init_filter_cfg(self) -> None:
        """The stage-1 engine budget (``None`` when stage 1 is off)."""
        self._filter_cfg = None
        if self.filter_iters:
            self._filter_cfg = dataclasses.replace(
                self.engine.config, pool=int(self.filter_pool), expand=2,
                max_iters=int(self.filter_iters))

    def _init_counts(self) -> None:
        self._counts: Dict[str, float] = {
            "queries": 0, "candidates": 0, "candidates_stage_-1": 0,
            "index_pruned": 0, "index_sketch_pruned": 0,
            "index_pivot_pruned": 0, "stage0_pruned": 0,
            "stage1_decided": 0, "stage1_accepted": 0,
            "stage2_verified": 0, "hits": 0, "topk_candidates": 0,
            "topk_verified": 0, "topk_seeded": 0, "adds": 0,
            "removals": 0, "compactions": 0, "index_wall_s": 0.0,
            "scan_wall_s": 0.0, "bound_wall_s": 0.0, "verify_wall_s": 0.0,
            "ingest_wall_s": 0.0, "vocab_wall_s": 0.0, "pack_wall_s": 0.0,
            "open_wall_s": 0.0,
        }

    def _ingest(self, present, vocab: Optional[Vocab] = None) -> None:
        """Derive everything :meth:`open` otherwise restores from disk:
        dedup groups, the shared vocabulary, the resident stage-0 feature
        buckets and the stage −1 sketch index — over ``self.graphs[i]``
        for the ids in ``present``.

        Byte-identical grouping first (always sound), then — under the
        ``"wl"`` digest — isomorphism candidates via WL collision, each
        merge *confirmed* by a certified GED == 0 check so a WL collision
        between non-isomorphic graphs can never alias answers.
        """
        present = [int(i) for i in present]
        exact_groups: Dict[bytes, List[int]] = {}
        for i in present:
            exact_groups.setdefault(graph_digest(self.graphs[i]),
                                    []).append(i)
        self._exact_of: Dict[bytes, int] = {
            d: ids[0] for d, ids in exact_groups.items()}
        groups: List[List[int]] = []
        wl_of: Dict[int, bytes] = {}
        if self.digest == "wl":
            candidates: Dict[bytes, List[List[int]]] = {}
            for ids in exact_groups.values():
                candidates.setdefault(wl_digest(self.graphs[ids[0]]),
                                      []).append(ids)
            for wd, subs in candidates.items():
                # compare against every group already formed in this WL
                # bucket (not just the first), so two isomorphic entries
                # still merge when a non-isomorphic collider sorts first
                formed: List[List[int]] = []
                for sub in subs:
                    for grp in formed:
                        self._dedup_checks += 1
                        if ged_verify(self.graphs[grp[0]],
                                      self.graphs[sub[0]], 0.0,
                                      bound="BMa").similar:
                            grp.extend(sub)
                            break
                    else:       # no confirmed match: its own group
                        formed.append(list(sub))
                for grp in formed:
                    grp = sorted(grp)
                    groups.append(grp)
                    wl_of[grp[0]] = wd
        else:
            groups.extend(exact_groups.values())
        self._members: Dict[int, List[int]] = {
            ids[0]: sorted(ids) for ids in groups}
        self._rep_of: Dict[int, int] = {
            i: rep for rep, ids in self._members.items() for i in ids}
        self._wl_of: Dict[int, bytes] = wl_of
        self._wl_reps: Dict[bytes, List[int]] = {}
        for rep, wd in wl_of.items():
            self._wl_reps.setdefault(wd, []).append(rep)
        self._rep_ids: List[int] = sorted(
            rep for rep, ids in self._members.items()
            if any(i not in self._tombstones for i in ids))

        t0 = time.perf_counter()
        live = [self.graphs[i] for i in present]
        self.vocab: Vocab = (merge_vocab(vocab, live) if vocab
                             else graphs_vocab(live))
        self._counts["vocab_wall_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._index = FilterIndex(self.graphs, self._rep_ids, self.vocab,
                                  self.executor)
        spec = self._index_spec
        if spec is None:
            self._cindex: Optional[CandidateIndex] = None
        elif isinstance(spec, CandidateIndex):
            self._cindex = spec
        else:
            self._cindex = CandidateIndex(
                self.graphs, self._rep_ids, executor=self.executor, **spec)
        self._counts["pack_wall_s"] += time.perf_counter() - t0
        self._bind_index()
        if self._cindex is not None:
            self._cindex.seed_pivots(vocab=self.vocab)

    def _bind_index(self, digests: Optional[Dict[int, bytes]] = None
                    ) -> None:
        if self._cindex is None:
            return
        if digests is None:
            # pivot lookups reuse the store's ingest-time exact digests
            # when the engine caches on them — no per-probe re-hashing
            digests = ({rid: d for d, rid in self._exact_of.items()
                        if rid in self._members}
                       if self.engine.digest == "exact" else None)
        self._cindex.bind_engine(self.engine, digests)

    def __len__(self) -> int:
        return self._n_live

    def member_id(self, graph) -> Optional[int]:
        """Corpus id of a *live, byte-identical* ingested graph, or
        ``None``.

        Deliberately exact (not WL): request routing must never match a
        merely WL-equivalent graph, whose true distance could differ.
        """
        return self._exact_of.get(graph_digest(as_graph(graph)))

    # ------------------------------------------------------- persistence

    def save(self, store_dir) -> str:
        """Write a durable, compacted snapshot and attach the store to
        ``store_dir`` (subsequent :meth:`add` / :meth:`remove` journal
        there).  Checksummed ``.npy`` segments plus an atomic manifest —
        a crash mid-save leaves any previous snapshot fully readable.
        Returns ``store_dir``.
        """
        from repro_torch.store_io import graphstore_io
        store_dir = str(store_dir)
        self.executor.from_root(
            lambda: graphstore_io.save_store(self, store_dir))
        self._store_dir = store_dir
        self._journal_base = self._journal_seq
        return store_dir

    def compact(self) -> None:
        """Fold the journal into a fresh snapshot generation (also runs
        automatically every ``compact_every`` journal entries)."""
        if self._store_dir is None:
            raise RuntimeError(
                "store is not attached to a directory; call save() first")
        from repro_torch.store_io import graphstore_io
        self.executor.from_root(
            lambda: graphstore_io.save_store(self, self._store_dir))
        self._journal_base = self._journal_seq
        self._counts["compactions"] += 1

    def _maybe_compact(self) -> None:
        if (self._store_dir is not None and self.compact_every
                and self._journal_seq - self._journal_base
                >= self.compact_every):
            self.compact()

    @classmethod
    def open(cls, store_dir, *, device: DeviceLike = None, mesh=None,
             engine: Optional[GedEngine] = None, backend: str = "auto",
             graphs=None, **engine_options):
        """Reopen a persisted store without re-ingesting.

        The warm path mmaps the persisted feature buckets and sketch
        matrix straight into the resident structures — no feature
        packing, no signature builds, no dedup checks — and then replays
        any journal entries newer than the snapshot; queries against the
        result are bit-identical to the store that saved it.  Corrupt or
        truncated *derived* segments (digests, groups, features,
        sketches) are re-derived from the persisted graphs with a
        warning; corrupt *primary* segments raise — unless ``graphs=``
        supplies the original corpus, in which case the store warns,
        re-ingests it (with this call's store defaults) and re-saves.

        ``device`` / ``mesh`` / ``engine`` / ``backend`` and engine
        keyword options mean the same as in the constructor; store-level knobs
        (``digest``, ``filter_iters``, ``filter_pool``, index
        configuration) come from the snapshot itself.  The directory may
        have been written by either package.
        """
        from repro_torch.store_io import graphstore_io
        from repro_torch.store_io.atomic import StoreIOError
        store_dir = str(store_dir)
        t_open = time.perf_counter()
        self = object.__new__(cls)
        self._init_engine(backend, device, mesh, engine, engine_options)
        unreadable: Optional[StoreIOError] = None
        try:
            payload = graphstore_io.read_store_manifest(store_dir)
            primary = graphstore_io.load_primary(store_dir, payload)
            base = int(payload.get("journal_base", 0))
            ops, top = graphstore_io.load_journal(store_dir, base)
        except StoreIOError as err:
            unreadable = err
        # the ranks of a mesh take a fallback together or not at all
        if self.executor.agree(unreadable is not None)[0]:
            if graphs is None:
                raise unreadable or StoreIOError(
                    f"persisted store at {store_dir!r} is unreadable on "
                    f"another rank of the mesh")
            warnings.warn(
                f"persisted store at {store_dir!r} is unreadable "
                f"({unreadable or 'on another rank of the mesh'}); "
                f"re-ingesting the supplied graphs and re-saving",
                RuntimeWarning, stacklevel=2)
            store = cls(graphs, device=device, mesh=mesh, engine=engine,
                        backend=backend, **engine_options)
            store.save(store_dir)
            store._counts["open_wall_s"] += time.perf_counter() - t_open
            return store

        self.digest = payload["digest"]
        self.filter_iters = int(payload["filter_iters"])
        self.filter_pool = int(payload["filter_pool"])
        meta = payload.get("index")
        self._index_spec = dict(meta["knobs"]) if meta else None
        self._dedup_checks = int(payload.get("dedup_checks", 0))
        self._store_dir = None          # journal replay must not re-journal
        self._journal_seq = top
        self._journal_base = base
        self.compact_every = 64
        self.graphs = [None] * int(primary["next_id"])
        for gid, g in zip(primary["ids"], primary["graphs"]):
            self.graphs[gid] = g
        self._tombstones = {gid for gid, d
                            in zip(primary["ids"], primary["dead"]) if d}
        self._init_filter_cfg()
        self._init_counts()
        vocab = (tuple(int(v) for v in payload["vocab"][0]),
                 tuple(int(v) for v in payload["vocab"][1]))
        corrupt: Optional[StoreIOError] = None
        try:
            self._restore_derived(
                graphstore_io.load_derived(store_dir, payload,
                                           primary["ids"]),
                primary["ids"], vocab)
        except StoreIOError as err:
            corrupt = err
        if self.executor.agree(corrupt is not None)[0]:
            warnings.warn(
                f"derived segments at {store_dir!r} are corrupt "
                f"({corrupt or 'on another rank of the mesh'}); "
                f"re-deriving from the persisted graphs", RuntimeWarning,
                stacklevel=2)
            t0 = time.perf_counter()
            self._ingest(primary["ids"], vocab)
            self._counts["ingest_wall_s"] += time.perf_counter() - t0
        self._n_live = sum(1 for gid, g in enumerate(self.graphs)
                           if g is not None
                           and gid not in self._tombstones)
        for op in ops:
            self._replay(op)
        self._store_dir = store_dir
        self._counts["open_wall_s"] += time.perf_counter() - t_open
        return self

    def _restore_derived(self, derived: Dict, ids: List[int],
                         vocab: Vocab) -> None:
        """Wire mmap-backed segments straight into the resident
        structures — the warm path: no dedup checks, no feature packing,
        no signature builds (the counter contract the persistence tests
        pin).  Any inconsistency raises so :meth:`open` falls back to
        :meth:`_ingest` over the persisted graphs.
        """
        from repro_torch.store_io.atomic import CorruptStoreError
        self.vocab = vocab
        self._exact_of = {}
        for gid, d in zip(ids, derived["exact"]):       # ids ascending:
            if gid not in self._tombstones \
                    and d not in self._exact_of:        # lowest live wins
                self._exact_of[d] = gid
        self._rep_of = dict(zip(ids, derived["rep_of"]))
        members: Dict[int, List[int]] = {}
        for gid in ids:
            members.setdefault(self._rep_of[gid], []).append(gid)
        if any(self._rep_of.get(rep) != rep for rep in members):
            raise CorruptStoreError(
                "dedup group assignment is inconsistent")
        self._members = {rep: sorted(ms)
                         for rep, ms in sorted(members.items())}
        self._wl_of = {}
        self._wl_reps = {}
        if self.digest == "wl":
            wl = dict(zip(ids, derived["wl"]))
            for rep in self._members:
                wd = wl.get(rep, _ZERO16)
                if wd != _ZERO16:
                    self._wl_of[rep] = wd
                    self._wl_reps.setdefault(wd, []).append(rep)
        self._rep_ids = sorted(
            rep for rep, ms in self._members.items()
            if any(m not in self._tombstones for m in ms))

        have = {gid for bids, _ in derived["features"].values()
                for gid in bids}
        if have != set(self._rep_ids):
            raise CorruptStoreError(
                "feature buckets do not cover the dedup representatives")
        self._index = FilterIndex(self.graphs, self._rep_ids, self.vocab,
                                  self.executor,
                                  features=derived["features"])
        idx = derived["index"]
        if self._index_spec is None or idx is None:
            self._cindex = None
        else:
            if set(idx["ids"]) != set(self._rep_ids):
                raise CorruptStoreError(
                    "index sketch rows do not cover the dedup "
                    "representatives")
            self._cindex = CandidateIndex(
                self.graphs, idx["ids"], executor=self.executor,
                sigs=idx["sigs"], max_deg=idx["max_deg"], **idx["knobs"])
            for p in idx["pivots"]:
                self._cindex.note_pivot(p)
        self._bind_index()

    def _replay(self, op: Dict) -> None:
        from repro_torch.store_io.atomic import CorruptStoreError
        kind = op.get("op")
        if kind == "add":
            new = op.get("graphs", [])
            ids = [int(i) for i in op.get("ids", [])]
            if ids != list(range(len(self.graphs),
                                 len(self.graphs) + len(new))):
                raise CorruptStoreError(
                    "journal add entry is out of sequence")
            self.graphs.extend(new)
            self._counts["adds"] += len(new)
            self._apply_add(ids)
        elif kind == "remove":
            ids = [int(i) for i in op.get("ids", [])]
            self._counts["removals"] += len(ids)
            self._apply_remove(ids)
        else:
            raise CorruptStoreError(f"unknown journal op {kind!r}")

    # --------------------------------------------------------- mutation

    def add(self, graphs) -> List[int]:
        """Ingest additional graphs incrementally; returns their ids.

        Dedup (exact match, then certified WL merge against existing
        groups), vocabulary growth and index maintenance all match a
        fresh ingest of the combined corpus — only the new rows are
        packed and sketched, unless a new label grows the vocabulary
        (histogram widths change, forcing one stage-0 re-pack).  On an
        attached store the batch is journaled write-ahead before it is
        applied.
        """
        new = [as_graph(g) for g in graphs]
        if not new:
            return []
        ids = list(range(len(self.graphs), len(self.graphs) + len(new)))
        if self._store_dir is not None:
            from repro_torch.store_io import graphstore_io
            self._journal_seq += 1
            self.executor.from_root(lambda: graphstore_io.append_journal(
                self._store_dir, self._journal_seq,
                {"op": "add", "ids": ids}, new))
        self.graphs.extend(new)
        self._counts["adds"] += len(new)
        self._apply_add(ids)
        self._maybe_compact()
        return ids

    def remove(self, ids: Sequence[int]) -> None:
        """Tombstone corpus entries (their ids are never reused).

        Raises ``KeyError`` if any id is unknown or already removed —
        checked up front, before anything is journaled or applied.  A
        removed representative keeps serving as its group's resident
        probe object until the group's last member is gone; fully-dead
        groups leave the candidate set immediately and are dropped from
        disk at the next compaction.
        """
        ids = [int(i) for i in ids]
        seen: Set[int] = set()
        for gid in ids:
            if (gid in seen or gid not in self._rep_of
                    or gid in self._tombstones):
                raise KeyError(
                    f"graph id {gid} is not a live member of this store")
            seen.add(gid)
        if not ids:
            return
        if self._store_dir is not None:
            from repro_torch.store_io import graphstore_io
            self._journal_seq += 1
            self.executor.from_root(lambda: graphstore_io.append_journal(
                self._store_dir, self._journal_seq,
                {"op": "remove", "ids": ids}))
        self._counts["removals"] += len(ids)
        self._apply_remove(ids)
        self._maybe_compact()

    def _apply_add(self, ids: List[int]) -> None:
        t0 = time.perf_counter()
        new = [self.graphs[i] for i in ids]
        merged = merge_vocab(self.vocab, new)
        self._counts["vocab_wall_s"] += time.perf_counter() - t0
        live = set(self._rep_ids)
        new_reps: List[int] = []
        new_digests: Dict[int, bytes] = {}
        for gid in ids:
            g = self.graphs[gid]
            d = graph_digest(g)
            owner = self._exact_of.get(d)
            wd = None
            rep = None
            if owner is not None:
                rep = self._rep_of[owner]
            elif self.digest == "wl":
                wd = wl_digest(g)
                for cand in self._wl_reps.get(wd, []):
                    self._dedup_checks += 1
                    if ged_verify(self.graphs[cand], g, 0.0,
                                  bound="BMa").similar:
                        rep = cand
                        break
            if rep is not None:
                self._members[rep].append(gid)
                self._members[rep].sort()
                self._rep_of[gid] = rep
                if d not in self._exact_of:
                    self._exact_of[d] = gid
                if rep not in live:
                    # a fully-dead group revived by a new member; its rep
                    # is already resident in every index structure
                    live.add(rep)
                    bisect.insort(self._rep_ids, rep)
            else:
                self._members[gid] = [gid]
                self._rep_of[gid] = gid
                self._exact_of[d] = gid
                if self.digest == "wl":
                    self._wl_of[gid] = wd
                    self._wl_reps.setdefault(wd, []).append(gid)
                live.add(gid)
                bisect.insort(self._rep_ids, gid)
                new_reps.append(gid)
                new_digests[gid] = d
        self._n_live += len(ids)
        t0 = time.perf_counter()
        if merged != self.vocab:
            # stage-0 features are vocabulary-indexed histograms: label
            # growth changes every row's width, forcing one full re-pack
            # (the sketch matrix is vocabulary-independent and keeps its
            # rows)
            self.vocab = merged
            self._index = FilterIndex(self.graphs, self._rep_ids,
                                      self.vocab, self.executor)
        elif new_reps:
            self._index.extend(self.graphs, new_reps)
        if self._cindex is not None and new_reps:
            self._cindex.extend(self.graphs, new_reps,
                                executor=self.executor)
            if self.engine.digest == "exact":
                self._cindex.bind_engine(self.engine, new_digests)
        self._counts["pack_wall_s"] += time.perf_counter() - t0

    def _apply_remove(self, ids: List[int]) -> None:
        for gid in ids:
            if gid in self._tombstones or gid not in self._rep_of:
                continue            # journal replay tolerates re-removal
            self._tombstones.add(gid)
            self._n_live -= 1
            rep = self._rep_of[gid]
            d = graph_digest(self.graphs[gid])
            if self._exact_of.get(d) == gid:
                # hand the digest to the lowest live byte-identical
                # member, so member_id routing never returns a tombstone
                repl = next(
                    (m for m in self._members[rep]
                     if m not in self._tombstones
                     and graph_digest(self.graphs[m]) == d), None)
                if repl is None:
                    del self._exact_of[d]
                else:
                    self._exact_of[d] = repl
            if all(m in self._tombstones for m in self._members[rep]):
                # group fully dead: out of the candidate set (its resident
                # rows stay; scans keyed by _rep_ids never read them)
                i = bisect.bisect_left(self._rep_ids, rep)
                if i < len(self._rep_ids) and self._rep_ids[i] == rep:
                    del self._rep_ids[i]

    # ------------------------------------------------------------ search

    def range_search(self, query, tau: float) -> List[SearchHit]:
        """Every corpus graph with ``delta(query, g) <= tau``, ranked.

        Hits are sorted by ``(upper_bound, graph_id)`` — the certified
        upper bound is exact when a stage decided the pair by computing
        the distance, and at most ``tau`` otherwise.
        """
        q = as_graph(query)
        tau = float(tau)
        self._counts["queries"] += 1
        jobs = [(rid, tau) for rid in self._rep_ids]
        decided = self._staged_verify(q, jobs)
        hits: List[SearchHit] = []
        for (rid, _), (outcome, stage) in zip(jobs, decided):
            if outcome.similar:
                hits.extend(self._group_hits(rid, outcome, stage))
        hits.sort(key=lambda h: (h.upper_bound, h.graph_id))
        self._counts["hits"] += len(hits)
        return hits

    def top_k(self, query, k: int) -> List[SearchHit]:
        """The ``k`` nearest corpus graphs by exact GED, ranked.

        Candidates are visited in increasing stage-0 lower-bound order
        and verified in chunks; the walk stops as soon as the next
        candidate's lower bound exceeds the current k-th best distance,
        so most of the corpus is never verified.  When the store has a
        candidate index, the walk is *seeded* with the index's
        sketch-nearest candidates: verifying likely-close graphs first
        tightens the k-th-best cutoff early, so the lb-ordered remainder
        exits sooner.  Seeding never changes the answer — the cutoff
        check still runs against the full lb order — it only changes how
        fast the walk converges.  Ties break by corpus id, matching a
        brute-force ``(ged, id)`` sort.
        """
        k = int(k)
        if k <= 0 or not self._rep_ids:
            return []
        q = as_graph(query)
        self._counts["queries"] += 1
        self._counts["topk_candidates"] += len(self._rep_ids)
        t0 = time.perf_counter()
        lb_of = self._index.scan_by_id(q)
        self._counts["scan_wall_s"] += time.perf_counter() - t0
        order = sorted(self._rep_ids, key=lambda rid: (lb_of[rid], rid))
        chunk = max(k, 8)
        seeds: List[int] = []
        if self._cindex is not None and len(order) > chunk:
            t0 = time.perf_counter()
            rset = set(self._rep_ids)   # nearest() may surface dead reps
            seeds = [rid for rid
                     in self._cindex.nearest(q, limit=max(2 * k, chunk))
                     if rid in rset]
            self._counts["topk_seeded"] += len(seeds)
            seedset = set(seeds)
            order = seeds + [rid for rid in order if rid not in seedset]
            qid = self._exact_of.get(graph_digest(q))
            if qid is not None:
                self._cindex.note_pivot(self._rep_of[qid])
            self._counts["index_wall_s"] += time.perf_counter() - t0
        vocab = merge_vocab(self.vocab, [q])
        collected: List[Tuple[float, int, GedOutcome]] = []
        i = 0
        while i < len(order):
            kth = collected[k - 1][0] if len(collected) >= k else _INF
            # the cutoff only applies once the walk is past the (unsorted)
            # seed prefix and into the globally lb-ordered remainder
            if i >= len(seeds) and lb_of[order[i]] > kth:
                break
            reps = order[i:i + chunk]
            t0 = time.perf_counter()
            outs = self.engine.compute(
                [(q, self.graphs[rid]) for rid in reps], vocab=vocab)
            self._counts["verify_wall_s"] += time.perf_counter() - t0
            self._counts["topk_verified"] += len(reps)
            for rid, outcome in zip(reps, outs):
                outcome.stats["stage"] = STAGE_VERIFY
                for hit in self._group_hits(rid, outcome, STAGE_VERIFY):
                    collected.append((hit.ged, hit.graph_id, hit.outcome))
            collected.sort(key=lambda t: (t[0], t[1]))
            i += len(reps)
        hits = [SearchHit(gid, outcome, STAGE_VERIFY)
                for _, gid, outcome in collected[:k]]
        self._counts["hits"] += len(hits)
        return hits

    def search_batch(self, queries, tau: float) -> List[List[SearchHit]]:
        """One ranked :meth:`range_search` hit list per query.

        Each hit's ``query_id`` is its query's position in ``queries``.
        """
        out = []
        for qi, query in enumerate(queries):
            hits = self.range_search(query, tau)
            for h in hits:
                h.query_id = qi
            out.append(hits)
        return out

    def verify_members(self, query, ids: Sequence[int],
                       taus) -> List[GedOutcome]:
        """Verify ``delta(query, graphs[id]) <= tau`` for specific members.

        The staged filter runs first (resident stage-0 features, then the
        stage-1 engine bounds), so a batch of requests against ingested
        graphs pays full verification only for undecided pairs — this is
        what the reference's ``GedVerificationService`` routes batch
        traffic through once a corpus is registered.  ``taus`` is a
        scalar or one threshold per id.  Removed ids raise ``KeyError``.
        """
        q = as_graph(query)
        ids = [int(i) for i in ids]
        for gid in ids:
            if gid not in self._rep_of or gid in self._tombstones:
                raise KeyError(f"graph id {gid} is not in this store")
        taus = np.broadcast_to(
            np.asarray(taus, dtype=np.float64), (len(ids),))
        jobs: List[Tuple[int, float]] = []
        slot: Dict[Tuple[int, float], int] = {}
        for gid, tau in zip(ids, taus):
            key = (self._rep_of[gid], float(tau))
            if key not in slot:
                slot[key] = len(jobs)
                jobs.append(key)
        decided = self._staged_verify(q, jobs)
        out = []
        served: set = set()
        for gid, tau in zip(ids, taus):
            key = (self._rep_of[gid], float(tau))
            outcome, _ = decided[slot[key]]
            if gid != key[0]:
                out.append(self._dup(outcome))
            elif key in served:
                # duplicate request: its own detached copy, preserving
                # the engine path's per-position-independence invariant
                out.append(detached(outcome, dict(outcome.stats)))
            else:
                served.add(key)
                out.append(outcome)
        return out

    # ------------------------------------------------------------- stats

    @property
    def stats(self) -> Dict[str, float]:
        """Pipeline counters — the API contract for filter efficiency.

        ``candidates`` (deduped pairs entering the pipeline across all
        range/verify queries), ``candidates_stage_-1`` (pairs stage −1
        examined — equal to ``candidates`` when the index is on, 0 when
        off), ``index_pruned`` (with its ``index_sketch_pruned`` /
        ``index_pivot_pruned`` split), ``stage0_pruned``,
        ``stage1_decided`` / ``stage1_accepted``, ``stage2_verified``,
        ``filter_ratio`` (fraction of candidates decided *before* full
        verification — index-pruned candidates count as filtered, so the
        funnel ``index_pruned + stage0_pruned + stage1_decided +
        stage2_verified`` always sums to ``candidates``), ``hits``,
        per-stage wall splits (``index_wall_s`` / ``scan_wall_s`` /
        ``bound_wall_s`` / ``verify_wall_s``), top-k counters
        (``topk_seeded`` — index-suggested candidates verified first),
        dedup totals, mutation/persistence counters (``adds`` /
        ``removals`` / ``compactions`` / ``journal_pending`` and the
        ``ingest_wall_s`` = ``vocab_wall_s`` + ``pack_wall_s`` + dedup
        ingest split, ``open_wall_s`` for warm opens), the stage-0
        scan's own counters under ``filter_*`` (``filter_packed_rows``
        is 0 after a warm open — nothing was re-packed), the candidate
        index's under ``index_*`` (probes, fallbacks, tables built,
        pivot traffic, ``index_signatures_built`` — likewise 0 after a
        warm open), and the engine's under ``engine_*`` (including
        ``engine_index_pivot_hits`` / ``_misses`` — result-cache traffic
        from pivot lookups).
        """
        out = dict(self._counts)
        cand = out["candidates"]
        out["filter_ratio"] = \
            (cand - out["stage2_verified"]) / cand if cand else 0.0
        out["dedup_groups"] = len(self._rep_ids)
        out["dedup_duplicates"] = self._n_live - len(self._rep_ids)
        out["dedup_checks"] = self._dedup_checks
        out["journal_pending"] = self._journal_seq - self._journal_base
        out.update({f"filter_{k}": v
                    for k, v in self._index.stats.items()})
        if self._cindex is not None:
            out.update({f"index_{k}": v
                        for k, v in self._cindex.stats.items()})
        out.update({f"engine_{k}": v for k, v in self.engine.stats.items()})
        return out

    # --------------------------------------------------------- internal

    def _staged_verify(self, q: Graph, jobs: Sequence[Tuple[int, float]]
                       ) -> List[Tuple[GedOutcome, int]]:
        """Run the filter-verify pipeline for ``(rep_id, tau)`` jobs.

        Returns one ``(outcome, stage)`` per job, aligned.  Every stage
        only *decides* soundly: stage −1 rejects by banded-sketch and
        pivot triangle bounds (certified except for probabilistic-mode
        band misses, which are the explicit ``recall`` trade), stage 0
        rejects when its lower bound exceeds tau, stage 1 trusts the
        engine's certificate, stage 2 verifies whatever survived.
        """
        self._counts["candidates"] += len(jobs)
        results: List[Optional[Tuple[GedOutcome, int]]] = [None] * len(jobs)
        vocab = merge_vocab(self.vocab, [q])

        alive: List[int] = list(range(len(jobs)))
        if self._cindex is not None and jobs:
            t0 = time.perf_counter()
            self._counts["candidates_stage_-1"] += len(jobs)
            tau_probe = max(tau for _, tau in jobs)
            sketch = self._cindex.probe(q, tau_probe)
            want = sorted({rid for rid, _ in jobs if rid in sketch})
            piv = self._cindex.pivot_bounds(q, want, vocab=vocab) \
                if want else {}
            exact_mode = self._cindex.exact
            # a banding miss in exact mode *proves* sketch L1 > budget,
            # i.e. a distance floor strictly above the probed tau
            damage = self._cindex.damage(q, tau_probe)
            miss_lb = (np.floor(damage * tau_probe + 1e-9) + 1.0) / damage
            alive = []
            for pos, (rid, tau) in enumerate(jobs):
                slb = sketch.get(rid)
                if slb is None:
                    self._counts["index_pruned"] += 1
                    self._counts["index_sketch_pruned"] += 1
                    results[pos] = (GedOutcome(
                        ged=None, similar=False, certified=exact_mode,
                        lower_bound=float(miss_lb) if exact_mode else 0.0,
                        upper_bound=_INF, mapping=None,
                        backend="store/index", wall_s=0.0, tau=tau,
                        stats={"stage": STAGE_INDEX}), STAGE_INDEX)
                    continue
                lb = max(slb, piv.get(rid, 0.0))
                if lb > tau:
                    # admissible bound exceeded: certified in either mode
                    self._counts["index_pruned"] += 1
                    self._counts["index_sketch_pruned" if slb > tau
                                 else "index_pivot_pruned"] += 1
                    results[pos] = (GedOutcome(
                        ged=None, similar=False, certified=True,
                        lower_bound=lb, upper_bound=_INF, mapping=None,
                        backend="store/index", wall_s=0.0, tau=tau,
                        stats={"stage": STAGE_INDEX}), STAGE_INDEX)
                else:
                    alive.append(pos)
            # a query that is itself a corpus member becomes a pivot:
            # the distances this query computes are cache-resident and
            # reusable by every later query's triangle bounds
            qid = self._exact_of.get(graph_digest(q))
            if qid is not None:
                self._cindex.note_pivot(self._rep_of[qid])
            self._counts["index_wall_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        if self._cindex is None:
            lb_of = self._index.scan_by_id(q)
        else:
            # scan only stage -1 survivors; past half the corpus the
            # resident full-bucket pass is the cheaper shape
            want = sorted({jobs[pos][0] for pos in alive})
            if not want:
                lb_of = {}
            elif 2 * len(want) <= len(self._rep_ids):
                lb_of = self._index.scan_subset(q, want)
            else:
                lb_of = self._index.scan_by_id(q)
        self._counts["scan_wall_s"] += time.perf_counter() - t0
        survivors: List[int] = []
        for pos in alive:
            rid, tau = jobs[pos]
            lb = lb_of[rid]
            if lb > tau:
                self._counts["stage0_pruned"] += 1
                results[pos] = (GedOutcome(
                    ged=None, similar=False, certified=True,
                    lower_bound=lb, upper_bound=_INF, mapping=None,
                    backend="store/filter", wall_s=0.0, tau=tau,
                    stats={"stage": STAGE_FILTER}), STAGE_FILTER)
            else:
                survivors.append(pos)
        if survivors and self._filter_cfg is not None:
            plan = Plan.lazy(
                [(q, self.graphs[jobs[pos][0]]) for pos in survivors],
                vocab=vocab)
            taus_arr = np.asarray([jobs[pos][1] for pos in survivors],
                                  dtype=np.float32)
            undecided: List[int] = []
            for bucket in plan.subset_buckets(range(len(survivors)),
                                              self.executor.pack):
                t0 = time.perf_counter()
                out = self.executor.run_bucket(bucket, taus_arr,
                                               self._filter_cfg, True)
                wall = time.perf_counter() - t0
                self._counts["bound_wall_s"] += wall
                for bi, pi in enumerate(bucket.indices):
                    pos = survivors[pi]
                    if bool(out["exact"][bi]):
                        outcome = engine_outcome(
                            out, bucket.packed, bi, True,
                            float(taus_arr[pi]), "store/bound", wall,
                            rung=0)
                        outcome.stats["stage"] = STAGE_BOUND
                        self._counts["stage1_decided"] += 1
                        if outcome.similar:
                            self._counts["stage1_accepted"] += 1
                        results[pos] = (outcome, STAGE_BOUND)
                    else:
                        undecided.append(pos)
            survivors = sorted(undecided)

        if survivors:
            t0 = time.perf_counter()
            outs = self.engine.verify(
                [(q, self.graphs[jobs[pos][0]]) for pos in survivors],
                [jobs[pos][1] for pos in survivors], vocab=vocab)
            self._counts["verify_wall_s"] += time.perf_counter() - t0
            self._counts["stage2_verified"] += len(survivors)
            for pos, outcome in zip(survivors, outs):
                outcome.stats["stage"] = STAGE_VERIFY
                results[pos] = (outcome, STAGE_VERIFY)
        return results  # type: ignore[return-value]

    def _group_hits(self, rid: int, outcome: GedOutcome,
                    stage: int) -> List[SearchHit]:
        """Hits for every *live* corpus entry in ``rid``'s digest group."""
        return [SearchHit(gid, outcome if gid == rid else self._dup(outcome),
                          stage)
                for gid in self._members[rid]
                if gid not in self._tombstones]

    def _dup(self, outcome: GedOutcome) -> GedOutcome:
        """A duplicate corpus entry's copy of its representative's answer.

        Under the ``"wl"`` digest duplicates are isomorphic-but-not-
        identical, so the representative's vertex mapping does not apply
        and is dropped; exact-digest duplicates keep it.
        """
        out = detached(outcome, {**outcome.stats, "dedup": True})
        if self.digest == "wl":
            out = dataclasses.replace(out, mapping=None)
        return out
