"""On-disk layout + (de)serialization for :class:`repro_torch.ged.GraphStore`.

The port's copy of ``repro/store_io/graphstore_io.py``, with the same
file names, dtypes, manifest kind, schema version and checksums, so a
store saved by either package opens in the other.  The store's durable
form is a *generation directory* of checksummed ``.npy`` segments plus
one atomic manifest, with an append/delete journal on the side::

    <store_dir>/
      graphstore.json         # manifest: the atomic commit point
      seg-00000003/           # current generation (immutable once named)
        graphs.ids.npy  graphs.n.npy  graphs.vlabels.npy  graphs.adj.npy
        dead.npy  rep_of.npy  digests.exact.npy  [digests.wl.npy]
        feat8.ids.npy  feat8.vhist.npy ...      # per-slot-bucket stage-0
        index.ids.npy  index.sigs.npy           # stage −1 sketch matrix
      journal/
        j-00000004.seg/ ...   # arrays of an appended batch
        j-00000004.json       # entry (written last = commit point)

Writes are two-phase: segments land in a temp directory, the directory is renamed into place,
and only then does the manifest atomically switch generations — a crash
at any point leaves the previous generation fully readable.  Segment
data splits into **primary** state (the graphs themselves, tombstone
flags, the journal) and **derived** state (digests, dedup groups,
feature buckets, sketch matrix): derived corruption is recoverable by
re-deriving from primary, so callers get to warn-and-rebuild instead of
failing (:meth:`repro_torch.ged.GraphStore.open` does exactly that).

``GraphStore.save`` always writes a *compacted* snapshot — live graphs
plus the (possibly tombstoned) representatives live groups still probe
through — and folds the journal into it; ``journal_base`` in the
manifest is the watermark below which journal entries are already
folded, which keeps replay correct even if a crash interrupts journal
cleanup.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import tempfile
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine.corpus import CorpusFeatures
from repro_torch.core.exact.graph import Graph
from repro_torch.store_io.atomic import (CorruptStoreError, read_manifest,
                                         read_array, write_array,
                                         write_manifest)

__all__ = ["save_store", "read_store_manifest", "load_primary",
           "load_derived", "load_journal", "append_journal",
           "clear_journal", "MANIFEST_NAME"]

STORE_KIND = "graphstore"
STORE_VERSION = 1
JOURNAL_KIND = "graphstore-journal"
MANIFEST_NAME = "graphstore.json"
JOURNAL_DIR = "journal"

_GEN_RE = re.compile(r"^seg-(\d{8})$")
_JOURNAL_RE = re.compile(r"^j-(\d{8})\.json$")


def manifest_path(store_dir: str) -> str:
    return os.path.join(store_dir, MANIFEST_NAME)


# ------------------------------------------------------ graph array codec

def pack_graph_arrays(graphs: Sequence[Graph]) -> Dict[str, np.ndarray]:
    """Ragged corpus -> three flat arrays (``n`` + concatenated vertex
    labels + concatenated row-major adjacency blocks)."""
    n = np.asarray([g.n for g in graphs], dtype=np.int64)
    vlabels = (np.concatenate([np.asarray(g.vlabels, dtype=np.int64)
                               for g in graphs])
               if graphs else np.zeros(0, dtype=np.int64))
    adj = (np.concatenate([np.asarray(g.adj, dtype=np.int64).reshape(-1)
                           for g in graphs])
           if graphs else np.zeros(0, dtype=np.int64))
    return {"n": n, "vlabels": vlabels, "adj": adj}


def unpack_graph_arrays(n: np.ndarray, vlabels: np.ndarray,
                        adj: np.ndarray) -> List[Graph]:
    vptr = np.concatenate([[0], np.cumsum(n)])
    aptr = np.concatenate([[0], np.cumsum(n * n)])
    if vptr[-1] != len(vlabels) or aptr[-1] != len(adj):
        raise CorruptStoreError(
            "graph arrays are inconsistent: label/adjacency lengths do "
            "not match the per-graph sizes")
    out = []
    for i, ni in enumerate(n):
        ni = int(ni)
        out.append(Graph(
            vlabels=np.ascontiguousarray(vlabels[vptr[i]:vptr[i + 1]]),
            adj=np.ascontiguousarray(
                adj[aptr[i]:aptr[i + 1]]).reshape(ni, ni)))
    return out


def _pack_digests(digests: Sequence[bytes]) -> np.ndarray:
    if not digests:
        return np.zeros((0, 16), dtype=np.uint8)
    return np.stack([np.frombuffer(d, dtype=np.uint8) for d in digests])


def _unpack_digests(arr: np.ndarray) -> List[bytes]:
    return [bytes(row.tobytes()) for row in np.asarray(arr, dtype=np.uint8)]


# ----------------------------------------------------------------- saving

def save_store(store, store_dir: str) -> None:
    """Write a full (compacted) snapshot of ``store`` and commit it.

    Keeps every live graph plus tombstoned representatives whose groups
    still have live members (they remain the group's probe object);
    fully-dead groups and dead non-representative members are dropped —
    their ids are never reused (``next_id`` is persisted)."""
    store_dir = str(store_dir)
    os.makedirs(store_dir, exist_ok=True)
    live = {i for i in range(len(store.graphs))
            if store.graphs[i] is not None and i not in store._tombstones}
    keep = sorted(live | set(store._rep_ids))
    gen_num = _next_generation(store_dir)
    gen_name = f"seg-{gen_num:08d}"
    tmp = tempfile.mkdtemp(dir=store_dir, prefix=gen_name + ".tmp-")
    try:
        segments: Dict[str, Dict] = {}

        def put(name: str, arr: np.ndarray) -> None:
            segments[name] = write_array(tmp, name + ".npy", arr)

        graphs = [store.graphs[i] for i in keep]
        packed = pack_graph_arrays(graphs)
        put("graphs.ids", np.asarray(keep, dtype=np.int64))
        put("graphs.n", packed["n"])
        put("graphs.vlabels", packed["vlabels"])
        put("graphs.adj", packed["adj"])
        put("dead", np.asarray([i in store._tombstones for i in keep],
                               dtype=np.uint8))
        put("rep_of", np.asarray([store._rep_of[i] for i in keep],
                                 dtype=np.int64))
        digest_of = {gid: d for d, gid in store._exact_of.items()}
        from repro_torch.ged.exec import graph_digest
        put("digests.exact", _pack_digests(
            [digest_of.get(i) or graph_digest(store.graphs[i])
             for i in keep]))
        if store.digest == "wl":
            put("digests.wl", _pack_digests(
                [store._wl_of.get(i, b"\x00" * 16) for i in keep]))

        keep_set = set(keep)
        feature_slots: List[int] = []
        for b in store._index.buckets:
            # resident buckets never shrink, so they may still carry rows
            # for representatives of fully-dead groups — dropped here,
            # like their graphs
            rows = np.asarray([ri for ri, gid in enumerate(b.ids)
                               if gid in keep_set], dtype=np.int64)
            if not len(rows):
                continue
            feature_slots.append(int(b.slots))
            put(f"feat{b.slots}.ids",
                np.asarray([b.ids[ri] for ri in rows], dtype=np.int64))
            f = b.features
            for part, arr in (("vhist", f.vhist), ("ehist", f.ehist),
                              ("degs", f.degs), ("n", f.n), ("m", f.m)):
                put(f"feat{b.slots}.{part}",
                    np.ascontiguousarray(np.asarray(arr)[rows]))

        index_meta = None
        cindex = store._cindex
        if cindex is not None:
            rows = [pos for pos, gid in enumerate(cindex.ids)
                    if gid in keep_set]
            put("index.ids", np.asarray([cindex.ids[pos] for pos in rows],
                                        dtype=np.int64))
            put("index.sigs",
                np.ascontiguousarray(np.asarray(cindex.sigs)[rows]))
            index_meta = {
                "knobs": {
                    "dims_v": cindex.spec.dims_v,
                    "dims_e": cindex.spec.dims_e,
                    "wl_iters": cindex.spec.wl_iters,
                    "reps": cindex.reps,
                    "recall": cindex.recall,
                    "max_pivots": cindex.max_pivots,
                    "pivot_seeds": cindex.pivot_seeds,
                    "pivot_coverage": cindex.pivot_coverage,
                    "pivot_min_candidates": cindex.pivot_min_candidates,
                    "seed": cindex.seed,
                },
                "max_deg": int(cindex._max_deg),
                "pivots": [int(p) for p in cindex._pivots
                           if p in keep_set],
            }

        payload = {
            "generation": gen_name,
            "segments": segments,
            "digest": store.digest,
            "filter_iters": int(store.filter_iters),
            "filter_pool": int(store.filter_pool),
            "vocab": [[int(v) for v in store.vocab[0]],
                      [int(v) for v in store.vocab[1]]],
            "index": index_meta,
            "feature_slots": feature_slots,
            "next_id": len(store.graphs),
            "dedup_checks": int(store._dedup_checks),
            "journal_base": int(store._journal_seq),
        }
        os.rename(tmp, os.path.join(store_dir, gen_name))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # the manifest swap is the commit point: a crash before this line
    # leaves the previous generation (and manifest) fully intact
    write_manifest(manifest_path(store_dir), payload,
                   kind=STORE_KIND, version=STORE_VERSION)
    _cleanup(store_dir, keep_gen=gen_name,
             journal_base=int(store._journal_seq))


def _next_generation(store_dir: str) -> int:
    newest = -1
    with contextlib.suppress(OSError):
        for name in os.listdir(store_dir):
            m = _GEN_RE.match(name.split(".tmp-")[0])
            if m:
                newest = max(newest, int(m.group(1)))
    return newest + 1


def _cleanup(store_dir: str, keep_gen: str, journal_base: int) -> None:
    """Best-effort removal of superseded generations, stale temp dirs and
    folded journal entries.  Failure here is harmless: the manifest's
    generation pointer and ``journal_base`` watermark already make stale
    files unreachable."""
    with contextlib.suppress(OSError):
        for name in os.listdir(store_dir):
            full = os.path.join(store_dir, name)
            if _GEN_RE.match(name) and name != keep_gen:
                shutil.rmtree(full, ignore_errors=True)
            elif ".tmp-" in name:
                shutil.rmtree(full, ignore_errors=True)
    _cleanup_journal(store_dir, journal_base)


def _cleanup_journal(store_dir: str, journal_base: int) -> None:
    jdir = os.path.join(store_dir, JOURNAL_DIR)
    with contextlib.suppress(OSError):
        for name in os.listdir(jdir):
            m = _JOURNAL_RE.match(name)
            seq = int(m.group(1)) if m else None
            if seq is None and name.endswith(".seg"):
                stem = name[:-len(".seg")]
                if stem.startswith("j-"):
                    with contextlib.suppress(ValueError):
                        seq = int(stem[2:].split(".tmp-")[0])
            if seq is not None and seq <= journal_base:
                full = os.path.join(jdir, name)
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    with contextlib.suppress(OSError):
                        os.unlink(full)


# ---------------------------------------------------------------- loading

def read_store_manifest(store_dir: str) -> Dict:
    return read_manifest(manifest_path(store_dir),
                         kind=STORE_KIND, version=STORE_VERSION)


def load_primary(store_dir: str, payload: Dict) -> Dict:
    """The non-derivable half of a snapshot: graphs by id + tombstones."""
    gen = os.path.join(store_dir, payload["generation"])
    segs = payload["segments"]

    def arr(name: str, mmap: bool = False) -> np.ndarray:
        if name not in segs:
            raise CorruptStoreError(
                f"manifest lists no {name!r} segment")
        return read_array(gen, segs[name], mmap=mmap)

    ids = np.asarray(arr("graphs.ids"), dtype=np.int64)
    graphs = unpack_graph_arrays(
        np.asarray(arr("graphs.n"), dtype=np.int64),
        arr("graphs.vlabels", mmap=True), arr("graphs.adj", mmap=True))
    dead = np.asarray(arr("dead"), dtype=bool)
    if not (len(ids) == len(graphs) == len(dead)):
        raise CorruptStoreError("graph/id/tombstone segment lengths differ")
    next_id = int(payload.get("next_id", 0))
    if len(ids) and (next_id <= int(ids.max()) or len(set(ids.tolist()))
                     != len(ids)):
        raise CorruptStoreError("graph id segment is inconsistent")
    return {
        "ids": [int(i) for i in ids],
        "graphs": graphs,
        "dead": [bool(d) for d in dead],
        "next_id": next_id,
    }


def load_derived(store_dir: str, payload: Dict, ids: List[int]) -> Dict:
    """Everything re-derivable from the primary state: digests, dedup
    group assignment, per-bucket stage-0 features (mmap-backed), and the
    stage −1 sketch state.  Raises :class:`CorruptStoreError` on any
    inconsistency — the caller falls back to re-deriving."""
    gen = os.path.join(store_dir, payload["generation"])
    segs = payload["segments"]

    def arr(name: str, mmap: bool = False) -> np.ndarray:
        if name not in segs:
            raise CorruptStoreError(f"manifest lists no {name!r} segment")
        return read_array(gen, segs[name], mmap=mmap)

    k = len(ids)
    exact = _unpack_digests(arr("digests.exact"))
    wl = (_unpack_digests(arr("digests.wl"))
          if payload["digest"] == "wl" else None)
    rep_of = np.asarray(arr("rep_of"), dtype=np.int64)
    if len(exact) != k or len(rep_of) != k or (wl is not None
                                               and len(wl) != k):
        raise CorruptStoreError("derived segment lengths differ from ids")
    id_set = set(ids)
    if any(int(r) not in id_set for r in rep_of):
        raise CorruptStoreError("rep_of references an absent graph id")

    features: Dict[int, Tuple[List[int], CorpusFeatures]] = {}
    for slots in payload.get("feature_slots", []):
        slots = int(slots)
        bids = [int(i) for i in
                np.asarray(arr(f"feat{slots}.ids"), dtype=np.int64)]
        cf = CorpusFeatures(
            vhist=arr(f"feat{slots}.vhist", mmap=True),
            ehist=arr(f"feat{slots}.ehist", mmap=True),
            degs=arr(f"feat{slots}.degs", mmap=True),
            n=arr(f"feat{slots}.n", mmap=True),
            m=arr(f"feat{slots}.m", mmap=True))
        if not (cf.vhist.shape[0] == cf.ehist.shape[0] == cf.degs.shape[0]
                == cf.n.shape[0] == cf.m.shape[0] == len(bids)):
            raise CorruptStoreError(
                f"feature bucket {slots} segment lengths differ")
        if any(b not in id_set for b in bids):
            raise CorruptStoreError(
                f"feature bucket {slots} references an absent graph id")
        features[slots] = (bids, cf)

    index_state = None
    meta = payload.get("index")
    if meta is not None:
        sig_ids = [int(i) for i in
                   np.asarray(arr("index.ids"), dtype=np.int64)]
        sigs = arr("index.sigs", mmap=True)
        if sigs.shape[0] != len(sig_ids) \
                or any(i not in id_set for i in sig_ids):
            raise CorruptStoreError("index sketch segments are inconsistent")
        index_state = {
            "knobs": dict(meta.get("knobs", {})),
            "max_deg": int(meta.get("max_deg", 0)),
            "pivots": [int(p) for p in meta.get("pivots", [])],
            "ids": sig_ids,
            "sigs": sigs,
        }
    return {"exact": exact, "wl": wl,
            "rep_of": [int(r) for r in rep_of],
            "features": features, "index": index_state}


# ---------------------------------------------------------------- journal

def append_journal(store_dir: str, seq: int, op: Dict,
                   graphs: Optional[Sequence[Graph]] = None) -> None:
    """Durably append one mutation.  Array segments (for adds) are
    written first; the entry JSON — written atomically, last — is the
    commit point, so a crash mid-append leaves an ignorable orphan
    segment directory, never a half-applied entry."""
    jdir = os.path.join(store_dir, JOURNAL_DIR)
    os.makedirs(jdir, exist_ok=True)
    stem = f"j-{int(seq):08d}"
    entry = dict(op)
    if graphs is not None:
        segdir = os.path.join(jdir, stem + ".seg")
        packed = pack_graph_arrays(list(graphs))
        entry["segments"] = {
            name: write_array(segdir, f"{stem}.{name}.npy", arr)
            for name, arr in packed.items()}
        entry["segdir"] = stem + ".seg"
    write_manifest(os.path.join(jdir, stem + ".json"), entry,
                   kind=JOURNAL_KIND, version=STORE_VERSION)


def load_journal(store_dir: str, base: int) -> Tuple[List[Dict], int]:
    """Committed journal entries with seq > ``base``, in order, with add
    segments decoded back into graphs.  A broken *final* entry is an
    interrupted append — dropped with a warning; a broken earlier entry
    would leave later entries unreplayable, so it raises."""
    jdir = os.path.join(store_dir, JOURNAL_DIR)
    seqs = []
    with contextlib.suppress(OSError):
        for name in os.listdir(jdir):
            m = _JOURNAL_RE.match(name)
            if m and int(m.group(1)) > base:
                seqs.append(int(m.group(1)))
    seqs.sort()
    ops: List[Dict] = []
    top = base
    for pos, seq in enumerate(seqs):
        stem = f"j-{seq:08d}"
        try:
            entry = read_manifest(os.path.join(jdir, stem + ".json"),
                                  kind=JOURNAL_KIND, version=STORE_VERSION)
            op = dict(entry)
            if "segments" in entry:
                segdir = os.path.join(jdir, entry["segdir"])
                op["graphs"] = unpack_graph_arrays(
                    np.asarray(read_array(segdir, entry["segments"]["n"]),
                               dtype=np.int64),
                    read_array(segdir, entry["segments"]["vlabels"]),
                    read_array(segdir, entry["segments"]["adj"]))
        except (CorruptStoreError, KeyError, OSError) as e:
            if pos == len(seqs) - 1:
                warnings.warn(
                    f"dropping interrupted journal entry {stem}: {e}",
                    RuntimeWarning)
                break
            raise CorruptStoreError(
                f"journal entry {stem} is corrupt with later entries "
                f"present: {e}")
        ops.append(op)
        top = seq
    return ops, top


def clear_journal(store_dir: str, base: int) -> None:
    """Remove folded journal entries (seq <= ``base``)."""
    _cleanup_journal(store_dir, int(base))
