"""The port's durable ``GraphStore`` (``store_io/graphstore_io.py``,
``save`` / ``open`` / ``compact`` and the journal) against the reference,
on the CPU.

A store directory is one format for both packages: a store saved by
``repro`` opens in ``repro_torch`` with identical hits, and the other
way round, and both write byte-equal segments for the same corpus.  A
warm open re-packs and re-hashes nothing.  Corruption behaves as in
``tests/test_store_io.py``: a truncated or bit-flipped derived segment
rebuilds with a warning, a corrupt primary segment, manifest or schema
raises and heals when the graphs are supplied, and the journal's add,
remove and compact round trip (also across packages) and
auto-compaction work.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro import store_io as ref_store_io  # noqa: E402

from repro_torch import ged, store_io  # noqa: E402
from repro_torch.data.graphs import perturb, random_graph  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.store_io import StoreIOError  # noqa: E402
from repro_torch.store_io.graphstore_io import MANIFEST_NAME  # noqa: E402

STORE_OPTS = dict(pool=256, expand=4, max_iters=256, batch_size=8)
PORT = dict(STORE_OPTS, device="cpu")


@pytest.fixture(autouse=True)
def _isolated_table():
    saved = autotune.snapshot()
    autotune.reset()
    yield
    autotune.restore(saved)


def plain(g):
    return (g.vlabels.tolist(), [tuple(int(x) for x in e)
                                 for e in g.edges()])


def _corpus(seed, count, nmin=3, nmax=7, planted=2):
    rng = np.random.default_rng(seed)
    graphs = [random_graph(rng, int(rng.integers(nmin, nmax + 1)),
                           density=0.4, n_vlabels=3, n_elabels=2)
              for _ in range(count)]
    for _ in range(planted):
        graphs.append(perturb(rng, graphs[0], int(rng.integers(1, 3)),
                              n_vlabels=3, n_elabels=2))
    return [plain(g) for g in graphs]


def _extra(seed, count=2):
    rng = np.random.default_rng(seed)
    return [plain(random_graph(rng, 5, density=0.4, n_vlabels=4,
                               n_elabels=2)) for _ in range(count)]


def _hits(hs):
    return [(h.graph_id, h.ged, h.lower_bound, h.upper_bound, h.similar,
             h.certified, h.stage) for h in hs]


def _answers(store, queries, tau=3.0, k=4):
    return ([_hits(store.range_search(q, tau)) for q in queries]
            + [_hits(store.top_k(q, k)) for q in queries])


def _segment(store_dir, name):
    gens = sorted(d for d in os.listdir(store_dir) if d.startswith("seg-"))
    assert gens, store_dir
    return os.path.join(store_dir, gens[-1], name)


def _segments(store_dir):
    gen = os.path.dirname(_segment(store_dir, "x"))
    return {name: open(os.path.join(gen, name), "rb").read()
            for name in os.listdir(gen)}


def _warm_stats_ok(store):
    s = store.stats
    assert s["filter_packed_rows"] == 0, "warm open re-packed stage 0"
    assert s.get("index_signatures_built", 0) == 0, "warm open re-sketched"
    assert s["open_wall_s"] > 0 and s["ingest_wall_s"] == 0


# ------------------------------------------------- one format, two packages

@pytest.mark.parametrize("index", ["auto", None])
def test_stores_open_across_packages_with_identical_hits(tmp_path, index):
    corpus = _corpus(0, 12)
    queries = [corpus[0], corpus[3], plain(perturb(
        np.random.default_rng(5), ged.as_graph(corpus[1]), 1, n_vlabels=3,
        n_elabels=2))]
    port = ged.GraphStore(corpus, index=index, **PORT)
    ref = ref_ged.GraphStore(corpus, index=index, **STORE_OPTS)
    want = _answers(ref, queries)
    assert _answers(port, queries) == want
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    assert _segments(str(tmp_path / "port")) == \
        _segments(str(tmp_path / "ref"))
    ma, mb = (json.loads((tmp_path / d / MANIFEST_NAME).read_text())
              for d in ("port", "ref"))
    assert (ma["kind"], ma["version"], ma["checksum"]) == \
        (mb["kind"], mb["version"], mb["checksum"])

    warm = ged.GraphStore.open(str(tmp_path / "ref"), **PORT)
    _warm_stats_ok(warm)
    assert _answers(warm, queries) == want
    assert len(warm) == len(port)
    back = ref_ged.GraphStore.open(str(tmp_path / "port"), **STORE_OPTS)
    assert back.stats["filter_packed_rows"] == 0
    assert _answers(back, queries) == want


def test_warm_open_equals_fresh_and_splits_ingest_wall(tmp_path):
    corpus = _corpus(1, 10)
    fresh = ged.GraphStore(corpus, **PORT)
    s = fresh.stats
    assert s["ingest_wall_s"] >= s["vocab_wall_s"] + s["pack_wall_s"] > 0
    assert s["open_wall_s"] == 0
    want = _answers(fresh, [corpus[0], corpus[5]])
    fresh.save(str(tmp_path / "db"))
    warm = ged.GraphStore.open(str(tmp_path / "db"), **PORT)
    _warm_stats_ok(warm)
    assert _answers(warm, [corpus[0], corpus[5]]) == want
    assert all(t.device.type == "cpu"
               for b in warm._index.buckets for t in b.resident)
    with pytest.raises(StoreIOError):
        ged.GraphStore.open(str(tmp_path / "nope"), device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(StoreIOError):
        ged.GraphStore.open(str(tmp_path / "empty"), device="cpu")


# ------------------------------------------------- corruption recovery

@pytest.mark.parametrize("segment,how", [("digests.exact.npy", "truncate"),
                                         ("index.sigs.npy", "bitflip")])
def test_corrupt_derived_segment_rebuilds(tmp_path, segment, how):
    corpus = _corpus(2, 10)
    fresh = ged.GraphStore(corpus, **PORT)
    want = _answers(fresh, [corpus[0], corpus[5]])
    fresh.save(str(tmp_path / "db"))
    path = _segment(str(tmp_path / "db"), segment)
    with open(path, "r+b") as f:
        if how == "truncate":
            f.truncate(os.path.getsize(path) // 2)
        else:
            f.seek(os.path.getsize(path) - 4)
            f.write(b"\xff\xff\xff\xff")
    with pytest.warns(RuntimeWarning, match="re-deriving"):
        warm = ged.GraphStore.open(str(tmp_path / "db"), **PORT)
    assert _answers(warm, [corpus[0], corpus[5]]) == want
    assert warm.stats["index_signatures_built"] > 0   # rebuild really ran


def _corrupt_primary(d):
    path = _segment(str(d), "graphs.vlabels.npy")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _truncate_manifest(d):
    m = d / MANIFEST_NAME
    m.write_text(m.read_text()[:40])


def _bump_schema(d):
    m = d / MANIFEST_NAME
    raw = json.loads(m.read_text())
    raw["version"] += 1
    m.write_text(json.dumps(raw))


@pytest.mark.parametrize("damage,error", [
    (_corrupt_primary, "CorruptStoreError"),
    (_truncate_manifest, "StoreIOError"),
    (_bump_schema, "SchemaVersionError")],
    ids=["primary", "manifest", "schema"])
def test_unreadable_store_raises_then_heals_with_graphs(tmp_path, damage,
                                                        error):
    corpus = _corpus(4, 9)
    fresh = ged.GraphStore(corpus, **PORT)
    want = _answers(fresh, [corpus[0]])
    fresh.save(str(tmp_path / "db"))
    damage(tmp_path / "db")
    with pytest.raises(getattr(store_io, error)):
        ged.GraphStore.open(str(tmp_path / "db"), **PORT)
    with pytest.raises(getattr(ref_store_io, error)):   # as the reference
        ref_ged.GraphStore.open(str(tmp_path / "db"), **STORE_OPTS)
    with pytest.warns(RuntimeWarning, match="re-ingesting"):
        healed = ged.GraphStore.open(str(tmp_path / "db"), graphs=corpus,
                                     **PORT)
    assert _answers(healed, [corpus[0]]) == want
    warm = ged.GraphStore.open(str(tmp_path / "db"), **PORT)
    assert _answers(warm, [corpus[0]]) == want


def test_crash_mid_save_keeps_previous_generation(tmp_path):
    corpus = _corpus(7, 8)
    store = ged.GraphStore(corpus, **PORT)
    want = _answers(store, [corpus[0]])
    store.save(str(tmp_path / "db"))
    crash = tmp_path / "db" / "seg-00000002.tmp-crashed"
    crash.mkdir()
    (crash / "graphs.ids.npy").write_bytes(b"partial write")
    warm = ged.GraphStore.open(str(tmp_path / "db"), **PORT)
    assert _answers(warm, [corpus[0]]) == want


# ------------------------------------------------ journal & compaction

def test_journal_roundtrip_add_remove_compact_equals_reference(tmp_path):
    corpus = _corpus(8, 10)
    extra = [plain(perturb(np.random.default_rng(80),
                           ged.as_graph(corpus[2]), 1, n_vlabels=3,
                           n_elabels=2))] + _extra(81, 1)
    queries = [corpus[0], extra[0]]
    port = ged.GraphStore(corpus, **PORT)
    ref = ref_ged.GraphStore(corpus, **STORE_OPTS)
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    for s in (port, ref):
        assert s.add(extra) == [len(corpus), len(corpus) + 1]
        s.remove([1, len(corpus)])
        assert s.stats["journal_pending"] == 2
    want = _answers(ref, queries)
    assert _answers(port, queries) == want

    # journals replay in either package
    for d in ("port", "ref"):
        warm = ged.GraphStore.open(str(tmp_path / d), **PORT)
        assert len(warm) == len(ref)
        assert _answers(warm, queries) == want, d
    back = ref_ged.GraphStore.open(str(tmp_path / "port"), **STORE_OPTS)
    assert _answers(back, queries) == want

    port.compact()
    assert (port.stats["journal_pending"], port.stats["compactions"]) == (0, 1)
    assert _answers(port, queries) == want
    warm2 = ged.GraphStore.open(str(tmp_path / "port"), **PORT)
    assert _answers(warm2, queries) == want
    hit_ids = {h.graph_id for h in warm2.range_search(corpus[1], 100.0)}
    assert 1 not in hit_ids and len(corpus) not in hit_ids


def test_interrupted_journal_append_is_dropped(tmp_path):
    corpus = _corpus(9, 8)
    store = ged.GraphStore(corpus, **PORT)
    store.save(str(tmp_path / "db"))
    store.add(_extra(90, 1))
    jdir = tmp_path / "db" / "journal"
    entries = sorted(p for p in os.listdir(jdir) if p.endswith(".json"))
    last = jdir / entries[-1]
    last.write_text(last.read_text()[:25])
    with pytest.warns(RuntimeWarning):
        warm = ged.GraphStore.open(str(tmp_path / "db"), **PORT)
    assert len(warm) == len(corpus)          # the torn add never lands


def test_auto_compaction_and_stable_ids(tmp_path):
    corpus = _corpus(10, 6)
    store = ged.GraphStore(corpus, **PORT)
    with pytest.raises(RuntimeError, match="save"):
        store.compact()
    store.save(str(tmp_path / "db"))
    store.compact_every = 3
    for i in range(3):
        store.add(_extra(100 + i, 1))
    assert store.stats["compactions"] == 1
    assert store.stats["journal_pending"] == 0
    store.remove([2])
    with pytest.raises(KeyError):
        store.remove([2])                    # already tombstoned
    with pytest.raises(KeyError):
        store.remove([10 ** 6])              # never existed
    assert store.add(_extra(110, 1)) == [len(corpus) + 3]   # never reused
    warm = ged.GraphStore.open(str(tmp_path / "db"), **PORT)
    assert len(warm) == len(store)
