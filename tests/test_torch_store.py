"""The port's corpus layer (``GraphStore``, stage-0 ``FilterIndex``, the
store's staged search) against the reference ``repro.ged``, on the CPU.

The same corpora and queries, made from a numpy seed with the sizes and
options of ``tests/test_graph_store.py`` (``STORE_OPTS``, ``_corpus``),
go through ``repro_torch.ged.GraphStore(device="cpu")`` and
``repro.ged.GraphStore``.  Hits of ``range_search``, ``top_k`` and
``search_batch``, and the outcomes of ``verify_members``, are compared
field by field (graph id, stage, query id, ged, similar, certified,
bounds, backend, tau, stats and mapping), and the store's counters
exactly (every key but the engine's and the wall times).  The stage-0
bounds are compared exactly with the reference's ``jnp`` pass.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro.core.engine import corpus as ref_corpus  # noqa: E402
from repro.ged import filters as ref_filters  # noqa: E402
from repro.ged import plan as ref_plan  # noqa: E402
from repro.ged import results as ref_results  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.core.engine import corpus  # noqa: E402
from repro_torch.core.exact.brute import brute_force_ged  # noqa: E402
from repro_torch.data.graphs import perturb, random_graph  # noqa: E402
from repro_torch.ged import filters, plan, results  # noqa: E402
from repro_torch.ged.exec import Executor  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

STORE_OPTS = dict(pool=256, expand=4, max_iters=256, batch_size=8)
CPU = Executor(device="cpu")


@pytest.fixture(autouse=True)
def _isolated_table():
    saved = autotune.snapshot()
    autotune.reset()
    yield
    autotune.restore(saved)


def plain(g):
    """A port graph as ``(vlabels, edges)``, readable by both packages."""
    return (g.vlabels.tolist(), [tuple(int(x) for x in e)
                                 for e in g.edges()])


def _corpus(seed, count, nmin=3, nmax=7, planted=2):
    """Random small graphs plus a few near-duplicates of the first one
    (``tests/test_graph_store.py``'s corpus), as plain tuples."""
    rng = np.random.default_rng(seed)
    graphs = [random_graph(rng, int(rng.integers(nmin, nmax + 1)),
                           density=0.4, n_vlabels=3, n_elabels=2)
              for _ in range(count)]
    for _ in range(planted):
        graphs.append(perturb(rng, graphs[0], int(rng.integers(1, 3)),
                              n_vlabels=3, n_elabels=2))
    return [plain(g) for g in graphs]


def _permuted(rng, g):
    vl, edges = g
    perm = rng.permutation(len(vl))
    inv = np.argsort(perm)
    return ([vl[int(p)] for p in perm],
            [(int(inv[i]), int(inv[j]), a) for i, j, a in edges])


def _outcome_row(o):
    mapping = None if o.mapping is None else o.mapping.tolist()
    return (o.ged, o.similar, o.certified, o.lower_bound, o.upper_bound,
            o.backend, o.tau, o.stats, mapping)


def _equal_slices(bucket, shards):
    """A feature bucket lies on ``shards`` devices as slices of one
    length, ceil(rows / shards): the resident rows pad to the mesh."""
    return len(bucket.shards) == shards and {
        sh[0].shape[0] for sh in bucket.shards} == {-(-len(bucket.ids)
                                                      // shards)}


def _hit_rows(hits):
    return [(h.graph_id, h.stage, h.query_id) + _outcome_row(h.outcome)
            for h in hits]


def _counters(stats):
    """Every store counter but the engine's and the wall times."""
    return {k: v for k, v in stats.items()
            if not k.startswith("engine_") and not k.endswith("_wall_s")}


def _stores(corpus, **kw):
    port = ged.GraphStore(corpus, device="cpu", **STORE_OPTS, **kw)
    ref = ref_ged.GraphStore(corpus, **STORE_OPTS, **kw)
    return port, ref


# ------------------------------------------------------ store answers

CONFIGS = {
    "index_auto": dict(),
    "index_none": dict(index=None),
    "recall": dict(index={"recall": 0.9, "reps": 1}),
    "pivots": dict(index={"pivot_seeds": 2, "pivot_min_candidates": 1}),
    "digest_exact": dict(digest="exact"),
}


@pytest.fixture(scope="module")
def workload():
    corpus = _corpus(21, 12, planted=3)
    rng = np.random.default_rng(22)
    novel = plain(random_graph(rng, 5, density=0.5, n_vlabels=5,
                               n_elabels=3))   # labels the corpus lacks
    corpus.append(_permuted(rng, corpus[2]))   # isomorphic duplicate
    corpus.append(corpus[3])                   # identical duplicate
    return corpus, [corpus[0], corpus[4], novel]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_search_answers_and_counters_equal_reference(workload, config):
    corpus, queries = workload
    port, ref = _stores(corpus, **CONFIGS[config])
    assert _counters(port.stats) == _counters(ref.stats)
    for q in queries:
        for tau in (0.0, 1.0, 2.0, 4.0):
            assert _hit_rows(port.range_search(q, tau)) == \
                _hit_rows(ref.range_search(q, tau)), (q, tau)
        for k in (1, 3, len(corpus) + 2):
            assert _hit_rows(port.top_k(q, k)) == \
                _hit_rows(ref.top_k(q, k)), (q, k)
    got, want = (s.search_batch(queries[:2], 2.0) for s in (port, ref))
    assert [_hit_rows(h) for h in got] == [_hit_rows(h) for h in want]
    ids, taus = [0, 2, 0, len(corpus) - 1, 5], [1.0, 9.0, 1.0, 0.0, 3.0]
    assert [_outcome_row(o) for o in port.verify_members(queries[0], ids,
                                                         taus)] == \
        [_outcome_row(o) for o in ref.verify_members(queries[0], ids, taus)]
    assert _counters(port.stats) == _counters(ref.stats)
    s = port.stats
    assert s["index_pruned"] + s["stage0_pruned"] + s["stage1_decided"] \
        + s["stage2_verified"] == s["candidates"]
    assert s["engine_pairs"] == ref.stats["engine_pairs"]


def test_range_and_top_k_equal_bruteforce():
    corpus = _corpus(0, 10)
    store = ged.GraphStore(corpus, device="cpu", **STORE_OPTS)
    graphs = [ged.as_graph(g) for g in corpus]
    for qi in (0, 3):
        truth = [brute_force_ged(graphs[qi], g) for g in graphs]
        for tau in (0.0, 2.0, 4.0):
            hits = store.range_search(corpus[qi], tau)
            assert sorted(h.graph_id for h in hits) == \
                sorted(i for i, t in enumerate(truth) if t <= tau)
            assert all(h.similar and h.certified and h.upper_bound <= tau
                       and h.stage in (results.STAGE_BOUND,
                                       results.STAGE_VERIFY) for h in hits)
            ub = [(h.upper_bound, h.graph_id) for h in hits]
            assert ub == sorted(ub)
        by_dist = sorted(range(len(graphs)), key=lambda i: (truth[i], i))
        hits = store.top_k(corpus[qi], 4)
        assert [h.graph_id for h in hits] == by_dist[:4]
        assert [h.ged for h in hits] == [truth[i] for i in by_dist[:4]]
    assert store.top_k(corpus[0], 0) == []


def test_dedup_and_wl_collisions_equal_reference():
    cycle = ([0] * 6, [(i, (i + 1) % 6, 1) for i in range(6)])
    triangles = ([0] * 6, [(0, 1, 1), (1, 2, 1), (0, 2, 1), (3, 4, 1),
                           (4, 5, 1), (3, 5, 1)])
    rng = np.random.default_rng(31)
    corpus = [cycle, triangles, _permuted(rng, triangles), triangles]
    for digest in ("wl", "exact"):
        port, ref = _stores(corpus, digest=digest)
        assert _counters(port.stats) == _counters(ref.stats), digest
        for q in (cycle, triangles):
            assert _hit_rows(port.range_search(q, 0.5)) == \
                _hit_rows(ref.range_search(q, 0.5)), digest
        assert port.member_id(corpus[2]) == ref.member_id(corpus[2])
        assert port.member_id(_permuted(rng, cycle)) is None
    assert port.stats["dedup_duplicates"] == 1
    wl = ged.GraphStore(corpus, device="cpu", **STORE_OPTS)
    assert (wl.stats["dedup_groups"], wl.stats["dedup_checks"]) == (2, 3)


def test_verify_members_answers_are_independent_and_checked():
    corpus = _corpus(32, 5, planted=0)
    store = ged.GraphStore(corpus, device="cpu", **STORE_OPTS)
    outs = store.verify_members(corpus[0], [0, 0, 1], [9.0, 9.0, 9.0])
    assert outs[0] is not outs[1]
    outs[0].stats["poison"] = 1
    assert "poison" not in outs[1].stats
    store.remove([1])
    with pytest.raises(KeyError):
        store.verify_members(corpus[0], [1], [1.0])
    with pytest.raises(KeyError):
        store.remove([1])


# ----------------------------------------------------------- stage 0

def test_stage0_lower_bounds_equal_reference_jnp():
    import jax.numpy as jnp
    rng = np.random.default_rng(40)
    b, lv, le, width = 37, 6, 3, 16
    q = [rng.integers(0, 5, size=s).astype(np.float32)
         for s in (lv + 1, le + 1, width)] + \
        [np.float32(rng.integers(1, 9)), np.float32(rng.integers(0, 9))]
    c = [rng.integers(0, 5, size=(b,) + s).astype(np.float32)
         for s in ((lv + 1,), (le + 1,), (width,), (), ())]
    want = np.asarray(ref_corpus.stage0_lower_bounds(
        *(jnp.asarray(a) for a in q + c)))
    got = corpus.stage0_lower_bounds(
        *(torch.as_tensor(a) for a in q + c)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def _graphs(seed, count, nmin=2, nmax=9, n_vlabels=3):
    rng = np.random.default_rng(seed)
    return [random_graph(rng, int(rng.integers(nmin, nmax + 1)),
                         density=0.4, n_vlabels=n_vlabels, n_elabels=2)
            for _ in range(count)]


def test_filter_index_scans_equal_reference():
    graphs = _graphs(24, 17)
    ref_graphs = [ref_ged.as_graph(plain(g)) for g in graphs]
    vocab = plan.graphs_vocab(graphs)
    assert vocab == ref_plan.graphs_vocab(ref_graphs)
    idx = filters.FilterIndex(graphs, list(range(17)), vocab, CPU)
    ref = ref_filters.FilterIndex(ref_graphs, list(range(17)), vocab)
    queries = _graphs(25, 3, n_vlabels=5) + [graphs[3]]
    for q in queries:
        rq = ref_ged.as_graph(plain(q))
        assert idx.ids == ref.ids
        got = idx.scan(q)
        assert np.array_equal(got, np.asarray(ref.scan(rq)))
        for subset in ([0], [3, 11, 16], list(range(0, 17, 2))):
            assert idx.scan_subset(q, subset) == ref.scan_subset(rq, subset)
        lbs = dict(zip(idx.ids, got.tolist()))
        assert all(lbs[i] == corpus.stage0_reference(q, g)
                   for i, g in enumerate(graphs))
    assert idx.stats == ref.stats
    extra = _graphs(26, 4, nmin=8, nmax=12)
    idx.extend(graphs + extra, list(range(17, 21)))
    ref.extend(ref_graphs + [ref_ged.as_graph(plain(g)) for g in extra],
               list(range(17, 21)))
    assert idx.ids == ref.ids
    assert np.array_equal(idx.scan(queries[0]),
                          np.asarray(ref.scan(ref_ged.as_graph(
                              plain(queries[0])))))
    assert idx.stats == ref.stats


def test_stage0_scan_counts_new_shapes_only():
    graphs = _graphs(30, 8, nmin=3, nmax=6)
    idx = filters.FilterIndex(graphs, list(range(8)),
                              plan.graphs_vocab(graphs), CPU)
    rng = np.random.default_rng(31)
    t0 = corpus.scan_traces()
    idx.scan(random_graph(rng, 4, density=0.4, n_vlabels=3, n_elabels=2))
    assert corpus.scan_traces() - t0 >= 1          # first query: new shapes
    t1 = corpus.scan_traces()
    idx.scan(random_graph(rng, 3, density=0.4, n_vlabels=3, n_elabels=2))
    assert corpus.scan_traces() - t1 == 0          # same buckets: none new


# ---------------------------------------------------------- schema bits

def test_plan_vocab_and_result_schema_equal_reference():
    graphs = _graphs(41, 6, n_vlabels=7)
    ref_graphs = [ref_ged.as_graph(plain(g)) for g in graphs]
    assert plan.graphs_vocab(graphs) == ref_plan.graphs_vocab(ref_graphs)
    base = ((0, 3), (1,))
    assert plan.merge_vocab(base, graphs[:3]) == \
        ref_plan.merge_vocab(base, ref_graphs[:3])
    for name in ("STAGE_INDEX", "STAGE_FILTER", "STAGE_BOUND",
                 "STAGE_VERIFY"):
        assert getattr(results, name) == getattr(ref_results, name)
    assert [f.name for f in dataclasses.fields(results.SearchHit)] == \
        [f.name for f in dataclasses.fields(ref_results.SearchHit)]


# ---------------------------------------------------- options and devices

def test_mesh_raises_type_error_and_engine_options_are_exclusive(tmp_path):
    """``mesh=`` is ported: a store and a warm open on a two-shard CPU
    mesh split every feature bucket into two resident slices of equal
    length and answer like the reference's store (hits field by field,
    counters exactly); a mesh beside ``engine=`` raises ``TypeError`` as
    in the reference, and a mesh that is not a flat device sequence
    raises (``TypeError`` for a non-sequence, ``ValueError`` for a nested
    one)."""
    corpus = _corpus(50, 4)
    mesh = ["cpu"] * 2
    with pytest.raises(TypeError):
        ged.GraphStore(corpus, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="flat sequence"):
        ged.GraphStore(corpus, mesh=[mesh], device="cpu")
    port = ged.GraphStore(corpus, mesh=mesh, **STORE_OPTS)
    ref = ref_ged.GraphStore(corpus, **STORE_OPTS)
    assert port.executor.batch_multiple == 2
    assert all(_equal_slices(b, 2) for b in port._index.buckets)
    queries = [corpus[0], corpus[2]]
    want = [_hit_rows(h) for h in ref.search_batch(queries, 2.0)]
    assert [_hit_rows(h) for h in port.search_batch(queries, 2.0)] == want
    assert _counters(port.stats) == _counters(ref.stats)
    port.save(str(tmp_path / "db"))
    warm = ged.GraphStore.open(str(tmp_path / "db"), mesh=mesh,
                               **STORE_OPTS)
    assert warm.stats["filter_packed_rows"] == 0
    assert all(_equal_slices(b, 2) for b in warm._index.buckets)
    assert [_hit_rows(h) for h in warm.search_batch(queries, 2.0)] == want
    with pytest.raises(TypeError, match="exclusive"):
        ged.GraphStore(corpus, mesh=mesh,
                       engine=ged.GedEngine("torch", device="cpu"))
    eng = ged.GedEngine("torch", device="cpu")
    for bad in (dict(pool=8), dict(backend="exact"), dict(device="cpu")):
        with pytest.raises(TypeError, match="exclusive"):
            ged.GraphStore(corpus, engine=eng, **bad)
    shared = ged.GraphStore(corpus, engine=eng)
    assert shared.engine is eng and shared.executor is eng._backend.executor
    exact = ged.GraphStore(corpus, engine=ged.GedEngine("exact"),
                           device="cpu")
    assert exact.executor.device.type == "cpu"


def test_store_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = _corpus(51, 3)
    for call in (lambda: ged.GraphStore(corpus),
                 lambda: ged.GraphStore(corpus, backend="exact"),
                 lambda: ged.batch_signatures([ged.as_graph(corpus[0])])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    store = ged.GraphStore(corpus, device="cpu")
    assert store.executor.device.type == "cpu"
    assert all(t.device.type == "cpu"
               for b in store._index.buckets for t in b.resident)
