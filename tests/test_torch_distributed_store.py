"""``GraphStore`` and the GED services on ``torch.distributed`` meshes
(``repro_torch.launch.mesh.make_test_mesh``), on the CPU.

One group of four ``gloo`` processes (a ``file://`` store) is started once
for the module, with a timeout of its own, and runs every case in turn on
two meshes, ``(4,)`` ``("data",)`` and ``(2, 2)`` ``("data", "model")``:

* a corpus of 32 graphs at n 3-8 with planted near-duplicates, an
  isomorphic and an identical duplicate, under three index
  configurations (``"auto"``, ``None``, two seeded pivots with the
  result cache on, the last on the host-solver backend, whose store
  builds its own executor over the mesh): ``search_batch`` at tau 1 and
  3, ``range_search``, ``top_k(3)`` and ``verify_members``, then the
  store's counters, each rank's resident stage-0 rows and the
  signatures;
* ``save``, ``add``, ``remove``, a reopen that replays the journal, and
  ``compact``, with every call of the store's writers counted on each
  rank and the directory listed after each step, on both meshes and on
  ``(1, 4)`` ``("data", "model")``, where every rank replicates one
  shard;
* on the ``(4,)`` mesh: a directory saved by the reference
  ``repro.ged.GraphStore`` opened on every rank, and
  ``GedVerificationService(mesh=).register_corpus`` and
  ``GedSimilarityService(mesh=)``.

Each rank pickles what it saw.  The tests hold the ranks to each other
and, field by field as ``tests/test_torch_sharded.py`` compares them, to
the reference's one-device ``GraphStore`` (and the services to the
port's one-device services), computed in this process while the group
runs.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.data.graphs import perturb, random_graph  # noqa: E402
from repro_torch.serving.ged_service import (  # noqa: E402
    GedRequest, GedSimilarityService, GedVerificationService, SearchRequest)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
WORLD = 4
GROUP_TIMEOUT = 150          # seconds for the whole group; killed after
MESHES = {"data": ((4,), ("data",)),
          "data-model": ((2, 2), ("data", "model"))}
# the write case also runs where every rank is a replica of one shard
WRITE_MESHES = dict(MESHES, replicas=((1, 4), ("data", "model")))
SHARDS = {"data": 4, "data-model": 2}
OPTS = dict(pool=256, expand=4, max_iters=256, batch_size=8)
# store options a case; the host-solver backend has no executor, so that
# store builds its own over the mesh
CONFIGS = {"index_auto": dict(index="auto"), "index_none": dict(index=None),
           "pivots": dict(index={"pivot_seeds": 2, "pivot_min_candidates": 1},
                          backend="exact")}
SERVICE = dict(slots=16, batch_size=8)


def plain(g):
    return (g.vlabels.tolist(), [tuple(int(x) for x in e)
                                 for e in g.edges()])


def _corpus():
    """26 random graphs at n 3-8, four ``perturb``-ed copies of the first,
    an isomorphic copy of the third and an identical copy of the fourth
    (``tests/test_torch_store.py``'s shape), and three queries; plus the
    graphs a mutation adds."""
    rng = np.random.default_rng(41)
    graphs = [random_graph(rng, int(rng.integers(3, 9)), density=0.4,
                           n_vlabels=3, n_elabels=2) for _ in range(26)]
    graphs += [perturb(rng, graphs[0], int(rng.integers(1, 3)),
                       n_vlabels=3, n_elabels=2) for _ in range(4)]
    corpus = [plain(g) for g in graphs]
    vl, edges = corpus[2]
    perm = rng.permutation(len(vl))
    inv = np.argsort(perm)
    corpus.append(([vl[int(p)] for p in perm],
                   [(int(inv[i]), int(inv[j]), a) for i, j, a in edges]))
    corpus.append(corpus[3])
    added = [plain(perturb(rng, graphs[4], 1, n_vlabels=3, n_elabels=2)),
             corpus[7], plain(random_graph(rng, 6, density=0.4,
                                           n_vlabels=3, n_elabels=2))]
    return corpus, [corpus[0], corpus[4], corpus[-4]], added


def _outcome_row(o):
    mapping = None if o.mapping is None else o.mapping.tolist()
    return (o.ged, o.similar, o.certified, o.lower_bound, o.upper_bound,
            o.backend, o.tau, o.timed_out, o.degraded, o.stats, mapping)


def _hit_rows(hits):
    return [(h.graph_id, h.stage, h.query_id) + _outcome_row(h.outcome)
            for h in hits]


def _rows(answers):
    """Hits and outcomes of one store's answers, as comparable rows."""
    out = {}
    for key, got in answers.items():
        if key[0] == "batch":
            out[key] = [_hit_rows(h) for h in got]
        elif key == "members":
            out[key] = [_outcome_row(o) for o in got]
        else:
            out[key] = _hit_rows(got)
    return out


def _counters(stats):
    """Every store counter but the engine's and the wall times."""
    return {k: v for k, v in stats.items()
            if not k.startswith("engine_") and not k.endswith("_wall_s")}


# the calls every store of the module answers, in this order, here and in
# the ranks (which run this source too)
CALLS = textwrap.dedent("""
    TAUS = (1.0, 3.0)
    MEMBERS = ([0, 2, 0, 29, 5, 31], [1.0, 9.0, 1.0, 0.0, 3.0, 2.0])

    def _answers(store, queries):
        out = {("batch", tau): store.search_batch(queries, tau)
               for tau in TAUS}
        out["range"] = store.range_search(queries[1], 2.0)
        out["top"] = store.top_k(queries[0], 3)
        out["members"] = store.verify_members(queries[2], *MEMBERS)
        return out

    def _mutate(store, added):
        ids = store.add(added)
        store.remove([ids[0], 5])
        return ids
""")
exec(CALLS)


# --------------------------------------------------------- the rank group

RANK = CALLS + textwrap.dedent("""
    import datetime, os, pickle, sys, time
    import torch
    import torch.distributed as dist
    from repro_torch import ged
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serving.ged_service import (
        GedRequest, GedSimilarityService, GedVerificationService,
        SearchRequest)
    from repro_torch.store_io import graphstore_io

    rank, store, path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    cfg = pickle.loads(open(path, "rb").read())
    corpus, queries, opts = cfg["corpus"], cfg["queries"], cfg["opts"]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=cfg["world"],
                            timeout=datetime.timedelta(seconds=60))
    writes = {"save_store": 0, "append_journal": 0}

    def counted(name, real):
        def call(*args, **kwargs):
            writes[name] += 1
            return real(*args, **kwargs)
        return call

    for name in writes:
        setattr(graphstore_io, name,
                counted(name, getattr(graphstore_io, name)))

    def resident(st):
        rows = []
        for b in st._index.buckets:
            lo = b.first * b.shards[0][0].shape[0]
            n = b.features.batch
            take = [min(lo + i, n - 1) for i in range(b.shards[0][0].shape[0])]
            same = all(torch.equal(t, torch.as_tensor(
                a[take]).to(torch.float32))
                for t, a in zip(b.shards[0], b.features.arrays()))
            rows.append((len(b.ids), [s[0].shape[0] for s in b.shards],
                         same))
        return rows

    def listing(d):
        return sorted(os.listdir(d)), sorted(
            os.listdir(os.path.join(d, "journal"))
            if os.path.isdir(os.path.join(d, "journal")) else [])

    rec = {}
    for key, (shape, axes) in cfg["write_meshes"].items():
        mesh = make_test_mesh(shape, axes)
        for name, kw in cfg["configs"].items() if key in cfg["meshes"] \
                else ():
            st = ged.GraphStore(corpus, mesh=mesh, **kw, **opts)
            got = _answers(st, queries)
            stats = st.stats
            rec[key, name] = dict(
                answers=got, stats=stats, resident=resident(st),
                executor=dict(st.executor.stats),
                sigs=None if st._cindex is None else st._cindex.sigs,
                reps=None if st._cindex is None else list(st._cindex.ids))
        d = os.path.join(cfg["tmp"], "saved-" + key)
        st = ged.GraphStore(corpus, mesh=mesh, **opts)
        steps = {}
        st.save(d)
        steps["save"] = (listing(d), dict(writes))
        dist.barrier()          # listed before the next write
        ids = _mutate(st, cfg["added"])
        steps["mutate"] = (listing(d), dict(writes))
        dist.barrier()          # listed before the next write
        live = st.range_search(queries[0], 2.0)
        again = ged.GraphStore.open(d, mesh=mesh, **opts)
        reopened = again.range_search(queries[0], 2.0)
        st.compact()
        steps["compact"] = (listing(d), dict(writes))
        dist.barrier()          # listed before the next write
        warm = ged.GraphStore.open(d, mesh=mesh, **opts)
        rec[key, "write"] = dict(
            ids=ids, steps=steps, live=live, reopened=reopened,
            compacted=warm.range_search(queries[0], 2.0),
            packed=(again.stats["filter_packed_rows"],
                    warm.stats["filter_packed_rows"]))
        for w in writes:
            writes[w] = 0
    mesh = make_test_mesh(*cfg["meshes"]["data"])
    t0 = time.perf_counter()
    while not os.path.exists(cfg["ref_done"]):
        assert time.perf_counter() - t0 < 120, "no reference directory"
        time.sleep(0.2)
    st = ged.GraphStore.open(cfg["ref_dir"], mesh=mesh, **opts)
    rec["ref_open"] = dict(hits=st.search_batch(queries, 3.0),
                           resident=resident(st))
    svc = GedVerificationService(mesh=mesh, **cfg["service"])
    svc.register_corpus(corpus)
    rec["verification"] = svc.verify([GedRequest(
        ged.as_graph(q), ged.as_graph(g), tau=t)
        for q, g, t in cfg["requests"]])
    sim = GedSimilarityService(corpus, mesh=mesh, **opts)
    rec["similarity"] = sim.search([SearchRequest(queries[0], tau=2.0),
                                    SearchRequest(queries[1], k=3)])
    rec["executor"] = {k: v for k, v in sim.store.stats.items()
                       if k.startswith("engine_executor_")}
    dist.barrier()
    dist.destroy_process_group()
    open(out, "wb").write(pickle.dumps(rec))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the rank group, compute the reference's and the one-device
    answers meanwhile, then wait for it (killed on timeout)."""
    tmp = tmp_path_factory.mktemp("distributed_store")
    corpus, queries, added = _corpus()
    requests = [(queries[0], corpus[i], t) for i, t in
                ((0, 1.0), (27, 2.0), (3, 2.0), (31, 0.0), (12, 3.0))]
    requests.append((queries[1], plain(random_graph(
        np.random.default_rng(43), 5, density=0.4, n_vlabels=3,
        n_elabels=2)), 2.0))
    ref_dir, ref_done = tmp / "ref-saved", tmp / "ref-saved.done"
    (tmp / "in.pkl").write_bytes(pickle.dumps(dict(
        corpus=corpus, queries=queries, added=added, world=WORLD,
        meshes=MESHES, write_meshes=WRITE_MESHES, configs=CONFIGS,
        opts=OPTS, service=SERVICE,
        requests=requests, tmp=str(tmp), ref_dir=str(ref_dir),
        ref_done=str(ref_done))))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(tmp / "store"),
         str(tmp / "in.pkl"), str(tmp / f"rank{r}.pkl")], env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    t0 = time.perf_counter()
    try:
        ref = {}
        for name, kw in CONFIGS.items():
            st = ref_ged.GraphStore(corpus, **kw, **OPTS)
            if name == "index_auto":
                st.save(str(ref_dir))
                ref_done.write_text("")
                warm = ref_ged.GraphStore.open(str(ref_dir), **OPTS)
                ref["ref_open"] = [_hit_rows(h)
                                   for h in warm.search_batch(queries, 3.0)]
            ref[name] = (_rows(_answers(st, queries)), _counters(st.stats),
                         st._cindex)
        st = ref_ged.GraphStore(corpus, **OPTS)
        ids = _mutate(st, added)
        ref["write"] = (ids, _hit_rows(st.range_search(queries[0], 2.0)))
        one = {}
        svc = GedVerificationService(device="cpu", **SERVICE)
        svc.register_corpus(corpus)
        one["verification"] = svc.verify([GedRequest(
            ged.as_graph(q), ged.as_graph(g), tau=t)
            for q, g, t in requests])
        sim = GedSimilarityService(corpus, device="cpu", **OPTS)
        one["similarity"] = sim.search([SearchRequest(queries[0], tau=2.0),
                                        SearchRequest(queries[1], k=3)])
        for r, p in enumerate(procs):
            left = max(1.0, GROUP_TIMEOUT - (time.perf_counter() - t0))
            _, err = p.communicate(timeout=left)
            assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(WORLD)]
    return dict(corpus=corpus, added=added, ref=ref, one=one, recs=recs)


def _same_on_every_rank(rows):
    assert all(r == rows[0] for r in rows[1:])
    return rows[0]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_returns_the_reference_stores_hits(ranks, mesh, config):
    """``search_batch`` at tau 1 and 3, ``range_search``, ``top_k(3)``
    and ``verify_members``: equal on every rank and, field by field, to
    the reference's one-device ``GraphStore``."""
    got = _same_on_every_rank([_rows(rec[mesh, config]["answers"])
                               for rec in ranks["recs"]])
    want = ranks["ref"][config][0]
    assert got == want
    assert any(got["batch", 3.0]) and got["top"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_ranks_counters_equal_the_reference(ranks, mesh, config):
    """The store's counters after the same calls, every key but the
    engine's and the walls; each rank gathered its stage-0 bounds and
    signatures over the group."""
    want = ranks["ref"][config][1]
    for rec in ranks["recs"]:
        stats = rec[mesh, config]["stats"]
        assert _counters(stats) == want
        executor = rec[mesh, config]["executor"]
        assert executor["shard_gathers"] >= 1 and executor["gathers"] >= 1


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_each_rank_holds_only_its_slice_of_every_bucket(ranks, mesh):
    """One resident slice a rank, ceil(rows / shards) long, holding the
    host arrays' rows of the rank's shard (the filler repeats the last
    row); the ranks of a replicated shard hold the same rows."""
    shards = SHARDS[mesh]
    for config in CONFIGS:
        for rec in ranks["recs"]:
            buckets = rec[mesh, config]["resident"]
            assert len(buckets) >= 2
            for rows, slices, same in buckets:
                assert slices == [-(-rows // shards)] and same


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_signatures_are_byte_equal_to_wl_signature(ranks, mesh):
    corpus = [ged.as_graph(g) for g in ranks["corpus"]]
    for config in ("index_auto", "pivots"):
        want = ranks["ref"][config][2]
        for rec in ranks["recs"]:
            got = rec[mesh, config]
            assert got["reps"] == list(want.ids)
            host = np.stack([ged.wl_signature(corpus[i]) for i in
                             got["reps"]])
            assert got["sigs"].dtype == host.dtype
            assert got["sigs"].tobytes() == host.tobytes() == \
                np.asarray(want.sigs).tobytes()


@pytest.mark.parametrize("mesh", sorted(WRITE_MESHES))
def test_writes_come_once_from_the_first_rank(ranks, mesh):
    """``save`` writes one generation, ``add`` and ``remove`` one journal
    entry each, ``compact`` one more generation and folds the journal:
    the first rank calls the writers, the others none, and every rank
    sees the same directory after each step."""
    steps = {k: _same_on_every_rank([rec[mesh, "write"]["steps"][k][0]
                                     for rec in ranks["recs"]])
             for k in ("save", "mutate", "compact")}
    assert steps["save"] == (["graphstore.json", "seg-00000000"], [])
    assert steps["mutate"] == (["graphstore.json", "journal",
                                "seg-00000000"],
                               ["j-00000001.json", "j-00000001.seg",
                                "j-00000002.json"])
    assert steps["compact"] == (["graphstore.json", "journal",
                                 "seg-00000001"], [])
    for r, rec in enumerate(ranks["recs"]):
        calls = [rec[mesh, "write"]["steps"][k][1]
                 for k in ("save", "mutate", "compact")]
        want = [{"save_store": 1, "append_journal": 0},
                {"save_store": 1, "append_journal": 2},
                {"save_store": 2, "append_journal": 2}]
        assert calls == (want if r == 0 else [
            dict.fromkeys(c, 0) for c in want]), r


@pytest.mark.parametrize("mesh", sorted(WRITE_MESHES))
def test_a_reopen_on_every_rank_gives_the_same_hits(ranks, mesh):
    """After ``add`` / ``remove``: the live store, a reopen that replays
    the journal and a reopen of the compacted snapshot (nothing
    re-packed) equal the reference store given the same mutations."""
    ids, want = ranks["ref"]["write"]
    for rec in ranks["recs"]:
        w = rec[mesh, "write"]
        assert w["ids"] == ids
        for key in ("live", "reopened", "compacted"):
            assert _hit_rows(w[key]) == want, key
        assert w["packed"][1] == 0


def test_a_reference_saved_directory_opens_on_every_rank(ranks):
    want = ranks["ref"]["ref_open"]
    for rec in ranks["recs"]:
        got = rec["ref_open"]
        assert [_hit_rows(h) for h in got["hits"]] == want
        assert all(s == [-(-rows // 4)] and same
                   for rows, s, same in got["resident"])


@pytest.mark.parametrize("service", ["verification", "similarity"])
def test_the_services_answer_like_one_device(ranks, service):
    """``register_corpus`` on ``GedVerificationService(mesh=)`` (in-corpus
    targets through the store) and ``GedSimilarityService(mesh=)``."""
    def rows(got):
        return ([_outcome_row(o) for o in got] if service == "verification"
                else [_hit_rows(h) for h in got])

    got = _same_on_every_rank([rows(rec[service]) for rec in ranks["recs"]])
    assert got == rows(ranks["one"][service])
    for rec in ranks["recs"]:
        assert rec["executor"]["engine_executor_shard_gathers"] >= 1
