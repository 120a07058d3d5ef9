"""The port's result cache, graph digests, streaming and cross-process
cache tier against the reference ``repro.ged``, on the CPU.

The same pairs, made from a numpy seed, go through ``repro_torch`` and
``repro``: digests must be byte-equal, cached outcomes and the
``result_cache_*`` counters equal, and a shared-cache directory written
by either package must be read by the other with equal scalars.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro.data.graphs import aids_like_graph, perturb, random_graph  # noqa: E402
from repro.ged import exec as ref_exec  # noqa: E402
from repro.store_io import atomic as ref_atomic  # noqa: E402
from repro.store_io.shared_cache import \
    SharedResultCache as RefSharedResultCache  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.ged import exec as gexec  # noqa: E402
from repro_torch.ged.results import GedOutcome  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.store_io import SHARED_CACHE_ENV, atomic  # noqa: E402
from repro_torch.store_io.shared_cache import SharedResultCache  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(pool=64, expand=4, max_iters=64)
RUNGS = ((4, 1, 2), (8, 2, 4))
# the reference backend each port backend is held to
REF_BACKEND = {"torch": "jax", "cuda": "jax", "auto": "auto",
               "exact": "exact"}


@pytest.fixture(autouse=True)
def _no_cache_env(monkeypatch):
    """The shared-cache and compile-cache variables are read by both
    packages; no test here may pick up the caller's."""
    monkeypatch.delenv(SHARED_CACHE_ENV, raising=False)
    monkeypatch.delenv(gexec.COMPILE_CACHE_ENV, raising=False)


@pytest.fixture
def _build_dir_reset():
    saved = dict(_build._CACHE)
    yield
    _build._CACHE.update(saved)


def _pairs(seed, count, n_lo=3, n_hi=7):
    """(vlabels, edges) pairs, plain lists, readable by both packages:
    identical graphs, small edits and unrelated graphs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        g = aids_like_graph(rng, int(rng.integers(n_lo, n_hi + 1)),
                            n_vlabels=4, n_elabels=2)
        if i % 3 == 0:
            h = g.copy()
        elif i % 3 == 1:
            h = perturb(rng, g, int(rng.integers(1, 4)), n_vlabels=4,
                        n_elabels=2)
        else:
            h = random_graph(rng, int(rng.integers(n_lo, n_hi + 1)),
                             density=0.4, n_vlabels=4, n_elabels=2)
        out.append(tuple((x.vlabels.tolist(), list(x.edges()))
                         for x in (g, h)))
    return out


def _permuted(rng, graph):
    """An isomorphic copy of a (vlabels, edges) graph, vertices shuffled."""
    vlabels, edges = graph
    perm = rng.permutation(len(vlabels))
    where = np.argsort(perm)
    return ([vlabels[p] for p in perm],
            [(int(where[i]), int(where[j]), a) for i, j, a in edges])


def _engines(backend, port_kw=None, ref_kw=None):
    """A port engine and the reference engine it is held to, both with
    the result cache on (the default)."""
    kw = {} if backend in ("auto", "exact") else dict(slots=8, **SMALL)
    port = ged.GedEngine(backend, device="cpu", **kw, **(port_kw or {}))
    ref = ref_ged.GedEngine(REF_BACKEND[backend], **kw, **(ref_kw or {}))
    if backend == "auto":
        for e in (port, ref):
            e._backend.scheduler.rungs = RUNGS
    return port, ref


def _same(a, b, backend=True):
    assert (a.ged, a.similar, a.certified, a.lower_bound, a.upper_bound,
            a.tau) == (b.ged, b.similar, b.certified, b.lower_bound,
                       b.upper_bound, b.tau)
    for k in ("rung", "iterations", "expanded", "cached"):
        assert a.stats.get(k) == b.stats.get(k), k
    if backend:
        assert a.backend == b.backend
    if a.mapping is None or b.mapping is None:
        assert a.mapping is None and b.mapping is None
    else:
        assert np.array_equal(a.mapping, b.mapping)


def _cache_counters(stats):
    return {k: v for k, v in stats.items()
            if k.startswith(("result_cache_", "index_pivot_"))}


def _count_runs(eng):
    """Wrap the engine's backend so every pair it runs is counted."""
    ran = []
    real = eng._backend.run

    def run(plan, taus, verification, cfg, **kw):
        ran.append(len(plan.pairs))
        return real(plan, taus, verification, cfg, **kw)

    eng._backend.run = run
    return ran


# ------------------------------------------------------------- digests

def _digest_graphs(seed):
    rng = np.random.default_rng(seed)
    graphs = [([], []), ([3], []), ([0, 0, 1], [])]           # tiny, edgeless
    for n in (2, 5, 9, 14):
        g = random_graph(rng, n, density=0.4, n_vlabels=3, n_elabels=3)
        graphs.append((g.vlabels.tolist(), list(g.edges())))
        graphs.append(_permuted(rng, graphs[-1]))
    return graphs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["exact", "wl"])
def test_digests_equal_the_reference(kind, seed):
    for x in _digest_graphs(seed):
        got = gexec.DIGESTS[kind](ged.as_graph(x))
        want = ref_exec.DIGESTS[kind](ref_ged.as_graph(x))
        assert isinstance(got, bytes) and got == want, x


def test_pair_key_is_mode_and_tau_aware():
    q, g = (ged.as_graph(x) for x in _pairs(0, 1)[0])
    comp = gexec.pair_key(q, g, False, None, None, "torch")
    assert comp != gexec.pair_key(q, g, True, 2.0, None, "torch")
    assert gexec.pair_key(q, g, True, 2.0, None, "torch") != \
        gexec.pair_key(q, g, True, 3.0, None, "torch")
    assert comp == gexec.pair_key(ged.as_graph(_pairs(0, 1)[0][0]), g,
                                  False, None, None, "torch")
    assert comp[:5] == ref_exec.pair_key(
        ref_ged.as_graph(_pairs(0, 1)[0][0]),
        ref_ged.as_graph(_pairs(0, 1)[0][1]), False, None, None, "jax")[:5]


def test_engine_cache_is_tau_and_mode_aware():
    pairs = _pairs(16, 3)
    port, ref = _engines("torch")
    for eng in (port, ref):
        eng.compute(pairs)
        eng.verify(pairs, 3.0)            # different mode: all misses
        assert eng.stats["result_cache_hits"] == 0
        eng.verify(pairs, 4.0)            # different tau: all misses
        assert eng.stats["result_cache_hits"] == 0
        eng.verify(pairs, 3.0)            # same tau: all hits
        assert eng.stats["result_cache_hits"] == len(pairs)
    assert _cache_counters(port.stats) == _cache_counters(ref.stats)


def test_engine_cache_key_is_vocab_independent():
    """The same pair hits even when its batch mates widen the label
    vocabulary."""
    rng = np.random.default_rng(17)
    q = random_graph(rng, 4, density=0.4, n_vlabels=2, n_elabels=1)
    p0 = (q, perturb(rng, q, 1, n_vlabels=2, n_elabels=1))
    rich = random_graph(rng, 5, density=0.5, n_vlabels=6, n_elabels=3)
    p1 = (rich, perturb(rng, rich, 2, n_vlabels=6, n_elabels=3))
    p0, p1 = [tuple((x.vlabels.tolist(), list(x.edges())) for x in p)
              for p in (p0, p1)]
    eng = ged.GedEngine("torch", device="cpu", **SMALL)
    first = eng.compute([p0])[0]
    again = eng.compute([p0, p1])[0]
    assert eng.stats["result_cache_hits"] == 1
    assert again.ged == first.ged and again.stats["cached"] is True


# ------------------------------------------------------------- repeats

@pytest.mark.parametrize("backend", ["torch", "cuda", "auto", "exact"])
def test_repeats_answered_without_reexecution(backend):
    """The second call runs nothing, answers what the first did with
    ``"cached"`` in its stats, and equals the reference field by field,
    counters included."""
    pairs = _pairs(13, 6)
    port, ref = _engines(backend)
    ran = _count_runs(port)
    same_backend = backend in ("auto", "exact")
    first = port.compute(pairs)
    assert port.stats["result_cache_misses"] == len(pairs)
    calls = port.stats.get("executor_calls")
    assert sum(ran) == len(pairs)
    second = port.compute(pairs)
    assert sum(ran) == len(pairs), "cached pairs must not run again"
    assert port.stats.get("executor_calls") == calls
    assert port.stats["result_cache_hits"] == len(pairs)
    want = ref.compute(pairs), ref.compute(pairs)
    for got, exp in zip((first, second), want):
        for a, b in zip(got, exp):
            _same(a, b, backend=same_backend)
    for a, b in zip(first, second):
        assert b.stats.pop("cached") is True and "cached" not in a.stats
        _same(a, b)
    assert _cache_counters(port.stats) == _cache_counters(ref.stats)


def test_in_batch_duplicates_run_once_and_are_isolated():
    (p0, p1) = _pairs(15, 2)
    port, ref = _engines("torch")
    outs = port.compute([p0, p0, p1, p0])
    want = ref.compute([p0, p0, p1, p0])
    for a, b in zip(outs, want):
        _same(a, b, backend=False)
    assert port.stats["result_cache_misses"] == 2
    assert port.stats["result_cache_hits"] == 2
    assert port.stats["executor_pairs"] == 2
    assert _cache_counters(port.stats) == _cache_counters(ref.stats)
    # every position is its own outcome: mutating one (stats dict or
    # mapping array) leaks into neither its duplicates nor the cache
    outs[1].stats["caller_tag"] = 1
    assert "caller_tag" not in outs[3].stats
    if outs[1].mapping is not None:
        outs[1].mapping[:] = -7
        assert not np.array_equal(outs[3].mapping, outs[1].mapping)
    again = port.compute([p0])[0]
    assert "caller_tag" not in again.stats
    if again.mapping is not None:
        assert not np.array_equal(again.mapping, outs[1].mapping)


def test_cache_can_be_disabled():
    pairs = _pairs(18, 3)
    eng = ged.GedEngine("torch", device="cpu", cache=False, **SMALL)
    eng.compute(pairs)
    calls = eng.stats["executor_calls"]
    eng.compute(pairs + pairs[:1])           # no in-batch dedup either
    assert "result_cache_hits" not in eng.stats
    assert eng.stats["executor_calls"] == 2 * calls
    assert eng.stats["executor_pairs"] == 2 * len(pairs) + 1


# ----------------------------------------------------------- streaming

def test_submit_flush_order_and_modes_equal_the_reference():
    pairs = _pairs(5, 6)
    port, ref = _engines("exact")
    for eng in (port, ref):
        tickets = [eng.submit(q, g, tau=float(i) if i % 2 else None)
                   for i, (q, g) in enumerate(pairs)]
        assert tickets == list(range(len(pairs)))
    got, want = port.flush(), ref.flush()
    assert len(got) == len(pairs)
    for i, (a, b) in enumerate(zip(got, want)):
        _same(a, b)
        assert (a.ged is None) == bool(i % 2)
        assert a.tau == (float(i) if i % 2 else None)
    assert port.flush() == [] and ref.flush() == []
    assert _cache_counters(port.stats) == _cache_counters(ref.stats)


@pytest.mark.parametrize("option", ["deadline_s", "per_pair_deadline_s"])
def test_flush_deadlines_are_not_ported_yet(option):
    """The flush-level budgets are ported: ``flush(**{option: 1.0})``
    answers like the reference's flush given the same budget (the pair
    is small enough to certify well inside it), and the engine is
    drained after it."""
    pair = _pairs(6, 1)[0]
    port, ref = _engines("exact")
    for eng in (port, ref):
        eng.submit(*pair)
    got, want = port.flush(**{option: 1.0}), ref.flush(**{option: 1.0})
    assert len(got) == len(want) == 1
    _same(got[0], want[0])
    assert got[0].certified and not got[0].timed_out
    assert [o.ged for o in got] == \
        [o.ged for o in ref_ged.GedEngine("exact").compute([pair])]
    assert port.flush() == [] and ref.flush() == []


# ------------------------------------------------------ distance reuse

def test_cached_distance_probes_both_orientations_and_counts():
    rng = np.random.default_rng(20)
    a = random_graph(rng, 5, density=0.5, n_vlabels=3, n_elabels=2)
    b = perturb(rng, a, 1, n_vlabels=3, n_elabels=2)
    c = random_graph(rng, 4, density=0.5, n_vlabels=3, n_elabels=2)
    a, b, c = ((x.vlabels.tolist(), list(x.edges())) for x in (a, b, c))
    port, ref = _engines("exact")
    for eng in (port, ref):
        assert eng.cached_distance(a, b) is None     # cold cache
        d = eng.compute([(a, b)])[0].ged
        hits0 = eng.stats["result_cache_hits"]
        assert eng.cached_distance(b, a) == d        # reversed orientation
        assert eng.stats["result_cache_hits"] == hits0   # peek: no churn
        # a verification entry never answers a distance probe
        eng.verify([(a, c)], [0.0])
        assert eng.cached_distance(a, c) is None
    dq, dg = (gexec.graph_digest(ged.as_graph(x)) for x in (a, b))
    assert port.cached_distance(digests=(dq, dg)) == d
    assert ref.cached_distance(digests=(dq, dg)) == d
    assert port.stats["index_pivot_hits"] == 2
    assert port.stats["index_pivot_misses"] == 2
    assert _cache_counters(port.stats) == _cache_counters(ref.stats)
    assert ged.GedEngine("exact", cache=False).cached_distance(a, b) is None


# --------------------------------------------------------- WL digests

def test_wl_digest_hits_isomorphic_pairs_and_drops_mappings():
    rng = np.random.default_rng(8)
    q = random_graph(rng, 5, density=0.4, n_vlabels=3, n_elabels=2)
    g = perturb(rng, q, 2, n_vlabels=3, n_elabels=2)
    q, g = ((x.vlabels.tolist(), list(x.edges())) for x in (q, g))
    qp, gp = _permuted(rng, q), _permuted(rng, g)
    port, ref = _engines("torch", dict(digest="wl"), dict(digest="wl"))
    for eng in (port, ref):
        first = eng.compute([(q, g)])[0]
        second = eng.compute([(qp, gp)])[0]          # isomorphic: a hit
        assert eng.stats["result_cache_hits"] == 1
        assert second.stats.get("cached") and second.mapping is None
        assert second.ged == first.ged
    plain = ged.GedEngine("torch", device="cpu", **SMALL)
    plain.compute([(q, g)])
    plain.compute([(qp, gp)])                        # exact digest: miss
    assert plain.stats["result_cache_hits"] == 0


@pytest.mark.parametrize("digest", ["md5", "WL"])
def test_unknown_digest_raises(digest):
    for make in (lambda: ged.GedEngine("exact", digest=digest),
                 lambda: ref_ged.GedEngine("exact", digest=digest)):
        with pytest.raises(ValueError, match="unknown digest"):
            make()


# --------------------------------------------------------- shared tier

def _outcome(ged_val=2.0, certified=True):
    return GedOutcome(ged=ged_val, similar=True, certified=certified,
                      lower_bound=ged_val, upper_bound=ged_val,
                      mapping=None, backend="torch", wall_s=0.01, tau=4.0)


def _key(dq=b"q" * 16, dg=b"g" * 16, tau=4.0):
    return ("exact", dq, dg, True, tau, None, "torch")


def test_shared_cache_certified_only(tmp_path):
    cache = SharedResultCache(str(tmp_path))
    assert not cache.put(_key(), _outcome(certified=False))
    assert cache.get(_key()) is None and cache.misses == 1
    assert cache.put(_key(), _outcome())
    hit = cache.get(_key())
    assert (hit.ged, hit.certified, hit.backend) == (2.0, True,
                                                    "shared-cache")
    assert hit.mapping is None and hit.stats == {"cached": "shared"}


def test_shared_cache_orientation_symmetry(tmp_path):
    cache = SharedResultCache(str(tmp_path))
    cache.put(_key(b"a" * 16, b"b" * 16), _outcome())
    assert cache.get(_key(b"b" * 16, b"a" * 16)).ged == 2.0
    # tau is part of the key: another threshold misses
    assert cache.get(_key(b"a" * 16, b"b" * 16, tau=5.0)) is None


def test_shared_cache_corrupt_entry_is_a_miss(tmp_path):
    cache = SharedResultCache(str(tmp_path))
    cache.put(_key(), _outcome())
    with open(cache._path(_key()), "w") as f:
        f.write('{"torn": ')
    assert cache.get(_key()) is None
    assert cache.misses == 1


def test_shared_cache_lru_eviction(tmp_path):
    cache = SharedResultCache(str(tmp_path), max_entries=2, sweep_every=1)
    keys = [_key(bytes([i]) * 16, bytes([i + 100]) * 16) for i in range(4)]
    for k in keys:
        cache.put(k, _outcome())
    assert cache.entries() == 2
    assert cache.evictions == 2
    assert cache.get(keys[-1]) is not None   # newest survives


@pytest.mark.parametrize("tau", [None, 0.0, 4.0])
def test_shared_cache_entry_path_and_bytes_equal_the_reference(tmp_path,
                                                               tau):
    port = SharedResultCache(str(tmp_path / "port"))
    ref = RefSharedResultCache(str(tmp_path / "ref"))
    key = ("exact", b"\x01" * 16, b"\x00" * 16, tau is not None, tau,
           None, "torch")
    assert os.path.basename(port._path(key)) == \
        os.path.basename(ref._path(key))
    out = _outcome()
    out.upper_bound = float("inf") if tau == 0.0 else out.upper_bound
    port.put(key, out)
    ref.put(key, out)
    with open(port._path(key), "rb") as a, open(ref._path(key), "rb") as b:
        assert a.read() == b.read()


def test_shared_cache_fails_open_on_a_lock_timeout(tmp_path):
    """A peer holding the lock costs a bounded wait: the entry is still
    written (atomically), the sweep skipped, the event counted."""
    cache = SharedResultCache(str(tmp_path), lock_timeout_s=0.05)
    with atomic.file_lock(cache._lock_path):
        assert cache.put(_key(), _outcome())
    assert cache.lock_timeouts == 1
    assert cache.get(_key()).ged == 2.0


def test_engine_shared_cache_across_instances(tmp_path):
    """Two engines (stand-ins for two processes) share certified verdicts
    through the directory; the repeat is answered from memory."""
    q, g = _pairs(12, 2)[1]
    eng1 = ged.GedEngine("exact", shared_cache_dir=str(tmp_path))
    out1 = eng1.verify([(q, g)], [4.0])[0]
    assert out1.certified and eng1.stats["shared_cache_entries"] >= 1
    eng2 = ged.GedEngine("exact", shared_cache_dir=str(tmp_path))
    out2 = eng2.verify([(q, g)], [4.0])[0]
    assert out2.backend == "shared-cache"
    assert (out2.ged, out2.similar) == (out1.ged, out1.similar)
    assert eng2.stats["shared_cache_hits"] == 1
    eng2.verify([(q, g)], [4.0])                   # promoted to memory
    assert eng2.stats["shared_cache_hits"] == 1
    assert eng2.stats["result_cache_hits"] >= 1
    for key in ("shared_cache_misses", "shared_cache_evictions",
                "shared_cache_lock_timeouts"):
        assert key in eng2.stats, key


def test_engine_shared_cache_env_default(tmp_path, monkeypatch):
    monkeypatch.setenv(SHARED_CACHE_ENV, str(tmp_path))
    assert SHARED_CACHE_ENV == "REPRO_GED_SHARED_CACHE_DIR"
    assert ged.GedEngine("exact").shared_cache_dir == str(tmp_path)
    monkeypatch.delenv(SHARED_CACHE_ENV)
    assert ged.GedEngine("exact").shared_cache_dir is None


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_shared_cache_directory_is_read_by_the_other_package(tmp_path,
                                                             writer):
    """A directory written by one package answers every pair in the
    other as a shared hit with equal scalars, in both modes."""
    pairs = _pairs(21, 5)
    make = {"repro": lambda: ref_ged.GedEngine(
                "exact", shared_cache_dir=str(tmp_path)),
            "repro_torch": lambda: ged.GedEngine(
                "exact", device="cpu", shared_cache_dir=str(tmp_path))}
    reader_pkg = "repro_torch" if writer == "repro" else "repro"
    w = make[writer]()
    wrote = w.compute(pairs) + w.verify(pairs, 2.0)
    reader = make[reader_pkg]()
    ran = _count_runs(reader)
    read = reader.compute(pairs) + reader.verify(pairs, 2.0)
    assert ran == []
    assert reader.stats["shared_cache_hits"] == 2 * len(pairs)
    for a, b in zip(read, wrote):
        assert a.backend == "shared-cache" and a.mapping is None
        assert (a.ged, a.similar, a.certified, a.lower_bound,
                a.upper_bound, a.tau) == \
            (b.ged, b.similar, b.certified, b.lower_bound, b.upper_bound,
             b.tau)


CONTENTION_SCRIPT = textwrap.dedent("""
    import sys; sys.path.insert(0, %r)
    import multiprocessing as mp

    def worker(args):
        directory, wid = args
        from repro_torch.ged.results import GedOutcome
        from repro_torch.store_io import SharedResultCache
        cache = SharedResultCache(directory, max_entries=64, sweep_every=4)
        hits = 0
        for i in range(40):
            key = ("exact", bytes([i %% 8]) * 16, bytes([i %% 8 + 8]) * 16,
                   True, 4.0, None, "torch")
            out = GedOutcome(ged=float(i %% 8), similar=True,
                             certified=True, lower_bound=float(i %% 8),
                             upper_bound=float(i %% 8), mapping=None,
                             backend="torch", wall_s=0.0, tau=4.0)
            cache.put(key, out)
            got = cache.get(key)
            if got is not None:
                assert got.ged == float(i %% 8), (wid, i, got.ged)
                hits += 1
        return hits

    if __name__ == "__main__":
        directory = sys.argv[1]
        with mp.get_context("spawn").Pool(2) as pool:
            hits = pool.map(worker, [(directory, w) for w in range(2)])
        assert all(h > 0 for h in hits), hits
        print("OK", hits)
""")


def test_shared_cache_two_process_contention(tmp_path):
    """Two processes hammer one directory: every read sees a complete
    entry with the right scalars, never a torn one."""
    script = tmp_path / "contend.py"       # spawned workers import it
    script.write_text(CONTENTION_SCRIPT % str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "cache")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


# ------------------------------------------------------- atomic layer

@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_manifests_read_across_packages(tmp_path, writer):
    w, r = ((ref_atomic, atomic) if writer == "repro"
            else (atomic, ref_atomic))
    path = str(tmp_path / "m.json")
    w.write_manifest(path, {"a": [1, 2], "b": "x"}, kind="demo", version=3)
    assert r.read_manifest(path, kind="demo", version=3) == \
        {"a": [1, 2], "b": "x"}
    with pytest.raises(atomic.SchemaVersionError):
        atomic.read_manifest(path, kind="demo", version=4)
    with open(path, "r+") as f:
        text = f.read().replace('"x"', '"y"')
        f.seek(0)
        f.write(text)
        f.truncate()
    with pytest.raises(atomic.CorruptStoreError):
        atomic.read_manifest(path, kind="demo", version=3)
    assert atomic.checksum_bytes(b"abc") == ref_atomic.checksum_bytes(b"abc")


def test_array_segments_round_trip_and_catch_truncation(tmp_path):
    arr = np.arange(24, dtype=np.int64).reshape(4, 6)
    entry = atomic.write_array(str(tmp_path), "a.npy", arr)
    assert entry == ref_atomic.write_array(str(tmp_path / "ref"), "a.npy",
                                           arr)
    assert np.array_equal(atomic.read_array(str(tmp_path), entry), arr)
    assert np.array_equal(ref_atomic.read_array(str(tmp_path), entry), arr)
    with open(tmp_path / "a.npy", "r+b") as f:
        f.truncate(entry["bytes"] - 8)
    with pytest.raises(atomic.CorruptStoreError):
        atomic.read_array(str(tmp_path), entry)


def test_file_lock_times_out_while_a_peer_holds_it(tmp_path):
    path = str(tmp_path / "lock")
    with atomic.file_lock(path):
        with pytest.raises(atomic.LockTimeout):
            with atomic.file_lock(path, timeout=0.05):
                pass
    with atomic.file_lock(path, timeout=0.05):   # released: acquirable
        pass


# ------------------------------------------------------- compile cache

def test_compile_cache_dir_is_the_kernel_build_directory(tmp_path,
                                                         _build_dir_reset):
    d = str(tmp_path / "cc")
    eng = ged.GedEngine("torch", device="cpu", compile_cache_dir=d,
                        **SMALL)
    assert eng.compile_cache_dir == d and os.path.isdir(d)
    assert _build.library_path().parent == Path(d)
    eng.compute(_pairs(22, 2))                 # the CPU builds nothing
    stats = eng.stats
    assert {k: stats[k] for k in stats if k.startswith("persistent_")} == {
        "persistent_cache_hits": 0.0, "persistent_cache_misses": 0.0,
        "persistent_cache_entries": 0.0}
    assert _build._LIB is None or _build.library_path().exists()


def test_compile_cache_env_default(tmp_path, monkeypatch, _build_dir_reset):
    d = str(tmp_path / "env_cc")
    monkeypatch.setenv(gexec.COMPILE_CACHE_ENV, d)
    assert gexec.COMPILE_CACHE_ENV == "REPRO_GED_COMPILE_CACHE_DIR"
    assert gexec.enable_compile_cache(None) == d
    assert os.path.isdir(d) and _build.build_dir() == Path(d)
    assert ged.GedEngine("exact").compile_cache_dir == d


def test_build_counts_a_found_library_and_a_compile(tmp_path, monkeypatch,
                                                    _build_dir_reset):
    """``build`` counts a hit when the digest-named library is already in
    the directory (no compiler runs) and a miss when it must compile."""
    gexec.enable_compile_cache(str(tmp_path))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    _build._CACHE.update(hits=0, misses=0)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    _build.library_path().write_bytes(b"")       # a library from before
    assert _build.build() == _build.library_path()
    assert gexec.persistent_cache_stats() == {
        "persistent_cache_hits": 1.0, "persistent_cache_misses": 1.0,
        "persistent_cache_entries": 1.0}
