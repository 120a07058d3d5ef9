"""The port's stage −1 candidate index and WL-sketch signatures against the
reference ``repro.ged``, on the CPU.

The same graphs, made from a numpy seed with the sizes of
``tests/test_candidate_index.py``, go through both packages.  Signatures
must be byte-equal (int32) between the port's device path
(``batch_signatures`` on a CPU executor), its host path
(``wl_signature``) and the reference's two, for every ``SketchSpec``
the reference tests and for labels near 2**31, where the uint32
wraparound decides the result.  ``CandidateIndex`` probes, ``nearest``,
pivot bounds, ``sketch_damage`` and the index counters must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro.ged import exec as ref_exec  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.core.exact.brute import brute_force_ged  # noqa: E402
from repro_torch.data.graphs import perturb, random_graph  # noqa: E402
from repro_torch.ged.exec import Executor  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

ENGINE_OPTS = dict(pool=256, expand=4, max_iters=256)
CPU = Executor(device="cpu")
SPECS = [(64, 16, 0), (64, 16, 1), (32, 8, 2)]


@pytest.fixture(autouse=True)
def _isolated_table():
    saved = autotune.snapshot()
    autotune.reset()
    yield
    autotune.restore(saved)


def _ref(g):
    return ref_ged.as_graph((g.vlabels.tolist(),
                             [tuple(int(x) for x in e) for e in g.edges()]))


def _corpus(seed, count, nmin=3, nmax=7, planted=2):
    rng = np.random.default_rng(seed)
    graphs = [random_graph(rng, int(rng.integers(nmin, nmax + 1)),
                           density=0.4, n_vlabels=3, n_elabels=2)
              for _ in range(count)]
    for _ in range(planted):
        graphs.append(perturb(rng, graphs[0], int(rng.integers(1, 3)),
                              n_vlabels=3, n_elabels=2))
    return graphs


def _shifted(g, dv, de):
    """``g`` with every vertex label moved by ``dv`` and edge label by
    ``de`` (large shifts make the uint32 products wrap)."""
    return ged.as_graph(((g.vlabels + dv).tolist(),
                         [(int(i), int(j), int(a) + de)
                          for i, j, a in g.edges()]))


# ------------------------------------------------------------ signatures

@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("labels", ["small", "near_2_31"])
def test_signatures_are_byte_equal_to_the_reference(spec, labels):
    rng = np.random.default_rng(11)
    graphs = [random_graph(rng, int(rng.integers(2, 11)), density=0.5,
                           n_vlabels=5, n_elabels=3) for _ in range(40)]
    graphs.append(random_graph(rng, 20, density=0.3, n_vlabels=5,
                               n_elabels=3))           # slot bucket 32
    if labels == "near_2_31":
        graphs = [_shifted(g, 2 ** 31 - 9, 2 ** 31 - 5) for g in graphs]
    port_spec = ged.SketchSpec(*spec)
    ref_spec = ref_ged.SketchSpec(*spec)
    refs = [_ref(g) for g in graphs]
    got = ged.batch_signatures(graphs, port_spec, CPU, chunk=16)
    assert got.dtype == np.int32 and got.shape == (41, port_spec.dims)
    want = ref_ged.batch_signatures(refs, ref_spec, ref_exec.Executor())
    host = np.stack([ged.wl_signature(g, port_spec) for g in graphs])
    ref_host = np.stack([ref_ged.wl_signature(g, ref_spec) for g in refs])
    for other in (want, host, ref_host):
        assert other.dtype == np.int32
        assert got.tobytes() == other.tobytes()
    assert np.array_equal(got[:, -2], [g.n for g in graphs])
    assert np.array_equal(got[:, -1], [g.m for g in graphs])


def test_wraparound_decides_the_bins():
    """Labels near 2**31 hash differently from their values mod small
    widths, so a signed or float product would land in other bins."""
    g = ged.as_graph(([2 ** 31 - 1, 2 ** 31 - 2, 5],
                      [(0, 1, 2 ** 31 - 1), (1, 2, 3)]))
    spec = ged.SketchSpec(dims_v=7, dims_e=5, wl_iters=2)
    got = ged.batch_signatures([g], spec, CPU)[0]
    assert np.array_equal(got, ref_ged.wl_signature(_ref(g),
                                                    ref_ged.SketchSpec(7, 5, 2)))
    assert ged.batch_signatures([], spec, CPU).shape == (0, spec.dims)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "x".join(map(str, s)))
def test_sketch_damage_equals_reference(spec):
    for deg in range(0, 9):
        assert ged.sketch_damage(ged.SketchSpec(*spec), deg) == \
            ref_ged.sketch_damage(ref_ged.SketchSpec(*spec), deg)


# ---------------------------------------------------------------- probes

def _indexes(corpus, **kw):
    port = ged.CandidateIndex(corpus, list(range(len(corpus))),
                              executor=CPU, **kw)
    ref = ref_ged.CandidateIndex([_ref(g) for g in corpus],
                                 list(range(len(corpus))), **kw)
    return port, ref


@pytest.mark.parametrize("knobs", [
    dict(), dict(reps=1), dict(reps=3, seed=3), dict(recall=0.7),
    dict(wl_iters=1), dict(dims_v=4, dims_e=2)],
    ids=["exact", "reps1", "reps3", "recall", "wl1", "fallback"])
def test_probe_and_nearest_equal_reference(knobs):
    corpus = _corpus(13, 20, planted=4)
    port, ref = _indexes(corpus, **knobs)
    assert np.array_equal(port.sigs, ref.sigs)
    rng = np.random.default_rng(14)
    queries = [corpus[0], corpus[-1],
               random_graph(rng, 5, density=0.5, n_vlabels=3, n_elabels=2)]
    for q in queries:
        for tau in (0.0, 1.0, 2.0, 3.0, 50.0):
            got, want = port.probe(q, tau), ref.probe(_ref(q), tau)
            assert got == want, (knobs, tau)
            assert port.damage(q, tau) == ref.damage(_ref(q), tau)
        assert port.nearest(q, 7) == ref.nearest(_ref(q), 7)
    assert port.stats == ref.stats
    assert port.exact == ref.exact


def test_exact_probe_is_sound_against_bruteforce():
    corpus = _corpus(13, 12, planted=3)
    idx = ged.CandidateIndex(corpus, list(range(len(corpus))), executor=CPU)
    for q in (corpus[0], corpus[-1]):
        truth = [brute_force_ged(q, g) for g in corpus]
        for tau in (0.0, 1.0, 2.0):
            got = idx.probe(q, tau)
            assert all(i in got for i, t in enumerate(truth) if t <= tau)
            assert all(lb <= truth[i] for i, lb in got.items())


def test_extend_and_restore_equal_a_fresh_build():
    corpus = _corpus(16, 16)
    port, ref = _indexes(corpus[:10])
    port.probe(corpus[0], 1.0)
    port.extend(corpus, range(10, 16), executor=CPU)
    ref.extend([_ref(g) for g in corpus], range(10, 16))
    fresh = ged.CandidateIndex(corpus, list(range(16)), executor=CPU)
    restored = ged.CandidateIndex(corpus, list(range(16)), sigs=fresh.sigs,
                                  max_deg=fresh._max_deg)
    assert restored.stats["signatures_built"] == 0
    assert np.array_equal(port.sigs, fresh.sigs)
    for idx in (port, fresh, restored):
        for tau in (1.0, 2.0):
            assert idx.probe(corpus[3], tau) == \
                ref.probe(_ref(corpus[3]), tau)
    assert port.stats["signatures_built"] == ref.stats["signatures_built"]
    with pytest.raises(ValueError):
        ged.CandidateIndex(corpus, [0, 1], sigs=fresh.sigs)
    with pytest.raises(ValueError):
        ged.CandidateIndex(corpus, [0], recall=0.0, executor=CPU)
    with pytest.raises(ValueError):
        ged.CandidateIndex(corpus, [0], reps=0, executor=CPU)


def test_pivot_bounds_equal_reference():
    corpus = _corpus(18, 12, planted=3)
    port, ref = _indexes(corpus, pivot_seeds=2, pivot_coverage=6,
                         pivot_min_candidates=1)
    port_eng = ged.GedEngine("torch", device="cpu", **ENGINE_OPTS)
    ref_eng = ref_ged.GedEngine("jax", **ENGINE_OPTS)
    port.bind_engine(port_eng)
    ref.bind_engine(ref_eng)
    assert port.seed_pivots() == ref.seed_pivots() > 0
    assert port.use_pivots and ref.use_pivots
    rng = np.random.default_rng(19)
    q = random_graph(rng, 5, density=0.5, n_vlabels=3, n_elabels=2)
    ids = list(range(len(corpus)))
    got, want = port.pivot_bounds(q, ids), ref.pivot_bounds(_ref(q), ids)
    assert got == want and got
    assert port.stats == ref.stats
    for key in ("index_pivot_hits", "index_pivot_misses",
                "result_cache_entries"):
        assert port_eng.stats[key] == ref_eng.stats[key], key
    for y, lb in got.items():
        assert 0.0 < lb <= brute_force_ged(q, corpus[y])
    port.note_pivot(3)
    ref.note_pivot(3)
    assert list(port._pivots) == list(ref._pivots)
