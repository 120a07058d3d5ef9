"""The slice as a whole: the port's escalating ``"auto"`` backend against
the reference's, on the CPU.

``repro_torch.ged.GedEngine("auto", device="cpu", cache=False)`` and
``repro.ged.GedEngine("auto", cache=False)`` get the same pairs with the
escalation rungs of both shrunk to tiny ``(pool, expand, max_iters)``
triples, so the mix climbs every rung and some pairs end at the host
solver.  Compared exactly, per pair: ``ged``, ``similar``, ``certified``,
``lower_bound``, ``upper_bound``, ``stats["rung"]`` and ``backend``; per
run: the counters ``pairs``, ``escalated``, ``host_solved``, ``batches``,
``dispatches`` and ``survivors_rung_k``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro.data.graphs import aids_like_graph, perturb, random_graph  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402

RUNGS = ((4, 1, 2), (8, 2, 4))
COUNTERS = ("pairs", "escalated", "host_solved", "batches", "dispatches")


@pytest.fixture(autouse=True)
def _isolated_table():
    saved = autotune.snapshot()
    autotune.reset()
    yield
    autotune.restore(saved)


def _mix(seed=0, count=12):
    """(vlabels, edges) pairs: identical graphs (decided at rung 0), small
    edits, and unrelated graphs (escalated, some to the host solver)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        g = aids_like_graph(rng, int(rng.integers(5, 11)), n_vlabels=4,
                            n_elabels=2)
        if i % 3 == 0:
            h = g.copy()
        elif i % 3 == 1:
            h = perturb(rng, g, int(rng.integers(2, 5)), n_vlabels=4,
                        n_elabels=2)
        else:
            h = random_graph(rng, int(rng.integers(5, 11)), density=0.3,
                             n_vlabels=4, n_elabels=2)
        out.append(tuple((x.vlabels.tolist(), list(x.edges()))
                         for x in (g, h)))
    return out


def _engines(port_kw=None, ref_kw=None):
    port = ged.GedEngine("auto", device="cpu", cache=False,
                         **(port_kw or {}))
    ref = ref_ged.GedEngine("auto", cache=False, **(ref_kw or {}))
    for e in (port, ref):
        e._backend.scheduler.rungs = RUNGS
    return port, ref


def _key(o):
    return (o.ged, o.similar, o.certified, o.lower_bound, o.upper_bound,
            o.stats["rung"], o.backend, o.tau)


def _counters(stats):
    return {k: v for k, v in stats.items()
            if k in COUNTERS or k.startswith("survivors_rung_")}


def _run(eng, pairs, tau):
    return eng.compute(pairs) if tau is None else eng.verify(pairs, tau)


@pytest.mark.parametrize("tau", [None, 3.0])
def test_auto_equals_reference(tau):
    pairs = _mix()
    port, ref = _engines()
    got, want = _run(port, pairs, tau), _run(ref, pairs, tau)
    assert [_key(o) for o in got] == [_key(o) for o in want]
    assert _counters(port.stats) == _counters(ref.stats)
    s = port.stats
    assert s["host_solved"] >= 1 and s["survivors_rung_1"] >= 1
    assert set(o.stats["rung"] for o in got) == {0, 1, -1}
    assert all(o.certified for o in got)
    assert {o.backend for o in got} == {"auto", "auto/exact"}
    assert s["executor_calls"] == s["dispatches"]


def test_auto_pinned_slots_and_per_pair_taus():
    pairs = _mix(seed=1)
    taus = [0.0, 1.0, 2.0, 3.0, 1.5, 4.0, 0.5, 2.5]
    pairs = pairs[:len(taus)]
    port, ref = _engines(dict(slots=16), dict(slots=16))
    got, want = port.verify(pairs, taus), ref.verify(pairs, taus)
    assert [_key(o) for o in got] == [_key(o) for o in want]
    assert [o.tau for o in got] == taus
    assert _counters(port.stats) == _counters(ref.stats)


def test_overlap_off_gives_the_same_outcomes():
    pairs = _mix(seed=2, count=8)
    on, _ = _engines()
    off = ged.GedEngine("auto", device="cpu", cache=False, overlap=False)
    off._backend.scheduler.rungs = RUNGS
    a, b = on.compute(pairs), off.compute(pairs)
    assert [_key(o) for o in a] == [_key(o) for o in b]
    assert _counters(on.stats) == _counters(off.stats)
    assert on.stats["host_solved"] >= 1


def test_use_kernel_auto_with_and_without_a_table(tmp_path):
    """Measured dispatch never changes an outcome: no table (heuristic),
    a table that fuses everything, and a pinned all-fused dispatch."""
    pairs = _mix(seed=3, count=8)
    plain, _ = _engines()
    want = [_key(o) for o in plain.compute(pairs)]
    untuned, _ = _engines(dict(use_kernel="auto"))
    assert [_key(o) for o in untuned.compute(pairs)] == want
    assert untuned.stats["autotune_misses"] >= 1
    autotune.enable_autotune(str(tmp_path))
    for kernel, n, b in (("lsa", 8, 16), ("bma", 8, 16), ("merge", 8, 16),
                         ("merge", 16, 16)):
        autotune.put(kernel, n, b, {"impl": "fused"}, device="cpu")
    tuned, _ = _engines(dict(use_kernel="auto", autotune_dir=str(tmp_path)))
    assert [_key(o) for o in tuned.compute(pairs)] == want
    assert tuned.stats["autotune_hits"] >= 1
    pinned, _ = _engines(dict(dispatch=ged.KernelDispatch(
        lsa_fused=True, bma_fused=True, merge_fused=True)))
    assert [_key(o) for o in pinned.compute(pairs)] == want


@pytest.mark.parametrize("tau", [None, 1.0])
def test_exact_backend_equals_reference(tau):
    pairs = _mix(seed=4, count=6)
    got = _run(ged.GedEngine("exact", cache=False), pairs, tau)
    want = _run(ref_ged.GedEngine("exact", cache=False), pairs, tau)
    assert [_key(o) for o in got] == [_key(o) for o in want]
    for a, b in zip(got, want):
        assert a.stats == b.stats
        assert np.array_equal(a.mapping, b.mapping) or \
            (a.mapping is None and b.mapping is None)


def test_lazy_plan_subset_buckets_equal_reference():
    """``Plan.lazy`` packs nothing; ``subset_buckets`` regroups survivors
    by slot bucket with the plan's vocab, byte-equal to the reference."""
    from repro.ged.exec import Executor as RefExecutor
    from repro.ged.plan import Plan as RefPlan
    pairs = _mix(seed=5)
    port_plan = ged.Plan.lazy(pairs)
    ref_plan = RefPlan.lazy(pairs)
    assert port_plan.buckets == [] and port_plan.vocab == ref_plan.vocab
    subset = [11, 0, 7, 3, 5]
    got = port_plan.subset_buckets(subset, ged.Executor("cpu").pack)
    want = ref_plan.subset_buckets(subset, RefExecutor().pack)
    assert [(b.slots, b.indices, b.real) for b in got] == \
        [(b.slots, b.indices, b.real) for b in want]
    for a, b in zip(got, want):
        for f in ("qv", "gv", "qa", "ga", "order", "n"):
            assert getattr(a.packed, f).tobytes() == \
                getattr(b.packed, f).tobytes(), f
