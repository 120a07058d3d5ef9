"""The port's anytime deadline contract, fault injection, retries and
degradation ladder (``repro_torch.ged.faults``) against the reference
``repro.ged.faults``, on the CPU.

The same pairs, made from a numpy seed, go through ``repro_torch`` and
``repro`` with the engine options of ``tests/test_faults.py``.  Outcomes
are compared exactly, field by field (``ged``, ``similar``, ``certified``,
``lower_bound``, ``upper_bound``, ``tau``, ``mapping``, ``backend`` and
the whole ``stats`` dict), and so are the robustness counters, at
deadlines of 0 and 3600 s and ``per_pair_deadline_s=0``.  A mid-run
budget depends on the host's speed, so there only soundness is asserted:
every uncertified answer brackets the brute-force GED (the port's own
``core/exact/brute.py``).

Two cases differ by design.  The port's ladder starts below the kernels
(no unfused step), so a ``kernel``- or ``result``-site fault on
``"cuda"`` sends the bucket to the host solver and counts
``degraded_host`` where the reference's ``"pallas"`` re-runs unfused and
counts ``degraded_kernel``; verdicts and distances are equal and
certified in both.  On the card only an injected fault takes that step: a
real kernel, CUDA or out-of-memory failure is raised
(``faults.degradable``), which the tests here show with an executor that
reports a CUDA device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro.ged import faults as ref_faults  # noqa: E402
from repro.store_io.shared_cache import \
    SharedResultCache as RefSharedResultCache  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.core.exact.brute import brute_force_ged  # noqa: E402
from repro_torch.data.graphs import random_graph  # noqa: E402
from repro_torch.ged import faults  # noqa: E402
from repro_torch.ged.exec import PendingBatch  # noqa: E402
from repro_torch.ged.results import GedOutcome  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.store_io import SHARED_CACHE_ENV  # noqa: E402
from repro_torch.store_io.shared_cache import SharedResultCache  # noqa: E402

ENGINE_OPTS = dict(slots=16, batch_size=8, pool=64, expand=4,
                   max_iters=256, cache=False)
# rungs small enough that the mix escalates and some pairs reach the host
FORCED_RUNGS = ((1, 1, 1), (4, 1, 2))
# the reference backend each port backend is held to
REF_BACKEND = {"torch": "jax", "cuda": "pallas", "auto": "auto",
               "exact": "exact"}
FAULT_KEYS = ("retries", "degraded_host", "degraded_kernel",
              "fault_dispatch", "fault_host", "timed_out_pairs")
# names repro.ged exports that belong to slices still to port (none left)
NOT_PORTED = set()
# names the port exports that repro.ged does not
PORT_ONLY = {"AutoBackend", "ExactBackend", "Plan", "engine_outcome",
             "KernelDispatch"}


@pytest.fixture(autouse=True)
def _no_global_injectors(monkeypatch):
    """Both packages keep a process-global injector read from one
    environment variable: clear it and reset both, before and after."""
    monkeypatch.delenv(faults.FAULT_INJECT_ENV, raising=False)
    monkeypatch.delenv(SHARED_CACHE_ENV, raising=False)
    faults.install_injector(None)
    ref_faults.install_injector(None)
    saved = autotune.snapshot()
    autotune.reset()
    yield
    faults.install_injector(None)
    ref_faults.install_injector(None)
    autotune.restore(saved)


def _pairs(n=6, seed=3):
    """(vlabels, edges) pairs readable by both packages: the graph sizes
    and label alphabets of ``tests/test_faults.py``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = random_graph(rng, int(rng.integers(2, 6)), density=0.5,
                         n_vlabels=2, n_elabels=2)
        g = random_graph(rng, int(rng.integers(2, 6)), density=0.5,
                         n_vlabels=2, n_elabels=2)
        out.append(tuple((x.vlabels.tolist(), list(x.edges()))
                         for x in (q, g)))
    return out


def _truths(pairs):
    return [float(brute_force_ged(*(ged.as_graph(x) for x in p)))
            for p in pairs]


def _engines(backend, rungs=None, **kw):
    """A port engine and the reference engine it is held to."""
    opts = {**ENGINE_OPTS, **kw}
    port = ged.GedEngine(backend, device="cpu", **opts)
    ref = ref_ged.GedEngine(REF_BACKEND[backend], **opts)
    if rungs is not None:
        for e in (port, ref):
            e._backend.scheduler.rungs = rungs
    return port, ref


def _ref_name(backend):
    """A port backend's name as the reference spells it."""
    return backend.replace("torch", "jax").replace("cuda", "pallas")


def _same(a, b, backend=True):
    """Every outcome field but ``wall_s``."""
    assert (a.ged, a.similar, a.certified, a.lower_bound, a.upper_bound,
            a.tau, a.stats) == (b.ged, b.similar, b.certified,
                                b.lower_bound, b.upper_bound, b.tau,
                                b.stats)
    assert (a.timed_out, a.degraded) == (b.timed_out, b.degraded)
    if backend:
        assert _ref_name(a.backend) == _ref_name(b.backend)
    if a.mapping is None or b.mapping is None:
        assert a.mapping is None and b.mapping is None
    else:
        assert np.array_equal(a.mapping, b.mapping)


def _same_all(got, want, backend=True):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b, backend)


def _fault_stats(stats):
    return {k: v for k, v in stats.items()
            if k in FAULT_KEYS or k.startswith("fault_")}


def _assert_sound(outs, truths, taus=None):
    for i, (o, t) in enumerate(zip(outs, truths)):
        if not (o.certified and taus is not None):
            # a certified rejection may carry the engine's tau-prune floor
            # as lower_bound; everything else must bracket the truth
            assert o.lower_bound <= t + 1e-9, (i, o.lower_bound, t)
            assert o.upper_bound >= t - 1e-9, (i, o.upper_bound, t)
        if o.certified and o.ged is not None:
            assert o.ged == pytest.approx(t), (i, o.ged, t)
        if taus is not None and o.similar is not None:
            assert o.similar == (t <= taus[i] + 1e-9), (i, o.similar, t)


# ------------------------------------------------------------- exports

def test_exports_are_the_references_minus_the_slices_still_to_port():
    """Every name of ``repro.ged.__all__`` is ported (``ShardedExecutor``
    was the last), plus the port's own five: 33 names."""
    assert len(ged.__all__) == 33 and not NOT_PORTED
    assert set(ged.__all__) - PORT_ONLY == set(ref_ged.__all__) - NOT_PORTED
    assert ged.ShardedExecutor.name == ref_ged.ShardedExecutor.name
    for name in ("Deadline", "FaultInjector", "InjectedFault", "Overloaded",
                 "RetryPolicy"):
        assert getattr(ged, name) is getattr(faults, name)


# ----------------------------------------------------------- unit parity

BAD_SPECS = ["badsite@times=1", "dispatch@nope=1", "lock;kernal",
             "host@times=2,color=red"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_spec_errors_equal_the_reference(spec):
    with pytest.raises(ValueError) as got:
        faults.FaultInjector(spec)
    with pytest.raises(ValueError) as want:
        ref_faults.FaultInjector(spec)
    assert str(got.value) == str(want.value)


SPECS = ["dispatch@times=2,rung=1;lock", "kernel@times=inf",
         "result;result@kind=transient", "host@times=3,kind=transient",
         " dispatch@rung=0 ; ; host ", ""]
CALLS = [("dispatch", 0), ("dispatch", 1), ("lock", None), ("dispatch", 1),
         ("dispatch", 1), ("lock", None), ("kernel", 2), ("kernel", None),
         ("result", 0), ("result", 0), ("result", 0), ("host", -1),
         ("host", -1), ("host", -1), ("host", -1), ("dispatch", None)]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_injector_fires_like_the_reference(spec):
    """The same sequence of checks fires at the same calls, with the same
    kind and message, and the same ``fired`` count."""
    def trace(inj, exc_type):
        out = []
        for site, rung in CALLS:
            try:
                inj.check(site, rung)
                out.append(None)
            except exc_type as exc:
                out.append((str(exc), exc.site, exc.transient))
        return out, inj.fired

    got = trace(faults.FaultInjector(spec), faults.InjectedFault)
    want = trace(ref_faults.FaultInjector(spec), ref_faults.InjectedFault)
    assert got == want


def test_env_injector_pickup_and_install(monkeypatch):
    monkeypatch.setenv(faults.FAULT_INJECT_ENV, "host@times=1")
    inj = faults.get_injector()
    assert inj is not None and [s.site for s in inj.specs] == ["host"]
    assert faults.get_injector() is inj          # parsed once per value
    monkeypatch.delenv(faults.FAULT_INJECT_ENV)
    assert faults.get_injector() is None
    pinned = faults.FaultInjector("lock")
    faults.install_injector(pinned)
    monkeypatch.setenv(faults.FAULT_INJECT_ENV, "host")
    assert faults.get_injector() is pinned       # installed wins over env
    ctx = faults.RunContext(injector=faults.FaultInjector("dispatch"))
    assert faults.get_injector(ctx) is ctx.injector
    # one variable, two packages: the reference reads the same spec
    faults.install_injector(None)
    assert [s.site for s in ref_faults.get_injector().specs] == \
        [s.site for s in faults.get_injector().specs] == ["host"]


@pytest.mark.parametrize("policy", [dict(), dict(max_retries=2, base_s=0.1,
                                                 cap_s=1.0),
                                    dict(base_s=0.0), dict(base_s=0.3,
                                                           cap_s=0.5)])
def test_retry_backoff_equals_the_reference(policy):
    got = [faults.RetryPolicy(**policy).backoff_s(a) for a in range(11)]
    want = [ref_faults.RetryPolicy(**policy).backoff_s(a) for a in range(11)]
    assert got == want
    assert faults.RetryPolicy(**policy).max_retries == \
        ref_faults.RetryPolicy(**policy).max_retries


def _exceptions(mod):
    return [mod.InjectedFault("dispatch", transient=True),
            mod.InjectedFault("kernel"), ValueError("bad shape"),
            OSError("interrupted"), TimeoutError("slow"),
            ConnectionError("reset"), KeyError("x"),
            RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
            RuntimeError("UNAVAILABLE: runner"),
            RuntimeError("DEADLINE_EXCEEDED"), RuntimeError("ABORTED: x"),
            RuntimeError("INTERNAL: Failed to compile"),
            RuntimeError("nvcc failed for ['bma_cost_matrix.cu']")]


def test_classify_transient_equals_the_reference():
    got = [faults.classify_transient(e) for e in _exceptions(faults)]
    want = [ref_faults.classify_transient(e) for e in _exceptions(ref_faults)]
    assert got == want
    # the CUDA counterpart of RESOURCE_EXHAUSTED is transient; every other
    # CUDA error is sticky, so permanent
    assert faults.classify_transient(torch.cuda.OutOfMemoryError("OOM"))
    assert not faults.classify_transient(
        RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not faults.classify_transient(
        RuntimeError("CUDA kernel lsa_children failed at or before its "
                      "launch: ..."))


def test_deadline_and_sub_behave_like_the_reference():
    for mod in (faults, ref_faults):
        d = mod.Deadline(3600.0)
        assert not d.expired() and d.remaining() > 3599.0
        assert d.sub(1.0).remaining() <= 1.0
        assert d.sub(None).t_end == d.t_end
        assert d.sub(7200.0).t_end == d.t_end        # capped by the parent
        assert mod.Deadline(0.0).expired()
        assert not mod.Deadline(None).expired()
        assert mod.Deadline(None).sub(None).t_end is None
        assert mod.Deadline(None).sub(2.0).remaining() <= 2.0
        assert mod.Deadline(5.0, _now=10.0).t_end == 15.0
        ctx = mod.RunContext(per_pair_deadline_s=0.5)
        assert not ctx.has_deadline and ctx.pair_deadline().t_end is not None


def test_cheap_lower_bound_and_fallback_equal_the_reference():
    pairs = _pairs(20, seed=17)
    truths = _truths(pairs)
    for (q, g), t in zip(pairs, truths):
        pq, pg = ged.as_graph(q), ged.as_graph(g)
        rq, rg = ref_ged.as_graph(q), ref_ged.as_graph(g)
        lb = faults.cheap_lower_bound(pq, pg)
        assert lb == ref_faults.cheap_lower_bound(rq, rg)
        assert lb <= t
        for verification, tau, kw in (
                (False, None, {}),
                (True, 1.0, {}),
                (True, 2.0, dict(lower_bound=t, upper_bound=t + 1.0)),
                (True, t, dict(upper_bound=t, timed_out=False)),
                (False, None, dict(lower_bound=0.0, upper_bound=t,
                                   stats={"rung": 1, "degraded": True}))):
            a = faults.fallback_outcome(pq, pg, verification, tau, "auto",
                                        **kw)
            b = ref_faults.fallback_outcome(rq, rg, verification, tau,
                                            "auto", **kw)
            assert isinstance(a, GedOutcome)
            _same(a, b)
            assert a.lower_bound <= t <= a.upper_bound


def test_overloaded_and_warn_once():
    for mod in (faults, ref_faults):
        err = mod.Overloaded(0.5, 10, 8)
        assert isinstance(err, RuntimeError)
        assert (err.retry_after_s, err.queue_depth, err.capacity) == \
            (0.5, 10, 8)
    assert str(faults.Overloaded(0.5, 10, 8)) == \
        str(ref_faults.Overloaded(0.5, 10, 8))
    assert faults.warn_once("faults-test-key", "first") is True
    assert faults.warn_once("faults-test-key", "again") is False


# --------------------------------------------------------- engine parity

@pytest.mark.parametrize("backend", ["exact", "auto"])
@pytest.mark.parametrize("verification", [False, True])
@pytest.mark.parametrize("budget", ["deadline_s", "per_pair_deadline_s"])
def test_zero_budgets_equal_the_reference(backend, verification, budget):
    pairs = _pairs()
    truths = _truths(pairs)
    taus = [1.0] * len(pairs)
    port, ref = _engines(backend, FORCED_RUNGS if backend == "auto"
                         else None, **{budget: 0.0})
    got, want = ((e.verify(pairs, taus) if verification
                  else e.compute(pairs)) for e in (port, ref))
    _same_all(got, want)
    assert _fault_stats(port.stats) == _fault_stats(ref.stats)
    _assert_sound(got, truths, taus if verification else None)
    if budget == "deadline_s":
        assert all(o.timed_out and not o.certified for o in got)
        assert port.stats["timed_out_pairs"] == len(pairs)
    elif backend == "exact":
        assert all(o.timed_out for o in got)
    else:                       # rungs run; only host-solver pairs time out
        assert port.stats.get("timed_out_pairs", 0) == \
            sum(o.timed_out for o in got)
        assert verification or port.stats["timed_out_pairs"] >= 1
        assert all(o.certified or o.timed_out for o in got)


@pytest.mark.parametrize("backend", ["torch", "auto", "exact"])
def test_roomy_deadline_is_bit_identical_to_none(backend):
    pairs = _pairs(8, seed=4)
    taus = [1.0] * len(pairs)
    rungs = FORCED_RUNGS if backend == "auto" else None
    plain, _ = _engines(backend, rungs)
    roomy, ref = _engines(backend, rungs, deadline_s=3600.0)
    want = plain.verify(pairs, taus) + plain.compute(pairs)
    got = roomy.verify(pairs, taus) + roomy.compute(pairs)
    _same_all(got, want)
    _same_all(got, ref.verify(pairs, taus) + ref.compute(pairs))
    assert not any(o.timed_out or o.degraded for o in got)
    for eng in (plain, roomy):
        assert not _fault_stats(eng.stats), eng.stats
    per_call = plain.compute(pairs, deadline_s=faults.Deadline(3600.0))
    _same_all(per_call, want[len(pairs):])


def test_transient_dispatch_fault_retries_to_identical_answers():
    pairs = _pairs()
    taus = [1.0] * len(pairs)
    clean = ged.GedEngine("torch", device="cpu", **ENGINE_OPTS).verify(
        pairs, taus)
    opts = dict(fault_inject="dispatch@times=1,kind=transient")
    port = ged.GedEngine("torch", device="cpu",
                         retry=faults.RetryPolicy(max_retries=2, base_s=0.0),
                         **opts, **ENGINE_OPTS)
    ref = ref_ged.GedEngine(
        "jax", retry=ref_faults.RetryPolicy(max_retries=2, base_s=0.0),
        **opts, **ENGINE_OPTS)
    got, want = port.verify(pairs, taus), ref.verify(pairs, taus)
    _same_all(got, want)
    assert port.stats["retries"] == ref.stats["retries"] == 1
    assert port.stats["executor_retries"] == 1
    assert _fault_stats(port.stats) == _fault_stats(ref.stats)
    for a, b in zip(clean, got):
        assert (a.similar, a.certified, a.lower_bound, a.upper_bound) == \
            (b.similar, b.certified, b.lower_bound, b.upper_bound)


@pytest.mark.parametrize("backend,spec", [
    ("torch", "dispatch@times=inf"),
    ("torch", "dispatch@times=1"),
    ("exact", "host@times=inf"),
    ("auto", "dispatch@times=inf"),
    ("auto", "host@times=2")])
def test_permanent_faults_degrade_like_the_reference(backend, spec):
    """A permanent ``dispatch`` fault sends its buckets to the host solver
    (certified, ``degraded``); a ``host`` fault answers from the
    admissible floor, uncertified.  Outcomes and ``degraded_host`` /
    ``fault_*`` equal the reference's."""
    pairs = _pairs()
    truths = _truths(pairs)
    taus = [1.0] * len(pairs)
    rungs = FORCED_RUNGS if backend == "auto" else None
    port, ref = _engines(backend, rungs, fault_inject=spec)
    for e, mod in ((port, faults), (ref, ref_faults)):
        e._retry = mod.RetryPolicy(max_retries=1, base_s=0.0)
    got, want = port.verify(pairs, taus), ref.verify(pairs, taus)
    _same_all(got, want)
    assert _fault_stats(port.stats) == _fault_stats(ref.stats)
    _assert_sound(got, truths, taus)
    assert all(o.certified or o.degraded for o in got)
    if spec.startswith("dispatch@times=inf"):
        assert all(o.certified and o.degraded for o in got)
    if backend == "torch" and spec == "dispatch@times=inf":
        assert port.stats["degraded_host"] == len(pairs)
    if backend == "exact":
        assert port.stats["fault_host"] == len(pairs)
        assert all(not o.certified and o.degraded for o in got)


def test_rung_scoped_fault_leaves_other_rungs_alone():
    pairs = _pairs(8, seed=21)
    truths = _truths(pairs)
    taus = [2.0] * len(pairs)
    clean, _ = _engines("auto", FORCED_RUNGS)
    port, ref = _engines("auto", FORCED_RUNGS,
                         fault_inject="dispatch@rung=1,times=inf")
    for e, mod in ((port, faults), (ref, ref_faults)):
        e._retry = mod.RetryPolicy(max_retries=0, base_s=0.0)
    got, want = port.verify(pairs, taus), ref.verify(pairs, taus)
    _same_all(got, want)
    assert _fault_stats(port.stats) == _fault_stats(ref.stats)
    assert port.stats["degraded_host"] >= 1
    _assert_sound(got, truths, taus)
    for a, b in zip(clean.verify(pairs, taus), got):
        assert a.similar == b.similar and b.certified
        if b.rung == 0:           # rung 0 never sees the fault
            _same(a, b)


# ------------------------------------------- documented ladder difference

@pytest.mark.parametrize("spec", ["kernel@times=inf", "result@times=1"])
def test_kernel_and_result_faults_go_to_the_host_solver(spec):
    """Where the reference's ``"pallas"`` re-runs a failed bucket unfused
    (``degraded_kernel``), the port's ``"cuda"`` sends it to the host
    solver (``degraded_host``): verdicts and distances equal the
    reference's, every answer certified."""
    pairs = _pairs()
    taus = [1.0] * len(pairs)
    port, ref = _engines("cuda", fault_inject=spec)
    for e, mod in ((port, faults), (ref, ref_faults)):
        e._retry = mod.RetryPolicy(max_retries=0, base_s=0.0)
    clean = ged.GedEngine("cuda", device="cpu", **ENGINE_OPTS).verify(
        pairs, taus)
    got, want = port.verify(pairs, taus), ref.verify(pairs, taus)
    assert [o.similar for o in got] == [o.similar for o in want] == \
        [o.similar for o in clean]
    assert all(o.certified for o in got + want)
    assert ref.stats.get("degraded_kernel", 0) >= 1
    assert "degraded_kernel" not in port.stats
    hosted = [o for o in got if o.degraded]
    assert port.stats["degraded_host"] == len(hosted) >= 1
    if spec.startswith("kernel"):
        assert len(hosted) == len(pairs)
        assert port.stats["fault_dispatch"] == len(_port_buckets(pairs))
    comp_got = port.compute(pairs)
    comp_want = ref.compute(pairs)
    assert [o.ged for o in comp_got] == [o.ged for o in comp_want]
    assert all(o.certified for o in comp_got)


@pytest.mark.parametrize("exc,device,degrades", [
    (faults.InjectedFault("kernel"), "cuda", True),
    (RuntimeError("nvcc failed for ['lsa_children.cu']"), "cuda", False),
    (torch.cuda.OutOfMemoryError("out of memory"), "cuda", False),
    (RuntimeError("engine bucket failed"), "cpu", True),
])
def test_only_injected_faults_degrade_on_the_card(exc, device, degrades):
    assert faults.degradable(exc, torch.device(device)) is degrades


def _broken(stage, card):
    """A ``run_bucket_async`` that fails as a real error at ``stage``
    (``"dispatch"`` or ``"result"``); ``card`` names the CUDA error text."""
    err = RuntimeError("CUDA kernel lsa_children failed at or before its "
                       "launch" if card else "engine bucket failed")

    def run_bucket_async(*args, **kwargs):
        if stage == "dispatch":
            raise err

        def check():
            raise err
        return PendingBatch({"ged": torch.zeros(1)}, check=check)
    return run_bucket_async


@pytest.mark.parametrize("stage", ["dispatch", "result"])
@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_real_card_failure_is_raised_not_degraded(backend, stage):
    """A real failure of an engine bucket on a CUDA executor propagates
    out of ``compute``; the same failure on a CPU executor degrades to the
    host solver, as in the reference."""
    pairs = _pairs(4, seed=5)
    truths = _truths(pairs)
    for device in ("cuda", "cpu"):
        eng = ged.GedEngine(backend, device="cpu", **ENGINE_OPTS)
        ex = eng._backend.executor
        ex.device = torch.device(device)
        ex.run_bucket_async = _broken(stage, device == "cuda")
        if device == "cuda":
            with pytest.raises(RuntimeError, match="CUDA kernel"):
                eng.compute(pairs)
            assert "degraded_host" not in eng.stats
            continue
        outs = eng.compute(pairs)
        assert eng.stats["degraded_host"] == len(pairs)
        assert all(o.certified and o.degraded for o in outs)
        assert [o.ged for o in outs] == truths


def _port_buckets(pairs):
    return ged.build_plan(pairs, slots=ENGINE_OPTS["slots"]).buckets


# ------------------------------------------------- shared cache and hygiene

def test_lock_site_fails_open_like_the_reference(tmp_path):
    out = GedOutcome(ged=2.0, similar=None, certified=True,
                     lower_bound=2.0, upper_bound=2.0, mapping=None,
                     backend="torch", wall_s=0.0)
    key = ("exact", b"q", b"g", False, None, None, "torch")
    for mod, cls, sub in ((faults, SharedResultCache, "port"),
                          (ref_faults, RefSharedResultCache, "ref")):
        mod.install_injector(mod.FaultInjector("lock@times=1"))
        cache = cls(str(tmp_path / sub), lock_timeout_s=0.05)
        assert cache.put(key, out)                # fail-open write
        assert cache.put(key, out)                # budget spent: locked
        assert cache.lock_timeouts == 1
        assert cache.get(key).ged == 2.0
        assert cache.stats["lock_timeouts"] == 1.0
        mod.install_injector(None)
    # the port's lock path warned through faults.warn_once: one set of keys
    assert faults.warn_once("shared-cache-lock", "again") is False
    pairs = _pairs(3, seed=2)
    engines = []
    for mod, eng_mod, backend, sub in ((faults, ged, "exact", "p2"),
                                       (ref_faults, ref_ged, "exact", "r2")):
        mod.install_injector(mod.FaultInjector("lock@times=1"))
        kw = dict(device="cpu") if eng_mod is ged else {}
        eng = eng_mod.GedEngine(backend, shared_cache_dir=str(tmp_path / sub),
                                **kw)
        engines.append((eng, eng.compute(pairs)))
        mod.install_injector(None)
    (port, got), (ref, want) = engines
    _same_all(got, want)
    assert port.stats["shared_cache_lock_timeouts"] == \
        ref.stats["shared_cache_lock_timeouts"] == 1


@pytest.mark.parametrize("backend", ["exact", "auto"])
def test_timed_out_outcomes_do_not_poison_caches(tmp_path, backend):
    pairs = _pairs(3, seed=7)
    truths = _truths(pairs)
    opts = {**ENGINE_OPTS, "cache": True, "cache_size": 64}
    port = ged.GedEngine(backend, device="cpu", **opts,
                         shared_cache_dir=str(tmp_path / "port"))
    ref = ref_ged.GedEngine(backend, **opts,
                            shared_cache_dir=str(tmp_path / "ref"))
    if backend == "auto":
        for e in (port, ref):
            e._backend.scheduler.rungs = FORCED_RUNGS
    bad, bad_ref = port.compute(pairs, deadline_s=0.0), \
        ref.compute(pairs, deadline_s=0.0)
    _same_all(bad, bad_ref)
    assert all(o.timed_out for o in bad)
    assert port.stats["result_cache_entries"] == 0
    assert port.stats["shared_cache_entries"] == 0
    good, good_ref = port.compute(pairs), ref.compute(pairs)
    _same_all(good, good_ref)
    for o, t in zip(good, truths):
        assert o.certified and o.ged == pytest.approx(t)
    for key in ("result_cache_hits", "result_cache_misses",
                "result_cache_entries", "shared_cache_entries",
                "timed_out_pairs"):
        assert port.stats[key] == ref.stats[key], key
    fresh = ged.GedEngine(backend, device="cpu", cache_size=0,
                          shared_cache_dir=str(tmp_path / "port"))
    for o, t in zip(fresh.compute(pairs), truths):
        assert o.ged == pytest.approx(t) and o.stats["cached"] == "shared"


def test_degraded_uncertified_answers_are_not_cached():
    pairs = _pairs(3, seed=9)
    port = ged.GedEngine("exact", device="cpu", fault_inject="host@times=3")
    ref = ref_ged.GedEngine("exact", fault_inject="host@times=3")
    first, first_ref = port.compute(pairs), ref.compute(pairs)
    _same_all(first, first_ref)
    assert all(o.degraded and not o.certified for o in first)
    second, second_ref = port.compute(pairs), ref.compute(pairs)
    _same_all(second, second_ref)
    assert all(o.certified and not o.degraded for o in second)
    assert port.stats["result_cache_hits"] == ref.stats["result_cache_hits"]
    assert port.stats["fault_host"] == ref.stats["fault_host"] == 3


def test_flush_shares_one_deadline_like_the_reference():
    pairs = _pairs(6, seed=5)
    port, ref = _engines("exact", cache=True)
    for eng in (port, ref):
        for i, (q, g) in enumerate(pairs):
            eng.submit(q, g, tau=1.0 if i % 2 else None)
    got, want = port.flush(deadline_s=0.0), ref.flush(deadline_s=0.0)
    _same_all(got, want)
    assert all(o.timed_out for o in got)
    assert [o.tau for o in got] == [1.0 if i % 2 else None
                                    for i in range(len(pairs))]
    assert port.stats["timed_out_pairs"] == len(pairs)
    # one Deadline object serves both sub-batches
    seen = []
    real = port._run

    def spy(*args, **kw):
        seen.append(args[5] if len(args) > 5 else kw.get("deadline_s"))
        return real(*args, **kw)

    port._run = spy
    for i, (q, g) in enumerate(pairs):
        port.submit(q, g, tau=1.0 if i % 2 else None)
    roomy = port.flush(deadline_s=3600.0)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert isinstance(seen[0], faults.Deadline)
    assert all(o.certified for o in roomy)
    assert port.flush(deadline_s=0.0) == [] and ref.flush() == []


# ---------------------------------------------------------- soundness

def _bound_property(seed, budget):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(3):
        q, g = (random_graph(rng, int(rng.integers(2, 6)), density=0.5,
                             n_vlabels=2, n_elabels=2) for _ in range(2))
        pairs.append((q, g))
    truths = [float(brute_force_ged(q, g)) for q, g in pairs]
    eng = ged.GedEngine("auto", device="cpu", deadline_s=budget,
                        **ENGINE_OPTS)
    outs = eng.verify(pairs, [1.0] * len(pairs))
    for o, t in zip(outs, truths):
        if not o.certified:     # see _assert_sound on certified verdicts
            assert o.lower_bound <= t + 1e-9 <= o.upper_bound + 2e-9, \
                (seed, budget, o.lower_bound, t, o.upper_bound)
        assert o.certified or o.timed_out or o.degraded
        assert faults.cheap_lower_bound(*pairs[0]) >= 0


def test_bounds_bracket_truth_under_seeded_deadline_sweep():
    for seed in (0, 1, 2, 3):
        for budget in (0.0, 0.002, 0.02, 3600.0):
            _bound_property(seed, budget)


def test_mid_run_deadline_keeps_rung_bounds():
    pairs = _pairs(10, seed=11)
    truths = _truths(pairs)
    taus = [2.0] * len(pairs)
    eng = ged.GedEngine("auto", device="cpu", **ENGINE_OPTS)
    eng._backend.scheduler.rungs = FORCED_RUNGS
    for budget in (0.005, 0.05):
        outs = eng.verify(pairs, taus, deadline_s=budget)
        assert len(outs) == len(pairs)
        _assert_sound(outs, truths, taus)
        assert all(o.certified or o.timed_out for o in outs)
        outs = eng.compute(pairs, deadline_s=budget)
        _assert_sound(outs, truths)
        assert all(o.certified or o.timed_out for o in outs)


def test_bounds_bracket_truth_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=12, deadline=None)
    @given(seed=st.integers(0, 10_000),
           budget=st.floats(0.0, 0.05, allow_nan=False))
    def run(seed, budget):
        _bound_property(seed, budget)

    run()
