"""The port's GED services (``repro_torch.serving``) against the reference
``repro.serving``, on the CPU.

The same requests, made from a numpy seed with the sizes and options of
``tests/test_serving.py``'s five GED tests, go through
``GedVerificationService(device="cpu")`` / ``GedSimilarityService(
device="cpu")`` and the reference's services.  Outcomes are compared
field by field (``ged``, ``similar``, ``certified``, ``lower_bound``,
``upper_bound``, ``tau``, ``backend``, ``timed_out``, ``degraded``, the
whole ``stats`` dict and ``mapping``; never ``wall_s``), and so are the
services' counters (the pipeline's, the result cache's and the store's
``store_*``, all but wall times), the ``health()`` keys, admission
shedding (``Overloaded`` and ``retry_after_s``), the argument errors, a
store directory the *reference* saved, and the launcher
(``python -m repro_torch.launch.serve``) in a subprocess.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as ref_serving  # noqa: E402
from repro import ged as ref_ged  # noqa: E402
from repro.ged.faults import Overloaded as RefOverloaded  # noqa: E402

import repro_torch.serving as serving  # noqa: E402
from repro_torch import ged  # noqa: E402
from repro_torch.data.graphs import perturb, random_graph  # noqa: E402
from repro_torch.ged.faults import Overloaded  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.serving import (GedSimilarityService,  # noqa: E402
                                 GedVerificationService, SearchRequest)
from repro_torch.serving import ged_service  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SVC = dict(batch_size=8, slots=16)
SIM = dict(batch_size=8, pool=256, expand=4, max_iters=256)
# counters that time something, or count what only one package has
TIMED = ("overlap_saved_s", "autotune_", "persistent_cache_")


@pytest.fixture(autouse=True)
def _isolated_table():
    saved = autotune.snapshot()
    autotune.reset()
    yield
    autotune.restore(saved)


def plain(g):
    """A graph as ``(vlabels, edges)``, readable by both packages."""
    return (g.vlabels.tolist(), [tuple(int(x) for x in e)
                                 for e in g.edges()])


@pytest.fixture(scope="module")
def request_set():
    """``tests/test_serving.py``'s 24 requests, as plain tuples."""
    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(24):
        q = random_graph(rng, int(rng.integers(6, 11)))
        g = perturb(rng, q, int(rng.integers(1, 6)))
        reqs.append((plain(q), plain(g), float(rng.integers(1, 7))))
    return reqs


def _requests(mod, reqs, **kw):
    return [mod.GedRequest(q, g, tau, **kw) for q, g, tau in reqs]


def _row(o):
    mapping = None if o.mapping is None else o.mapping.tolist()
    return (o.ged, o.similar, o.certified, o.lower_bound, o.upper_bound,
            o.tau, o.backend, o.timed_out, o.degraded, o.stats, mapping)


def _rows(outs):
    return [_row(o) for o in outs]


def _hit_rows(hits):
    return [(h.graph_id, h.stage, h.query_id) + _row(h.outcome)
            for h in hits]


def _counters(stats):
    return {k: v for k, v in stats.items()
            if not k.startswith(TIMED) and not k.endswith("_wall_s")
            and "engine_" not in k}


def _same_counters(port, ref):
    """Every counter of the port equals the reference's; the reference
    may also count its jit cache (``compile_cache_*``,
    ``pallas_interpret``), which the port has no counterpart of."""
    got, want = _counters(port), _counters(ref)
    assert got == {k: want.get(k) for k in got}
    assert set(want) - set(got) <= {"compile_cache_hits",
                                    "compile_cache_misses",
                                    "pallas_interpret"}, set(want) - set(got)


def _services(**kw):
    port = GedVerificationService(device="cpu", **SVC, **kw)
    ref = ref_serving.GedVerificationService(**SVC, **kw)
    return port, ref


# ------------------------------------------- test_serving.py's five tests

def test_verification_matches_reference(request_set):
    port, ref = _services()
    got = port.verify(_requests(serving, request_set))
    want = ref.verify(_requests(ref_serving, request_set))
    assert _rows(got) == _rows(want)
    assert all(o.certified for o in got)
    assert port.stats["pairs"] == len(request_set)
    _same_counters(port.stats, ref.stats)


def test_computation_matches_reference(request_set):
    port, ref = _services()
    pairs = [(q, g) for q, g, _ in request_set[:10]]
    got, want = port.compute(pairs), ref.compute(pairs)
    assert _rows(got) == _rows(want)
    assert all(o.certified and o.ged is not None for o in got)
    _same_counters(port.stats, ref.stats)


def test_escalation_path_used_for_hard_pairs():
    """A tiny first-rung budget forces escalation in both packages; the
    answers and the escalation counters stay equal."""
    rng = np.random.default_rng(11)
    reqs = []
    for _ in range(6):
        q = random_graph(rng, 10, density=0.35)
        reqs.append((plain(q), plain(perturb(rng, q, 6)), 4.0))
    port = GedVerificationService(batch_size=6, slots=16, device="cpu")
    ref = ref_serving.GedVerificationService(batch_size=6, slots=16)
    for svc in (port, ref):
        svc.scheduler.rungs = ((8, 2, 4),)
    got = port.verify(_requests(serving, reqs))
    want = ref.verify(_requests(ref_serving, reqs))
    assert _rows(got) == _rows(want)
    assert port.stats["escalated"] + port.stats["host_solved"] > 0
    _same_counters(port.stats, ref.stats)


def _routed(reqs, mod):
    """``test_serving.py``'s routed batch: 16 in-corpus requests, a stray
    target and a duck-typed query against a corpus graph."""
    rng = np.random.default_rng(21)
    corpus = [g for _, g, _ in reqs[:16]]
    stray = mod.GedRequest(reqs[0][0], plain(random_graph(rng, 7)), 3.0)
    ducky = mod.GedRequest(([0, 1], [(0, 1, 1)]), corpus[0], 50.0)
    return corpus, _requests(mod, reqs[:16]) + [stray, ducky]


def test_verify_routes_registered_corpus_through_store(request_set):
    port, ref = _services()
    corpus, port_reqs = _routed(request_set, serving)
    _, ref_reqs = _routed(request_set, ref_serving)
    store = port.register_corpus(corpus)
    ref.register_corpus(corpus)
    assert store.engine is port.engine          # shared cache + executor
    got, want = port.verify(port_reqs), ref.verify(ref_reqs)
    assert _rows(got) == _rows(want)
    assert all(o.certified for o in got) and got[17].similar
    s = port.stats
    assert s["store_candidates"] == 17
    assert s["store_index_pruned"] + s["store_stage0_pruned"] + \
        s["store_stage1_decided"] + s["store_stage2_verified"] == 17
    _same_counters(s, ref.stats)
    assert {k for k in s if k.startswith("store_")} == \
        {k for k in ref.stats if k.startswith("store_")}
    for svc in (port, ref):     # a shared engine refuses engine options
        with pytest.raises(TypeError):
            svc.register_corpus(corpus, cache=False)


def _similarity_corpus():
    rng = np.random.default_rng(23)
    return [plain(random_graph(rng, int(rng.integers(4, 8)), density=0.4,
                               n_vlabels=3, n_elabels=2)) for _ in range(8)]


def test_similarity_service_range_and_topk():
    corpus = _similarity_corpus()
    port = GedSimilarityService(corpus, device="cpu", **SIM)
    ref = ref_serving.GedSimilarityService(corpus, **SIM)
    q = corpus[2]
    assert _hit_rows(port.range_search(q, 0.0)) == \
        _hit_rows(ref.range_search(q, 0.0))
    got = port.search([SearchRequest(q, tau=1.0), SearchRequest(q, k=3)])
    want = ref.search([ref_serving.SearchRequest(q, tau=1.0),
                       ref_serving.SearchRequest(q, k=3)])
    assert [_hit_rows(h) for h in got] == [_hit_rows(h) for h in want]
    assert len(got[1]) == 3 and got[1][0].graph_id == 2
    assert all(h.query_id == 0 for h in got[0])
    assert _hit_rows(port.top_k(q, 2)) == _hit_rows(ref.top_k(q, 2))
    assert port.stats["queries"] == 4
    _same_counters(port.stats, ref.stats)
    assert set(port.health()) == set(ref.health())
    for svc, mod in ((port, serving), (ref, ref_serving)):
        with pytest.raises(ValueError):
            svc.search([mod.SearchRequest(q)])          # neither tau nor k
        with pytest.raises(ValueError):
            svc.search([mod.SearchRequest(q, tau=1.0, k=2)])   # both


# ------------------------------------------- admission, health, deadlines

def test_health_keys_and_shedding_under_a_held_budget(request_set):
    """With the admission budget held by an open ``admit()``, ``verify``
    and ``compute`` shed with ``Overloaded`` (a positive
    ``retry_after_s``, the capacity) before any engine work, ``health()``
    counts each shed, and every key and count equals the reference's."""
    port, ref = _services(capacity=4)
    reqs = request_set[:3]
    for svc, mod, err in ((port, serving, Overloaded),
                          (ref, ref_serving, RefOverloaded)):
        svc.verify(_requests(mod, reqs))
        with svc.admission.admit(3):
            with pytest.raises(err) as ei:
                svc.verify(_requests(mod, reqs[:2]))
            assert ei.value.retry_after_s > 0 and ei.value.capacity == 4
            assert ei.value.queue_depth == 3
            with pytest.raises(err):
                svc.compute([(q, g) for q, g, _ in reqs[:2]])
        svc.verify(_requests(mod, reqs))                # drained: admits
    assert Overloaded is ged.Overloaded
    hp, hr = port.health(), ref.health()
    assert set(hp) == set(hr)
    for k in ("shed", "admitted", "queue_depth", "capacity",
              "timed_out_pairs", "degraded_host", "degraded_kernel",
              "retries", "shared_cache_lock_timeouts"):
        assert hp[k] == hr[k], k
    assert hp["shed"] == 2 and hp["admitted"] == 3 and hp["queue_depth"] == 0
    assert hp["p99_wall_s"] >= hp["p50_wall_s"] > 0
    assert port.stats["pairs"] == 3                 # the sheds ran nothing


def test_admission_controller_matches_reference():
    port = ged_service.AdmissionController(capacity=4)
    ref = ref_serving.ged_service.AdmissionController(capacity=4)
    for ac, err in ((port, Overloaded), (ref, RefOverloaded)):
        with ac.admit(3):
            with pytest.raises(err):
                with ac.admit(2):
                    pass
        with ac.admit(2):
            pass
        with ac.admit(100):                   # oversized but idle
            pass
        assert ac.admit(0)._n == 1
    assert {k: v for k, v in port.health.items() if "wall" not in k} == \
        {k: v for k, v in ref.health.items() if "wall" not in k}
    assert isinstance(port._try_enter, type(ref._try_enter))


@pytest.mark.parametrize("budget", [0.0, 3600.0])
def test_deadline_requests_group_by_budget(request_set, budget):
    """Requests carrying ``deadline_s`` take the direct engine path, one
    engine call per budget: at 3600 s they answer like requests without a
    deadline; at 0 every answer is timed out with the reference's bounds.
    Both match the reference field by field, health counters included."""
    reqs = request_set[:6]
    port, ref = _services()
    got = port.verify(_requests(serving, reqs, deadline_s=budget))
    want = ref.verify(_requests(ref_serving, reqs, deadline_s=budget))
    assert _rows(got) == _rows(want)
    if budget:
        plain_port, _ = _services()
        assert _rows(got) == _rows(plain_port.verify(
            _requests(serving, reqs)))
        assert all(o.certified for o in got)
    else:
        assert all(o.timed_out and not o.certified for o in got)
    assert port.health()["timed_out_pairs"] == \
        ref.health()["timed_out_pairs"]
    assert port.stats["dispatches"] == ref.stats["dispatches"]


def test_service_on_a_cpu_mesh_equals_the_reference(request_set):
    """``mesh=`` reaches the service's engine: batches pad to the mesh's
    length and the answers stay the reference's."""
    port = GedVerificationService(device="cpu", mesh=["cpu"] * 4, **SVC)
    _, ref = _services()
    got = port.verify(_requests(serving, request_set[:11]))
    want = ref.verify(_requests(ref_serving, request_set[:11]))
    assert _rows(got) == _rows(want)
    assert port.engine.batch_multiple == 4
    assert port.stats["executor_single_device_fastpath"] == 0


# -------------------------------------------------- arguments and exports

def test_argument_errors_match_the_reference(tmp_path):
    port, ref = _services()
    for svc in (port, ref):
        with pytest.raises(TypeError, match="graphs or store_dir"):
            svc.register_corpus()
        with pytest.raises(TypeError, match="snapshot"):
            svc.register_corpus(store_dir=str(tmp_path), digest="exact")
    for cls in (GedSimilarityService, ref_serving.GedSimilarityService):
        with pytest.raises(TypeError, match="graphs or store_dir"):
            cls()
    with pytest.raises(ValueError, match="disagrees"):
        GedVerificationService(device="cpu", mesh=["cuda:0"])
    with pytest.raises(ValueError, match="flat sequence"):
        GedVerificationService(device="cpu", mesh=[["cpu", "cpu"]])


def test_services_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: GedVerificationService(),
                 lambda: GedSimilarityService(_similarity_corpus())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert GedVerificationService(device="cpu").engine.device.type == "cpu"


def test_exports_are_the_references_minus_generate():
    """Since the LM serving path is ported the exports are the
    reference's, ``generate`` included (the id is kept from when they
    were the reference's minus ``generate``)."""
    assert set(serving.__all__) == set(ref_serving.__all__)
    from repro_torch.serving.lm_decode import generate
    assert serving.generate is generate
    assert ged_service.GedResult is ged.GedOutcome
    import repro_torch
    assert {"serving", "launch", "configs", "models"} <= \
        set(repro_torch.__all__)


# ------------------------------------ a store directory the reference saved

def test_register_corpus_from_a_store_dir_the_reference_saved(
        request_set, tmp_path):
    corpus, port_reqs = _routed(request_set, serving)
    _, ref_reqs = _routed(request_set, ref_serving)
    saved = ref_ged.GraphStore(corpus, **SIM)
    saved.save(str(tmp_path / "db"))
    port, ref = _services()
    store = port.register_corpus(store_dir=str(tmp_path / "db"))
    ref.register_corpus(store_dir=str(tmp_path / "db"))
    assert store.engine is port.engine
    assert store.stats["filter_packed_rows"] == 0
    assert _rows(port.verify(port_reqs)) == _rows(ref.verify(ref_reqs))
    _same_counters(port.stats, ref.stats)


def test_similarity_service_opens_a_store_dir_the_reference_saved(
        tmp_path):
    corpus = _similarity_corpus()
    ref_ged.GraphStore(corpus, **SIM).save(str(tmp_path / "db"))
    port = GedSimilarityService(store_dir=str(tmp_path / "db"),
                                device="cpu", **SIM)
    ref = ref_serving.GedSimilarityService(store_dir=str(tmp_path / "db"),
                                           **SIM)
    q = corpus[5]
    assert port.stats["filter_packed_rows"] == 0
    for tau in (0.0, 2.0):
        assert _hit_rows(port.range_search(q, tau)) == \
            _hit_rows(ref.range_search(q, tau))
    assert _hit_rows(port.top_k(q, 3)) == _hit_rows(ref.top_k(q, 3))
    _same_counters(port.stats, ref.stats)


# ---------------------------------------------------------------- launcher

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_launcher_serves_ged_like_the_reference_launcher():
    """``--mode ged --device cpu --pairs 8`` certifies every pair and
    finds as many similar pairs as the reference's launcher on the same
    seed; ``--mode lm --device cpu`` generates 16 tokens for each of 8
    prompts, like the reference's launcher, and so does ``--arch
    rwkv6-3b`` (an SSM arch; the id is kept from when that family was not
    ported and the launcher exited naming ROADMAP.md)."""
    args = ("--mode", "ged", "--pairs", "8")
    res = _launch("repro_torch.launch.serve", *args, "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    ref = _launch("repro.launch.serve", *args)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    line = [x for x in res.stdout.splitlines() if x.startswith("similar:")]
    want = [x for x in ref.stdout.splitlines() if x.startswith("similar:")]
    assert line == want and "certified: 8/8" in line[0], res.stdout
    lm = _launch("repro_torch.launch.serve", "--mode", "lm", "--device",
                 "cpu")
    assert lm.returncode == 0, lm.stdout + lm.stderr
    assert any(x.startswith("generated (8, 16)")
               for x in lm.stdout.splitlines()), lm.stdout
    lm_args = ("--mode", "lm", "--arch", "rwkv6-3b")
    ssm = _launch("repro_torch.launch.serve", *lm_args, "--device", "cpu")
    assert ssm.returncode == 0, ssm.stdout + ssm.stderr
    ref_ssm = _launch("repro.launch.serve", *lm_args)
    assert ref_ssm.returncode == 0, ref_ssm.stdout + ref_ssm.stderr
    line = [x.split(" in ")[0] for x in ssm.stdout.splitlines()
            if x.startswith("generated (")]
    want = [x.split(" in ")[0] for x in ref_ssm.stdout.splitlines()
            if x.startswith("generated (")]
    assert line == want == ["generated (8, 16)"], ssm.stdout
