"""Multi-device placement of the port (``ShardedExecutor``, the
``"sharded"`` backend, ``GedEngine(mesh=...)``, ``GraphStore(mesh=...)``)
against the reference and the port's single-device runs, on the CPU.

The CPU has one device, so the tests use a flat mesh of repeated entries,
``["cpu"] * 4``: every batch is padded to a multiple of 4 and split into
four contiguous shards that run one after another, the part that
``--xla_force_host_platform_device_count=8`` plays in the reference's
tests.  ``["cpu", "cpu:0"] * 2`` names two distinct torch devices of the
same CPU, which puts the shards on one worker thread per device.  Eleven
pairs (padded to 12) go through ``"sharded"`` and ``"auto"`` with
``mesh``, at ``compute`` and ``verify`` at tau 2 and 4, with the kernels'
families unfused and fused (the plain twins on the CPU).  Outcomes are
compared field by field (all but ``wall_s`` and, for ``"sharded"``
against the reference's ``"jax"``, the backend name) with the
reference's and with the port's single-device run; ``"auto"``'s counters
exactly.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro.ged import faults as ref_faults  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.core.engine import api as engine_api  # noqa: E402
from repro_torch.data.graphs import (aids_like_graph, perturb,  # noqa: E402
                                     random_graph)
from repro_torch.ged import faults  # noqa: E402
from repro_torch.ged.exec import ShardedExecutor  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.parallel.sharding import (DeviceMesh,  # noqa: E402
                                           pair_devices, pairs_axes)

ROOT = Path(__file__).resolve().parents[1]
MESH = ["cpu"] * 4
PAIRS = 11
SMALL = dict(slots=16, pool=64, expand=4, max_iters=64, cache=False)
AUTO = dict(slots=16, batch_size=8, cache=False)
RUNGS = ((4, 1, 2), (8, 2, 4))       # the mix climbs every rung
COUNTERS = ("pairs", "escalated", "host_solved", "batches", "dispatches")
FUSED = ged.KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=True)
# ``"sharded"`` is the ``"torch"`` policy: kernels go on through dispatch=
KERNELS = {"sharded": {"off": dict(), "on": dict(dispatch=FUSED)},
           "auto": {"off": dict(use_kernel=False),
                    "on": dict(use_kernel=True, dispatch=FUSED)}}
MODES = {"compute": None, "verify2": 2.0, "verify4": 4.0}


@pytest.fixture(autouse=True)
def _isolated_table():
    saved = autotune.snapshot()
    autotune.reset()
    yield
    autotune.restore(saved)


def plain(g):
    return (g.vlabels.tolist(), [tuple(int(x) for x in e)
                                 for e in g.edges()])


def _mix(seed=3, count=PAIRS):
    """Identical, slightly edited and unrelated pairs, as plain tuples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        g = aids_like_graph(rng, int(rng.integers(5, 11)), n_vlabels=4,
                            n_elabels=2)
        if i % 3 == 0:
            h = g.copy()
        elif i % 3 == 1:
            h = perturb(rng, g, int(rng.integers(1, 4)), n_vlabels=4,
                        n_elabels=2)
        else:
            h = random_graph(rng, int(rng.integers(5, 11)), density=0.3,
                             n_vlabels=4, n_elabels=2)
        out.append((plain(g), plain(h)))
    return out


def _row(o, backend=True):
    mapping = None if o.mapping is None else o.mapping.tolist()
    return (o.ged, o.similar, o.certified, o.lower_bound, o.upper_bound,
            o.tau, o.timed_out, o.degraded, o.stats, mapping) + \
        ((o.backend,) if backend else ())


def _run(eng, pairs, tau):
    return eng.compute(pairs) if tau is None else eng.verify(pairs, tau)


def _counters(stats):
    return {k: v for k, v in stats.items()
            if k in COUNTERS or k.startswith("survivors_rung_")}


def _engine(pkg, backend, rungs=None, **kw):
    opts = AUTO if backend == "auto" else SMALL
    if pkg is ged:
        kw.setdefault("device", "cpu")
    eng = pkg.GedEngine(backend, **opts, **kw)
    if rungs is not None:
        eng._backend.scheduler.rungs = rungs
    return eng


# ------------------------------------------------------- engine outcomes

@pytest.fixture(scope="module")
def reference_runs():
    """The reference's ``"jax"`` and ``"auto"`` answers per mode, run
    once for the module."""
    pairs = _mix()
    out = {}
    for backend, ref_backend in (("sharded", "jax"), ("auto", "auto")):
        for mode, tau in MODES.items():
            rungs = RUNGS if backend == "auto" else None
            eng = _engine(ref_ged, ref_backend, rungs)
            out[backend, mode] = (_run(eng, pairs, tau), eng.stats)
    return pairs, out


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("backend", ["sharded", "auto"])
def test_mesh_outcomes_equal_the_reference_and_one_device(
        reference_runs, backend, mode, kernels):
    pairs, ref = reference_runs
    tau = MODES[mode]
    rungs = RUNGS if backend == "auto" else None
    kw = KERNELS[backend][kernels]
    sharded = _engine(ged, backend, rungs, mesh=MESH, **kw)
    single = _engine(ged, "torch" if backend == "sharded" else "auto",
                     rungs, **kw)
    got, one = _run(sharded, pairs, tau), _run(single, pairs, tau)
    want, want_stats = ref[backend, mode]
    assert sharded.batch_multiple == 4 and single.batch_multiple == 1
    if backend == "auto":
        assert [_row(o) for o in got] == [_row(o) for o in want]
        assert _counters(sharded.stats) == _counters(want_stats)
    else:
        assert [_row(o, False) for o in got] == \
            [_row(o, False) for o in want]
        assert {o.backend for o in got} == {"sharded"}
    assert [_row(o, False) for o in got] == [_row(o, False) for o in one]
    assert sharded.stats["executor_pairs"] == single.stats["executor_pairs"]
    assert sharded.stats["executor_single_device_fastpath"] == 0


def test_batches_pad_to_the_mesh_and_split_into_contiguous_shards(
        monkeypatch):
    """11 pairs on four shards are one batch of 16 (the power of two over
    11, a multiple of 4) cut into rows 0-3, 4-7, 8-11 and 12-15, each on
    its mesh entry."""
    seen = []
    real = engine_api.dispatch_packed

    def spy(packed, taus, cfg, verification, *, device=None):
        seen.append((packed.batch, len(taus), str(device),
                     packed.qv.copy()))
        return real(packed, taus, cfg, verification, device=device)

    monkeypatch.setattr(engine_api, "dispatch_packed", spy)
    pairs = _mix()
    eng = _engine(ged, "sharded", mesh=MESH)
    eng.compute(pairs)
    assert [s[:3] for s in seen] == [(4, 4, "cpu")] * 4
    plan = ged.build_plan(pairs, slots=16, batch_multiple=4)
    packed = plan.buckets[0].packed
    assert packed.batch == 16
    assert np.array_equal(np.concatenate([s[3] for s in seen]), packed.qv)


def test_two_distinct_devices_run_on_worker_threads(monkeypatch):
    """``["cpu", "cpu:0"] * 2`` names two distinct torch devices: one
    worker thread each, shards in order on their worker, rows gathered in
    batch order, counters counted in the caller's thread."""
    import threading
    threads = {}
    real = engine_api.dispatch_packed

    def spy(packed, taus, cfg, verification, *, device=None):
        threads.setdefault(str(device), set()).add(
            threading.current_thread().name)
        return real(packed, taus, cfg, verification, device=device)

    pairs = _mix()
    one = _engine(ged, "torch").verify(pairs, 2.0)
    monkeypatch.setattr(engine_api, "dispatch_packed", spy)
    eng = _engine(ged, "sharded", mesh=["cpu", "cpu:0"] * 2)
    assert eng.batch_multiple == 4
    got = eng.verify(pairs, 2.0)
    assert [_row(o, False) for o in got] == [_row(o, False) for o in one]
    assert set(threads) == {"cpu", "cpu:0"}
    names = set().union(*threads.values())
    assert len(names) == 2 and threading.current_thread().name not in names
    assert all(len(v) == 1 for v in threads.values())
    assert eng.stats["executor_calls"] == 1


def test_one_device_mesh_takes_the_fast_path():
    pairs = _mix()
    for mesh in (["cpu"], None):
        eng = _engine(ged, "sharded", mesh=mesh)
        assert eng.batch_multiple == 1
        got = eng.compute(pairs)
        assert eng.stats["executor_single_device_fastpath"] == \
            eng.stats["executor_calls"] == 1
    ref = _engine(ref_ged, "sharded")
    want = ref.compute(pairs)
    assert [_row(o) for o in got] == [_row(o) for o in want]
    assert ref.stats["executor_single_device_fastpath"] == 1
    auto = _engine(ged, "auto", mesh=["cpu"])
    auto.compute(pairs)
    assert auto.stats["executor_single_device_fastpath"] == \
        auto.stats["dispatches"]


# -------------------------------------------------------------- store

def test_store_on_a_mesh_equals_the_reference_store(monkeypatch):
    """``GraphStore(mesh=["cpu"] * 4)``: feature buckets and the batches
    of stage 1 and stage 2 are multiples of 4, and the hits and counters
    equal the reference store's and the single-device store's."""
    rng = np.random.default_rng(21)
    graphs = [random_graph(rng, int(rng.integers(3, 8)), density=0.4,
                           n_vlabels=3, n_elabels=2) for _ in range(13)]
    graphs += [perturb(rng, graphs[0], int(rng.integers(1, 3)), n_vlabels=3,
                       n_elabels=2) for _ in range(3)]
    corpus = [plain(g) for g in graphs]
    queries = [corpus[0], corpus[4], corpus[-1]]
    opts = dict(pool=256, expand=4, max_iters=256, batch_size=8)
    batches = []
    real = ShardedExecutor._dispatch

    def spy(self, packed, taus, cfg, verification):
        batches.append(packed.batch)
        return real(self, packed, taus, cfg, verification)

    monkeypatch.setattr(ShardedExecutor, "_dispatch", spy)
    port = ged.GraphStore(corpus, mesh=MESH, **opts)
    assert port.executor.batch_multiple == 4
    # each bucket: four resident slices of equal length, ceil(rows / 4)
    assert all(len(b.shards) == 4 and
               {sh[0].shape[0] for sh in b.shards} == {-(-len(b.ids) // 4)}
               for b in port._index.buckets)
    got = {tau: port.search_batch(queries, tau) for tau in (1.0, 3.0)}
    got_top = port.top_k(queries[1], 3)
    assert batches and all(b % 4 == 0 for b in batches), batches
    ref = ref_ged.GraphStore(corpus, **opts)
    one = ged.GraphStore(corpus, device="cpu", **opts)

    def rows(hits):
        return [(h.graph_id, h.stage, h.query_id) + _row(h.outcome)
                for h in hits]

    for tau, hits in got.items():
        want = ref.search_batch(queries, tau)
        assert [rows(h) for h in hits] == [rows(h) for h in want]
        assert [rows(h) for h in hits] == \
            [rows(h) for h in one.search_batch(queries, tau)]
    assert rows(got_top) == rows(ref.top_k(queries[1], 3))
    keep = {k: v for k, v in ref.stats.items()
            if not k.startswith("engine_") and not k.endswith("_wall_s")}
    assert {k: port.stats[k] for k in keep} == keep
    ids = port._index.ids[::3]
    q0, q2 = ged.as_graph(queries[0]), ged.as_graph(queries[2])
    assert port._index.scan_subset(q0, ids) == \
        one._index.scan_subset(q0, ids)
    assert np.array_equal(port._index.scan(q2), one._index.scan(q2))


# --------------------------------------------------------- signatures

def test_sharded_signatures_are_byte_equal_to_wl_signature():
    """37 graphs, ``chunk=16``, as the reference's 8-device test: the
    signatures of a four-shard build equal the host path byte for byte."""
    rng = np.random.default_rng(25)
    graphs = [random_graph(rng, int(rng.integers(2, 11)), density=0.5,
                           n_vlabels=5, n_elabels=3) for _ in range(37)]
    ex = ShardedExecutor(MESH)
    for spec in (ged.SketchSpec(), ged.SketchSpec(wl_iters=1)):
        sigs = ged.batch_signatures(graphs, spec, ex, chunk=16)
        host = np.stack([ged.wl_signature(g, spec) for g in graphs])
        assert sigs.dtype == host.dtype and sigs.tobytes() == host.tobytes()


# ------------------------------------------------------------- faults

def test_transient_dispatch_fault_retries_once_with_equal_answers():
    pairs = _mix()
    opts = dict(fault_inject="dispatch@times=1,kind=transient")
    port = _engine(ged, "sharded", mesh=MESH,
                   retry=faults.RetryPolicy(max_retries=2, base_s=0.0),
                   **opts)
    ref = _engine(ref_ged, "jax",
                  retry=ref_faults.RetryPolicy(max_retries=2, base_s=0.0),
                  **opts)
    got, want = port.verify(pairs, 2.0), ref.verify(pairs, 2.0)
    assert [_row(o, False) for o in got] == [_row(o, False) for o in want]
    assert port.stats["retries"] == ref.stats["retries"] == 1
    assert port.stats["executor_retries"] == 1


@pytest.mark.parametrize("mesh", [MESH, ["cpu", "cpu:0"] * 2])
def test_a_failing_shard_raises_inside_the_retry_loop(monkeypatch, mesh):
    """A transient error in the third shard is raised inside the
    executor's retry loop (after every shard has ended), the whole batch
    retries once, and the answers equal the clean run's (each carrying
    the ``retries`` flag of its batch)."""
    pairs = _mix()
    real = engine_api.dispatch_packed
    calls = []

    def flaky(packed, taus, cfg, verification, *, device=None):
        calls.append(device)
        if len(calls) == 3:
            raise TimeoutError("shard lost")
        return real(packed, taus, cfg, verification, device=device)

    monkeypatch.setattr(engine_api, "dispatch_packed", flaky)
    eng = _engine(ged, "sharded", mesh=mesh,
                  retry=faults.RetryPolicy(max_retries=1, base_s=0.0))
    got = eng.compute(pairs)
    monkeypatch.setattr(engine_api, "dispatch_packed", real)
    clean = _engine(ged, "torch").compute(pairs)
    assert all(o.stats.pop("retries") == 1 for o in got)
    assert [_row(o, False) for o in got] == [_row(o, False) for o in clean]
    assert eng.stats["retries"] == 1 and 7 <= len(calls) <= 8


# -------------------------------------------------------- mesh rules

def test_mixed_nested_and_disagreeing_meshes_raise():
    for bad in (["cpu", "cuda:0"], [["cpu", "cpu"], ["cpu", "cpu"]], [],
                "cpu"):
        with pytest.raises(ValueError):
            pair_devices(bad)
        with pytest.raises(ValueError):
            ged.GedEngine("sharded", mesh=bad, device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        ged.GedEngine("auto", mesh=["cuda:0"], device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        ged.GraphStore([([0], [])], mesh=MESH, device="cuda")
    assert pair_devices(MESH, device="cpu") == (torch.device("cpu"),) * 4


# ------------------------------------------------------- named meshes

# (grid shape, axis names, axes=) of the reference's three named meshes
NAMED = {"data-model": ((4, 2), ("data", "model"), None),
         "pod-data-model": ((2, 2, 2), ("pod", "data", "model"), None),
         "axes-model": ((4, 2), ("data", "model"), ("model",))}


def _grid(shape, leaf):
    return leaf if not shape else [_grid(shape[1:], leaf)
                                   for _ in range(shape[0])]


@pytest.fixture(scope="module")
def reference_named_meshes():
    """``pairs_axes`` / ``ShardedExecutor(mesh, axes).axes`` and
    ``batch_multiple`` of the reference on 8 fake CPU devices, read in a
    subprocess (the device count is fixed when JAX starts)."""
    import json
    import os
    import subprocess
    import sys
    code = (
        "import json, jax\n"
        "from repro.ged.exec import ShardedExecutor\n"
        "from repro.parallel.sharding import pairs_axes\n"
        f"cases = {NAMED!r}\n"
        "out = {}\n"
        "for key, (shape, names, axes) in cases.items():\n"
        "    mesh = jax.make_mesh(tuple(shape), tuple(names))\n"
        "    ex = ShardedExecutor(mesh, axes)\n"
        "    out[key] = [list(pairs_axes(mesh)), list(ex.axes),\n"
        "                ex.batch_multiple]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("case", sorted(NAMED))
def test_named_meshes_shard_pairs_like_the_reference(
        reference_named_meshes, case):
    """On CPU device grids a ``DeviceMesh`` has the reference's pairs axes
    and batch multiple (4, 4 and 2 for the three meshes), and each shard
    runs on the first device of its replica group."""
    shape, names, axes = NAMED[case]
    mesh = DeviceMesh(_grid(shape, "cpu"), names)
    assert mesh.shape == dict(zip(names, shape))
    ex = ShardedExecutor(mesh, axes=axes, device="cpu")
    want_pairs, want_axes, want_mult = reference_named_meshes[case]
    assert list(pairs_axes(mesh)) == want_pairs
    assert list(ex.axes) == want_axes
    assert ex.batch_multiple == want_mult
    assert ged.GedEngine("sharded", mesh=mesh, device="cpu").batch_multiple \
        == (want_mult if axes is None else 4)
    # distinct devices along the replicated axis: shards take index 0 of it
    tagged = DeviceMesh([["cpu", "cpu:0"]] * 4, ("data", "model"))
    assert pair_devices(tagged) == (torch.device("cpu"),) * 4
    assert pair_devices(tagged, axes=("model",)) == \
        (torch.device("cpu"), torch.device("cpu", 0))


def test_named_mesh_errors():
    with pytest.raises(ValueError, match="axis names"):
        DeviceMesh([["cpu"] * 2] * 2, ("data",))
    with pytest.raises(ValueError, match="ragged"):
        DeviceMesh([["cpu"] * 2, ["cpu"]], ("data", "model"))
    mesh = DeviceMesh([["cpu"] * 2] * 2, ("data", "model"))
    with pytest.raises(ValueError, match="axes"):
        ShardedExecutor(mesh, axes=("pod",), device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        ShardedExecutor(MESH, axes=("data",), device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        pair_devices([["cpu", "cpu"]])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("backend", ["sharded", "auto"])
def test_named_mesh_outcomes_equal_the_reference(reference_runs, backend,
                                                 mode):
    """``"sharded"`` and ``"auto"`` on the ``(4, 2)`` ``("data",
    "model")`` CPU grid (four pair shards) answer like the reference's
    single-device ``"jax"`` / ``"auto"`` run field by field, with equal
    ``"auto"`` counters; ``GraphStore(mesh=...)`` takes the same mesh."""
    pairs, ref = reference_runs
    mesh = DeviceMesh(_grid((4, 2), "cpu"), ("data", "model"))
    rungs = RUNGS if backend == "auto" else None
    eng = _engine(ged, backend, rungs, mesh=mesh)
    assert eng.batch_multiple == 4
    got = _run(eng, pairs, MODES[mode])
    want, want_stats = ref[backend, mode]
    assert [_row(o, False) for o in got] == [_row(o, False) for o in want]
    if backend == "auto":
        assert _counters(eng.stats) == _counters(want_stats)
    if backend == "sharded" and mode == "compute":
        store = ged.GraphStore([g for p in pairs for g in p][:12], mesh=mesh,
                               device="cpu", cache=False)
        assert store.executor.batch_multiple == 4


def test_sharded_defaults_to_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ged.GedEngine("sharded"), lambda: pair_devices(),
                 lambda: ShardedExecutor()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_launch_counts_lose_no_update_across_threads():
    """The shards of a multi-device batch launch from worker threads: many
    more threads than cores, switching as often as the interpreter allows,
    count every launch."""
    import sys
    import threading
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    per_thread, n_threads = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            kops._count("merge_ranks") for _ in range(per_thread)])
            for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert kops.launch_counts()["merge_ranks"] == per_thread * n_threads
    kops.reset_launch_counts()
