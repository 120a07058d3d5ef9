"""``GedEngine("sharded")`` and ``("auto")`` on ``torch.distributed``
meshes (``repro_torch.launch.mesh.make_test_mesh``), on the CPU.

One group of four ``gloo`` processes (a ``file://`` store) is started once
for the module, with a timeout of its own, and runs every case in turn:

* three meshes, ``(4,)`` ``("data",)``, ``(2, 2)`` ``("data", "model")``
  and ``(2, 2, 1)`` ``("pod", "data", "model")``; on each ``"sharded"``
  and ``"auto"`` at ``compute`` and ``verify(2)`` on 12 pairs at slot 16;
* on the ``(4,)`` mesh: a permanent dispatch fault injected on rank 1
  only (every rank degrades the same bucket); the same with
  ``faults.degradable`` patched to false in the ranks (every rank raises
  the same error, none hangs); ``"auto"`` under a deadline of 0, of a
  third of an unbounded run's wall and of none, with a 1 ms per-pair
  host budget; ``GedVerificationService(mesh=...)``; and the
  ``TypeError`` s that still stand for a store on such a mesh:
  ``GraphStore(mesh=...)`` beside ``engine=``, and engine-level options
  to ``register_corpus`` (the store itself is
  ``tests/test_torch_distributed_store.py``'s).

Each rank pickles what it saw.  The tests hold the ranks to each other
and, field by field as ``tests/test_torch_sharded.py`` compares them
(all but ``wall_s``; for ``"sharded"`` against the reference's ``"jax"``
also the backend name), to the reference's one-device ``"jax"`` /
``"auto"`` outcomes and to the port's one-device runs; ``batch_multiple``
to the reference's ``ShardedExecutor`` on a JAX mesh of the same shape
and axes (four fake CPU devices, read in a subprocess).
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.data.graphs import (aids_like_graph, perturb,  # noqa: E402
                                     random_graph)
from repro_torch.parallel.sharding import (DeviceMesh,  # noqa: E402
                                           is_distributed_mesh, pairs_axes,
                                           rank_shard)
from repro_torch.serving.ged_service import (GedRequest,  # noqa: E402
                                             GedVerificationService)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
WORLD = 4
GROUP_TIMEOUT = 150          # seconds for the whole group; killed after
MESHES = {"data": ((4,), ("data",)),
          "data-model": ((2, 2), ("data", "model")),
          "pod-data-model": ((2, 2, 1), ("pod", "data", "model"))}
PAIRS = 12
SMALL = dict(slots=16, pool=64, expand=4, max_iters=64, cache=False)
AUTO = dict(slots=16, batch_size=8, cache=False)
RUNGS = ((4, 1, 2), (8, 2, 4))       # the mix climbs every rung
MODES = {"compute": None, "verify2": 2.0}
COUNTERS = ("pairs", "escalated", "host_solved", "batches", "dispatches")
FAULT = "dispatch@times=1"           # rank 1's engines only
SERVICE = dict(slots=16, batch_size=8)
SHARES = (0.0, 1 / 3, None)          # deadline_s over an unbounded run's wall


def plain(g):
    return (g.vlabels.tolist(), [tuple(int(x) for x in e)
                                 for e in g.edges()])


def _mix(seed=5, count=PAIRS):
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


def _engine(pkg, backend, **kw):
    opts = AUTO if backend == "auto" else SMALL
    if pkg is ged:
        kw.setdefault("device", "cpu")
    eng = pkg.GedEngine(backend, **opts, **kw)
    if backend == "auto":
        eng._backend.scheduler.rungs = RUNGS
    return eng


# --------------------------------------------------------- the rank group

RANK = textwrap.dedent("""
    import datetime, pickle, sys, time
    import torch.distributed as dist
    from repro_torch import ged
    from repro_torch.ged import faults
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serving.ged_service import (GedRequest,
                                                 GedVerificationService)

    rank, store, path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    cfg = pickle.loads(open(path, "rb").read())
    pairs, tau = cfg["pairs"], cfg["tau"]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=cfg["world"],
                            timeout=datetime.timedelta(seconds=60))
    rec = {}

    def engine(backend, mesh, **kw):
        opts = cfg["auto"] if backend == "auto" else cfg["small"]
        eng = ged.GedEngine(backend, mesh=mesh, **opts, **kw)
        if backend == "auto":
            eng._backend.scheduler.rungs = cfg["rungs"]
        return eng

    def run(eng, t):
        return eng.compute(pairs) if t is None else eng.verify(pairs, t)

    meshes = {}
    for key, (shape, axes) in cfg["meshes"].items():
        meshes[key] = mesh = make_test_mesh(shape, axes)
        for backend in ("sharded", "auto"):
            for mode, t in cfg["modes"].items():
                eng = engine(backend, mesh)
                outs = run(eng, t)
                rec[key, backend, mode] = (outs, eng.batch_multiple,
                                           dict(eng.stats))
    mesh = meshes["data"]
    fault = cfg["fault"] if rank == 1 else None
    for backend in ("sharded", "auto"):
        eng = engine(backend, mesh, fault_inject=fault)
        rec["fault", backend] = (run(eng, tau), dict(eng.stats))
    real = faults.degradable
    faults.degradable = lambda exc, device: False
    for backend in ("sharded", "auto"):
        eng = engine(backend, mesh, fault_inject=fault)
        try:
            run(eng, tau)
            rec["raise", backend] = None
        except Exception as exc:
            rec["raise", backend] = (type(exc).__name__, str(exc))
    faults.degradable = real
    t0 = time.perf_counter()
    run(engine("auto", mesh), None)
    box = [time.perf_counter() - t0]
    dist.broadcast_object_list(box, src=0)
    for share in cfg["shares"]:
        for mode, t in cfg["modes"].items():
            eng = engine("auto", mesh, per_pair_deadline_s=1e-3,
                         deadline_s=None if share is None
                         else share * box[0])
            rec["deadline", share, mode] = (run(eng, t), dict(eng.stats))
    svc = GedVerificationService(mesh=mesh, **cfg["service"])
    svc.scheduler.rungs = cfg["rungs"]
    rec["service"] = svc.verify([GedRequest(ged.as_graph(q), ged.as_graph(g),
                                            tau=tau) for q, g in pairs])
    graphs = [q for q, _ in pairs]
    for key, make in (
            ("store", lambda: ged.GraphStore(graphs, mesh=mesh,
                                             engine=svc.engine)),
            ("corpus", lambda: svc.register_corpus(graphs, batch_size=4))):
        try:
            make()
            rec[key] = None
        except TypeError as exc:
            rec[key] = str(exc)
    dist.barrier()
    dist.destroy_process_group()
    open(out, "wb").write(pickle.dumps(rec))
""")

JAX_MULTIPLES = textwrap.dedent("""
    import json, sys, jax
    from repro.ged.exec import ShardedExecutor
    meshes = json.loads(sys.argv[1])
    print(json.dumps({k: ShardedExecutor(jax.make_mesh(tuple(s), tuple(a))
                                         ).batch_multiple
                      for k, (s, a) in meshes.items()}))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the rank group and the reference's mesh reader, compute the
    one-device answers meanwhile, then wait for both (killed on
    timeout)."""
    tmp = tmp_path_factory.mktemp("distributed")
    pairs = _mix()
    (tmp / "in.pkl").write_bytes(pickle.dumps(dict(
        pairs=pairs, tau=2.0, world=WORLD, meshes=MESHES, modes=MODES,
        small=SMALL, auto=AUTO, rungs=RUNGS, fault=FAULT, shares=SHARES,
        service=SERVICE)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(tmp / "store"),
         str(tmp / "in.pkl"), str(tmp / f"rank{r}.pkl")], env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", JAX_MULTIPLES, json.dumps(MESHES)],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        ref = {}
        for backend, ref_backend in (("sharded", "jax"), ("auto", "auto")):
            for mode, tau in MODES.items():
                eng = _engine(ref_ged, ref_backend)
                ref[backend, mode] = (_run(eng, pairs, tau), eng.stats)
        one = {}
        for backend in ("sharded", "auto"):
            eng = _engine(ged, backend, fault_inject=FAULT)
            one["fault", backend] = (_run(eng, pairs, 2.0), eng.stats)
        svc = GedVerificationService(device="cpu", **SERVICE)
        svc.scheduler.rungs = RUNGS
        one["service"] = svc.verify([GedRequest(
            ged.as_graph(q), ged.as_graph(g), tau=2.0) for q, g in pairs])
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=GROUP_TIMEOUT)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(WORLD)]
    multiples = json.loads(outs[-1].splitlines()[-1])
    return dict(pairs=pairs, ref=ref, one=one, recs=recs,
                multiples=multiples)


def _same_on_every_rank(recs, key, backend=True):
    rows = [[_row(o, backend) for o in rec[key][0]] for rec in recs]
    assert all(r == rows[0] for r in rows[1:]), key
    return rows[0]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("backend", ["sharded", "auto"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_returns_the_reference_one_device_outcomes(
        ranks, mesh, backend, mode):
    """Outcomes equal on every rank and to the reference's one-device
    ``"jax"`` (``"sharded"``) or ``"auto"`` run; ``"auto"``'s counters
    exactly; each rank ran its shard and gathered the rest."""
    recs, key = ranks["recs"], (mesh, backend, mode)
    want, want_stats = ranks["ref"][backend, mode]
    named = backend == "auto"
    got = _same_on_every_rank(recs, key, backend=named)
    assert got == [_row(o, named) for o in want]
    if backend == "sharded":
        assert {o.backend for o in recs[0][key][0]} == {"sharded"}
    for rec in recs:
        _, multiple, stats = rec[key]
        assert stats["executor_single_device_fastpath"] == 0
        assert stats["executor_gathers"] >= 1
        assert stats["executor_pairs"] == recs[0][key][2]["executor_pairs"]
        if backend == "auto":
            assert _counters(stats) == _counters(want_stats)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_multiple_equals_the_reference(ranks, mesh):
    """4, 2 and 4 pair shards: the product of the pairs axes' sizes, as
    the reference's ``ShardedExecutor`` reads a JAX mesh of the same
    shape and axes."""
    want = ranks["multiples"][mesh]
    assert want == {"data": 4, "data-model": 2, "pod-data-model": 4}[mesh]
    for rec in ranks["recs"]:
        for backend in ("sharded", "auto"):
            for mode in MODES:
                assert rec[mesh, backend, mode][1] == want


@pytest.mark.parametrize("backend", ["sharded", "auto"])
def test_a_fault_on_one_rank_degrades_the_same_bucket_on_every_rank(
        ranks, backend):
    """A permanent dispatch fault on rank 1 alone: every rank host-solves
    the same pairs (equal ``degraded_host``) and answers as the port's
    one-device engine with the fault injected; only rank 1 counts the
    fault itself."""
    recs = ranks["recs"]
    got = _same_on_every_rank(recs, ("fault", backend))
    want, want_stats = ranks["one"]["fault", backend]
    assert got == [_row(o) for o in want]
    assert any(o.degraded for o in want)
    for r, rec in enumerate(recs):
        stats = rec["fault", backend][1]
        assert stats["degraded_host"] == want_stats["degraded_host"] > 0
        assert ("fault_dispatch" in stats) == (r == 1)


@pytest.mark.parametrize("backend", ["sharded", "auto"])
def test_a_fault_that_cannot_degrade_raises_on_every_rank(ranks, backend):
    """With ``faults.degradable`` false, rank 1's fault raises on every
    rank with the same type and message, and the group goes on to its
    next case (no rank hangs)."""
    seen = {rec["raise", backend] for rec in ranks["recs"]}
    assert seen == {("InjectedFault", "injected permanent fault at "
                     "'dispatch'")}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("share", SHARES)
def test_deadlines_give_every_rank_the_same_sound_answers(
        ranks, share, mode):
    """``"auto"`` under a deadline of 0, of a third of an unbounded run
    and of none, each with 1 ms per host pair (the first rank's host
    solves, under its own clock, answer for every rank): the same
    outcomes on every rank, each sound
    against the exact GED (certified: the exact answer; uncertified:
    bounds that bracket it and a verdict, if any, that agrees); a
    deadline of 0 certifies nothing."""
    got = ranks["recs"][0]["deadline", share, mode][0]
    _same_on_every_rank(ranks["recs"], ("deadline", share, mode))
    truth = [o.ged for o in ranks["ref"]["auto", "compute"][0]]
    tau = MODES[mode]
    for o, d in zip(got, truth):
        if o.certified:
            assert (o.ged == d) if tau is None else \
                (o.similar == (d <= tau)), (o, d)
            continue
        assert o.lower_bound <= d <= o.upper_bound, (o, d)
        assert tau is None or o.similar is None or o.similar == (d <= tau)
    if share == 0.0:
        assert not any(o.certified for o in got)
        assert all(o.timed_out for o in got)


def test_the_verification_service_answers_like_one_device(ranks):
    rows = [[_row(o) for o in rec["service"]] for rec in ranks["recs"]]
    assert all(r == rows[0] for r in rows[1:])
    assert rows[0] == [_row(o) for o in ranks["one"]["service"]]


def test_a_store_over_a_distributed_mesh_raises_type_error(ranks):
    """A mesh beside ``engine=``, and engine options where the store
    shares the service's engine, raise on every rank, before any
    collective."""
    for rec in ranks["recs"]:
        assert "engine= is exclusive" in rec["store"]
        assert "['mesh']" in rec["store"]
        assert "engine= is exclusive" in rec["corpus"]
        assert "['batch_size']" in rec["corpus"]


# ------------------------------------------------- without a process group

class _FakeMesh:
    """The surface of a ``torch.distributed`` ``DeviceMesh`` that the
    placement reads, for one rank."""

    def __init__(self, shape, names, coord, device_type="cpu"):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self.device_type = device_type
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self._coord = list(coord)

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("shape,names,coord,axes,want", [
    ((4,), ("data",), (2,), None, (2, 4)),
    ((2, 2), ("data", "model"), (1, 0), None, (1, 2)),
    ((2, 3, 2), ("pod", "data", "model"), (1, 2, 1), None, (5, 6)),
    ((2, 2), ("data", "model"), (1, 1), ("model", "data"), (3, 4)),
    ((2, 4), ("x", "model"), (1, 3), None, (1, 2)),
])
def test_rank_shard_is_the_coordinate_over_the_pairs_axes(
        shape, names, coord, axes, want):
    """Row-major over the pairs axes (``pod`` x ``data``, else the first
    axis, or the ``axes`` named), replicated over the rest; the local
    device of a CPU mesh is the CPU."""
    mesh = _FakeMesh(shape, names, coord)
    assert is_distributed_mesh(mesh)
    shard = rank_shard(mesh, axes)
    assert (shard.index, shard.count) == want
    assert shard.axes == (tuple(axes) if axes else pairs_axes(mesh))
    assert shard.device == torch.device("cpu")
    assert shard.ranks == tuple(range(int(np.prod(shape))))


def test_rank_shard_errors_and_what_is_not_a_distributed_mesh():
    mesh = _FakeMesh((2, 2), ("data", "model"), (0, 1))
    with pytest.raises(ValueError, match="disagrees"):
        rank_shard(mesh, device="cuda:0")
    with pytest.raises(ValueError, match="distinct names"):
        rank_shard(mesh, axes=("pod",))
    outside = _FakeMesh((2, 2), ("data", "model"), (0, 1))
    outside._coord = None
    with pytest.raises(ValueError, match="not a member"):
        rank_shard(outside)
    assert not is_distributed_mesh(DeviceMesh([["cpu"] * 2] * 2,
                                              ("data", "model")))
    assert not any(is_distributed_mesh(m) for m in (None, ["cpu"] * 2,
                                                    "cpu", object()))
    with pytest.raises(ValueError, match="disagrees"):
        ged.GedEngine("sharded", mesh=mesh, device="cuda")
