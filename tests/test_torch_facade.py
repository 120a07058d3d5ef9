"""The port's ``repro_torch.ged`` facade: import hygiene, device rules,
backend policy (``"auto"`` the default, the ``"sharded"`` backend and the
ported engine options treated as the reference treats them), and outcomes
against the reference ``repro.ged``.

Outcomes are held to the reference's ``"jax"`` backend on the same pairs:
``ged``, ``similar``, ``certified``, ``lower_bound``, ``upper_bound``,
``mapping``, ``tau`` and the engine stats must be equal.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ged as ref_ged  # noqa: E402
from repro.data.graphs import aids_like_graph, perturb, random_graph  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.core.engine.api import dispatch_packed  # noqa: E402
from repro_torch.core.engine.search import EngineConfig  # noqa: E402
from repro_torch.core.engine.tensor_graphs import pack_pairs  # noqa: E402
from repro_torch.ged.exec import Executor, PendingBatch  # noqa: E402
from repro_torch.ged.plan import build_plan  # noqa: E402
from repro_torch.store_io import SHARED_CACHE_ENV  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(pool=64, expand=4, max_iters=64)


def _workload(seed, count, n_lo, n_hi):
    """(vlabels, edges) pairs — the facade's adapter form, plain lists."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(n_lo, n_hi + 1))
        if i % 2:
            g = random_graph(rng, n, density=0.4, n_vlabels=3, n_elabels=2)
        else:
            g = aids_like_graph(rng, n, n_vlabels=6, n_elabels=2)
        h = perturb(rng, g, int(rng.integers(0, 4)), n_vlabels=6, n_elabels=2)
        out.append(tuple(
            (x.vlabels.tolist(), [e for e in x.edges()]) for x in (g, h)))
    return out


def _same(a, b):
    assert (a.ged, a.similar, a.certified, a.lower_bound, a.upper_bound,
            a.tau) == (b.ged, b.similar, b.certified, b.lower_bound,
                       b.upper_bound, b.tau)
    for k in ("rung", "iterations", "expanded"):
        assert a.stats[k] == b.stats[k], k
    if a.mapping is None or b.mapping is None:
        assert a.mapping is None and b.mapping is None
    else:
        assert np.array_equal(a.mapping, b.mapping)


# ---------------------------------------------------------- import hygiene

def test_import_pulls_in_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch, repro_torch.ged\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
        "       or m.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_have_no_jax_or_reference_imports():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|"
        r"from\s+repro(\.|\s+import))")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"src/repro_torch/core/exact/search.py",
            "src/repro_torch/runtime/scheduler.py",
            "src/repro_torch/store_io/atomic.py",
            "src/repro_torch/store_io/shared_cache.py",
            "src/repro_torch/ged/exec.py",
            "src/repro_torch/kernels/autotune.py",
            "src/repro_torch/parallel/sharding.py",
            "src/repro_torch/serving/__init__.py",
            "src/repro_torch/serving/ged_service.py",
            "src/repro_torch/launch/__init__.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/qwen3_8b.py",
            "src/repro_torch/models/config.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/flash.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/params.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/serving/lm_decode.py",
            "src/repro_torch/optim/__init__.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/schedule.py",
            "src/repro_torch/optim/compress.py",
            "src/repro_torch/data/tokens.py",
            "src/repro_torch/checkpoint/__init__.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/runtime/loop.py",
            "src/repro_torch/parallel/pipeline.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/parallel/__init__.py",
            "src/repro_torch/launch/shapes.py",
            "src/repro_torch/launch/flops.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/steps.py",
            "src/repro_torch/launch/step_analysis.py",
            "src/repro_torch/launch/dryrun.py"} <= names
    offenders = [f"{f.name}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert not offenders, offenders


def test_training_packages_cover_the_reference_public_surface():
    """``__all__`` of the port's optim, checkpoint, runtime and data
    packages holds every name of the reference's."""
    import importlib
    for pkg in ("optim", "checkpoint", "runtime", "data"):
        ref = importlib.import_module(f"repro.{pkg}")
        port = importlib.import_module(f"repro_torch.{pkg}")
        assert set(ref.__all__) <= set(port.__all__), pkg
        assert all(hasattr(port, name) for name in port.__all__), pkg


# ------------------------------------------------------------ device rules

def test_default_device_is_the_card_and_never_silently_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = _workload(0, 1, 3, 4)
    for call in (lambda: ged.GedEngine(),
                 lambda: ged.GedEngine("torch"),
                 lambda: ged.verify(pairs, 1.0),
                 lambda: ged.compute(pairs),
                 lambda: ged.verify(pairs, 1.0, backend="torch"),
                 lambda: Executor(),
                 lambda: dispatch_packed(pack_pairs(_graphs(pairs)), [0.0],
                                         EngineConfig(), False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ged.GedEngine("torch", device="cpu").device.type == "cpu"


def _graphs(pairs):
    return [tuple(ged.as_graph(x) for x in p) for p in pairs]


# ---------------------------------------------------------- backend policy

@pytest.mark.parametrize("name", ["sharded"])
def test_unported_backends_point_at_the_roadmap(name):
    """Every backend the reference registers is ported now.  ``"sharded"``
    on one device is the single-device fast path, as in the reference on
    its one CPU device: ``batch_multiple`` 1, every dispatch counted in
    ``executor_single_device_fastpath``, and outcomes equal to the
    reference's ``"sharded"`` and to the port's ``"torch"``."""
    assert name in ged.available_backends()
    pairs = _workload(4, 5, 3, 7)
    port = ged.GedEngine(name, device="cpu", slots=8, cache=False, **SMALL)
    ref = ref_ged.GedEngine(name, slots=8, cache=False, **SMALL)
    plain = ged.GedEngine("torch", device="cpu", slots=8, cache=False,
                          **SMALL)
    assert port.batch_multiple == ref.batch_multiple == 1
    assert port.config.use_kernel is False
    for verification in (False, True):
        run = ((lambda e: e.verify(pairs, 2.0)) if verification
               else (lambda e: e.compute(pairs)))
        got, want, same = run(port), run(ref), run(plain)
        for a, b, c in zip(got, want, same):
            _same(a, b)
            _same(a, c)
            assert a.backend == b.backend == name
    assert port.stats["executor_single_device_fastpath"] == \
        ref.stats["executor_single_device_fastpath"] == \
        port.stats["executor_calls"] > 0


@pytest.mark.parametrize("name", ["auto", "exact"])
def test_auto_and_exact_backends_work_and_auto_is_the_default(name):
    """Both answer, certified, with the host solver's distances; a bare
    ``compute`` / ``verify`` / ``GedEngine`` is the ``"auto"`` backend."""
    pairs = _workload(2, 4, 3, 7)
    exact = ref_ged.GedEngine("exact", cache=False).compute(pairs)
    outs = ged.GedEngine(name, device="cpu", cache=False).compute(pairs)
    assert [o.ged for o in outs] == [o.ged for o in exact]
    assert all(o.certified for o in outs)
    assert {o.backend for o in outs} <= {name, "auto/exact"}
    default = ged.compute(pairs, device="cpu", cache=False)
    assert {o.backend for o in default} <= {"auto", "auto/exact"}
    assert [o.ged for o in default] == [o.ged for o in exact]
    assert ged.GedEngine(device="cpu").backend == "auto"
    assert [o.similar for o in ged.verify(pairs, 2.0, device="cpu")] == \
        [o.ged <= 2.0 for o in exact]


@pytest.mark.parametrize("option", [
    "cache", "shared_cache_dir", "deadline_s", "retry", "fault_inject",
    "digest", "mesh"])
def test_unported_options_raise_type_error(option, monkeypatch):
    """Every engine option of the reference is ported (``mesh`` was the
    last), so given ``None`` the port does what the reference does:
    ``cache=None``, ``shared_cache_dir=None``, ``deadline_s=None``,
    ``retry=None``, ``fault_inject=None`` and ``mesh=None`` are accepted
    and answer like the reference, ``digest=None`` raises ``ValueError``
    in both packages.  Per call, ``deadline_s=None`` is a keyword of
    ``compute`` in both packages and answers like the reference; the rest
    are engine options, not ``EngineConfig`` fields, so both raise
    ``TypeError`` for unknown engine options."""
    monkeypatch.delenv(SHARED_CACHE_ENV, raising=False)
    pairs = _workload(1, 1, 3, 4)
    eng = ged.GedEngine("torch", device="cpu", **SMALL)
    if option == "deadline_s":
        ref = ref_ged.GedEngine("jax", slots=8, cache=False, **SMALL)
        port = ged.GedEngine("torch", device="cpu", slots=8, cache=False,
                             **SMALL)
        for a, b in zip(port.compute(pairs, deadline_s=None),
                        ref.compute(pairs, deadline_s=None)):
            _same(a, b)
            assert not a.timed_out and not b.timed_out
    else:
        ref = ref_ged.GedEngine("jax", slots=8, **SMALL)
        for e in (eng, ref):
            with pytest.raises(TypeError, match="unknown engine options"):
                e.compute(pairs, **{option: None})
    if option == "digest":
        for make in (lambda: ged.GedEngine(device="cpu", digest=None),
                     lambda: ref_ged.GedEngine("jax", digest=None)):
            with pytest.raises(ValueError, match="unknown digest"):
                make()
        return
    port = ged.GedEngine("torch", device="cpu", slots=8, **SMALL,
                         **{option: None})
    ref = ref_ged.GedEngine("jax", slots=8, **SMALL, **{option: None})
    for _ in range(2):
        for a, b in zip(port.compute(pairs), ref.compute(pairs)):
            _same(a, b)
            assert a.stats.get("cached") == b.stats.get("cached")
            assert (a.timed_out, a.degraded) == (b.timed_out, b.degraded)
    for key in ("result_cache_hits", "shared_cache_hits", "retries",
                "timed_out_pairs"):
        assert (key in port.stats) == (key in ref.stats), key
    assert port.shared_cache_dir is None and ref.shared_cache_dir is None


def test_backend_registry_and_unknown_names():
    assert ged.available_backends() == ("auto", "cuda", "exact", "sharded",
                                        "torch")
    with pytest.raises(ValueError, match="unknown backend"):
        ged.GedEngine("pallas", device="cpu")
    with pytest.raises(TypeError, match="unknown GedEngine options"):
        ged.GedEngine("torch", device="cpu", pools=3)


def test_use_kernel_contradictions_raise():
    with pytest.raises(ValueError, match="implies use_kernel=False"):
        ged.GedEngine("torch", device="cpu", use_kernel=True)
    with pytest.raises(ValueError, match="implies use_kernel=True"):
        ged.GedEngine("cuda", device="cpu", use_kernel=False)
    eng = ged.GedEngine("torch", device="cpu", **SMALL)
    assert eng.config.use_kernel is False
    assert ged.GedEngine("cuda", device="cpu").config.use_kernel is True
    with pytest.raises(ValueError, match="implies use_kernel"):
        eng.compute(_workload(1, 1, 3, 4), use_kernel=True)
    with pytest.raises(TypeError, match="unknown engine options"):
        eng.compute(_workload(1, 1, 3, 4), pools=3)
    assert eng.compute([]) == []


# ------------------------------------------------------------- outcomes

@pytest.mark.parametrize("verification", [False, True])
def test_outcomes_equal_reference_jax_backend(verification):
    """One slot bucket (pinned), both port backends on the CPU against the
    reference's unfused ``"jax"`` backend."""
    pairs = _workload(7, 6, 3, 8)
    tau = [0.0, 1.0, 2.0, 3.0, 1.5, 2.5]
    ref = ref_ged.GedEngine("jax", cache=False, slots=8, **SMALL)
    want = ref.verify(pairs, tau) if verification else ref.compute(pairs)
    for backend in ("torch", "cuda"):
        eng = ged.GedEngine(backend, device="cpu", cache=False, slots=8,
                            **SMALL)
        got = eng.verify(pairs, tau) if verification else eng.compute(pairs)
        assert [o.backend for o in got] == [backend] * len(pairs)
        for a, b in zip(got, want):
            _same(a, b)


def test_bucketed_workload_cuda_equals_torch_and_exact_answers():
    """Mixed sizes land in several slot buckets; the two backends agree,
    results come back in input order, and certified distances equal the
    reference host solver's."""
    pairs = _workload(3, 7, 2, 12)
    plan = build_plan(pairs)
    assert len(plan.buckets) >= 2
    outs = {b: ged.GedEngine(b, device="cpu", cache=False,
                             **SMALL).compute(pairs)
            for b in ("torch", "cuda")}
    exact = ref_ged.GedEngine("exact", cache=False).compute(pairs)
    for a, b, e in zip(outs["torch"], outs["cuda"], exact):
        _same(a, b)
        if a.certified:
            assert a.ged == e.ged
            assert a.lower_bound <= a.ged <= a.upper_bound


def test_module_level_helpers_and_executor_stats():
    pairs = _workload(5, 3, 3, 6)
    comp = ged.compute(pairs, backend="torch", device="cpu", **SMALL)
    ver = ged.verify(pairs, tau=2.0, backend="cuda", device="cpu", **SMALL)
    assert [o.similar for o in comp] == [None] * 3
    assert all(o.tau == 2.0 for o in ver)
    for c, v in zip(comp, ver):
        if c.certified and v.certified:
            assert v.similar == (c.ged <= 2.0)
    eng = ged.GedEngine("torch", device="cpu", **SMALL)
    eng.compute(pairs)
    assert eng.stats["executor_calls"] >= 1
    assert eng.stats["executor_pairs"] == 3
    p = PendingBatch({"x": torch.arange(3)})
    assert p.result()["x"].tolist() == [0, 1, 2]
    assert p.result() is p.result()
