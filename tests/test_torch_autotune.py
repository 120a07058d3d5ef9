"""The port's measured kernel dispatch (``repro_torch/kernels/autotune.py``)
against the reference's contracts (``tests/test_autotune.py``).

* the tuning table: round trip through disk, corrupt and alien files
  recover to an empty table, nearest-B lookup, hit/miss counters;
* dispatch resolution: ``use_kernel="auto"`` pins a concrete
  ``KernelDispatch`` (table winners when tuned, the static heuristic when
  not, hostile tile sizes neutralised);
* one ``tuning.json`` reads the same in both packages (device kind
  ``"cpu"``);
* engine outputs are bit-identical across every dispatch decision.

Everything runs on the CPU, where every wrapper calls its plain twin.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine.search import EngineConfig as RefConfig  # noqa: E402
from repro.kernels import autotune as ref_autotune  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.core.engine.api import dispatch_packed  # noqa: E402
from repro_torch.core.engine.search import EngineConfig  # noqa: E402
from repro_torch.core.engine.tensor_graphs import pack_pairs  # noqa: E402
from repro_torch.data.graphs import perturb, random_graph  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.autotune import KernelDispatch  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _isolated_tables():
    """Private in-memory tables for both packages, restored afterwards."""
    saved, ref_saved = autotune.snapshot(), ref_autotune.snapshot()
    autotune.reset()
    ref_autotune.reset()
    yield
    autotune.restore(saved)
    ref_autotune.restore(ref_saved)


def _make_pairs(seed, count, nmin=4, nmax=9, ops=5):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        n = int(rng.integers(nmin, nmax))
        q = random_graph(rng, n, density=0.35, n_vlabels=3, n_elabels=2)
        if rng.random() < 0.5:
            g = perturb(rng, q, int(rng.integers(0, ops)),
                        n_vlabels=3, n_elabels=2)
        else:
            g = random_graph(rng, int(rng.integers(nmin, nmax)),
                             density=0.35, n_vlabels=3, n_elabels=2)
        pairs.append((q, g))
    return pairs


# ------------------------------------------------------------------ table

def test_table_round_trip(tmp_path):
    autotune.enable_autotune(str(tmp_path))
    autotune.put("lsa", 32, 8, {"impl": "fused", "tile_u": 8, "us": 1.0},
                 device=CPU)
    autotune.put("merge", 512, 256, {"impl": "unfused", "us": 2.0},
                 device=CPU)
    autotune.reset()
    autotune.enable_autotune(str(tmp_path))
    ent = autotune.lookup("lsa", 32, 8, count=False, device=CPU)
    assert ent is not None and ent["impl"] == "fused" and ent["tile_u"] == 8
    assert autotune.lookup("merge", 512, 256, count=False,
                           device=CPU)["us"] == 2.0
    assert ent["kernel"] == "lsa" and ent["N"] == 32 and ent["B"] == 8
    assert ent["device_kind"] == autotune.device_kind(CPU) == "cpu"


def test_table_corrupt_file_recovers_empty(tmp_path):
    path = tmp_path / autotune.TABLE_FILE
    path.write_text("{this is not json")
    autotune.enable_autotune(str(tmp_path))
    assert autotune.lookup("lsa", 32, 8, count=False, device=CPU) is None
    autotune.put("lsa", 32, 8, {"impl": "unfused"}, device=CPU)
    data = json.loads(path.read_text())
    assert data["version"] == autotune._SCHEMA_VERSION
    assert len(data["entries"]) == 1


@pytest.mark.parametrize("payload", [
    "[]",                                   # wrong top-level type
    '{"version": 999, "entries": {}}',      # alien schema version
    '{"version": 1, "entries": [1, 2]}',    # entries not a map
])
def test_table_alien_schema_recovers_empty(tmp_path, payload):
    (tmp_path / autotune.TABLE_FILE).write_text(payload)
    autotune.enable_autotune(str(tmp_path))
    assert autotune._AUTOTUNE["table"] == {}


def test_lookup_nearest_b_and_counters():
    autotune.put("lsa", 32, 8, {"impl": "unfused"}, device=CPU)
    autotune.put("lsa", 32, 128, {"impl": "fused", "tile_u": 0}, device=CPU)
    assert autotune.lookup("lsa", 32, 8, device=CPU)["impl"] == "unfused"
    # nearest B in log space: 64 is closer to 128 than to 8
    assert autotune.lookup("lsa", 32, 64, device=CPU)["impl"] == "fused"
    assert autotune.lookup("lsa", 32, 2, device=CPU)["impl"] == "unfused"
    assert autotune.lookup("lsa", 64, 8, device=CPU) is None
    s = autotune.autotune_stats()
    assert s["autotune_hits"] == 3 and s["autotune_misses"] == 1
    assert s["autotune_entries"] == 2


def test_enable_is_idempotent_and_repoint_reloads(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    autotune.enable_autotune(str(a))
    autotune.put("lsa", 16, 8, {"impl": "fused"}, device=CPU)
    assert autotune.enable_autotune(str(a)) == str(a)
    assert autotune.lookup("lsa", 16, 8, count=False, device=CPU) is not None
    autotune.enable_autotune(str(b))
    assert autotune.lookup("lsa", 16, 8, count=False, device=CPU) is None
    autotune.enable_autotune(str(a))
    assert autotune.lookup("lsa", 16, 8, count=False, device=CPU) is not None


def test_device_kind_of_the_card_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.device_kind()
    assert autotune.device_kind(torch.device("cpu")) == "cpu"


# --------------------------------------------------------------- dispatch

def test_resolve_config_uses_table_winners():
    autotune.put("lsa", 16, 64, {"impl": "fused", "tile_u": 8}, device=CPU)
    autotune.put("bma", 16, 64, {"impl": "unfused"}, device=CPU)
    autotune.put("merge", 1024, 128, {"impl": "fused"}, device=CPU)
    cfg = EngineConfig(use_kernel="auto")
    r = autotune.resolve_config(cfg, slots=16, batch=8, device=CPU)
    assert r.use_kernel == "auto"
    assert r.dispatch == KernelDispatch(
        lsa_fused=True, lsa_tile_u=8, bma_fused=False, merge_fused=True)
    cfg2 = EngineConfig(use_kernel=True)
    assert autotune.resolve_config(cfg2, 16, 8, device=CPU) is cfg2
    pinned = EngineConfig(use_kernel="auto", dispatch=KernelDispatch())
    assert autotune.resolve_config(pinned, 16, 8, device=CPU) is pinned


def test_resolve_config_untuned_falls_back_to_heuristic():
    cfg = EngineConfig(use_kernel="auto")
    r = autotune.resolve_config(cfg, slots=16, batch=8, device=CPU)
    assert r.dispatch == autotune.static_heuristic(16, CPU) == KernelDispatch()
    big = autotune.resolve_config(cfg, slots=128, batch=8, device=CPU)
    assert big.dispatch == KernelDispatch()        # the CPU never fuses
    assert autotune.static_heuristic(128, "cuda") == KernelDispatch(
        lsa_fused=True, bma_fused=True)
    assert autotune.static_heuristic(64, "cuda") == KernelDispatch()


def test_resolve_config_neutralises_hostile_tiles():
    autotune.put("lsa", 16, 64, {"impl": "fused", "tile_u": 7}, device=CPU)
    autotune.put("bma", 16, 64, {"impl": "fused", "tile_v": "x",
                                 "tile_u": -8}, device=CPU)
    r = autotune.resolve_config(EngineConfig(use_kernel="auto"), 16, 8,
                                device=CPU)
    assert r.dispatch.lsa_fused and r.dispatch.lsa_tile_u == 0
    assert r.dispatch.bma_fused and r.dispatch.bma_tile_v == 0 \
        and r.dispatch.bma_tile_u == 0


def test_concrete_dispatch_is_pure_in_cfg():
    autotune.put("lsa", 16, 8, {"impl": "unfused"}, device=CPU)
    on = autotune.concrete_dispatch(EngineConfig(use_kernel=True), 16, CPU)
    assert on.lsa_fused and on.bma_fused and not on.merge_fused
    off = autotune.concrete_dispatch(EngineConfig(use_kernel=False), 16, CPU)
    assert off == KernelDispatch()
    d = KernelDispatch(merge_fused=True)
    cfg = EngineConfig(use_kernel="auto", dispatch=d)
    assert autotune.concrete_dispatch(cfg, 16, CPU) is d
    cfg2 = EngineConfig(use_kernel="auto")
    assert autotune.concrete_dispatch(cfg2, 256, "cuda") == \
        autotune.static_heuristic(256, "cuda")
    assert autotune.autotune_stats()["autotune_hits"] == 0   # never read


def test_engine_config_validates_use_kernel():
    with pytest.raises(ValueError):
        EngineConfig(use_kernel="fast")
    for v in (True, False, "auto"):
        assert EngineConfig(use_kernel=v).use_kernel == v


@pytest.mark.parametrize("kernel,n,b", [("lsa", 8, 4), ("bma", 8, 4),
                                        ("merge", 24, 16)])
def test_tune_shape_records_measured_winner(kernel, n, b, tmp_path):
    autotune.enable_autotune(str(tmp_path))
    ent = autotune.tune_shape(kernel, n, b, device=CPU, budget_s=0.01)
    assert ent["impl"] in ("fused", "unfused")
    assert ent["us"] == min(ent["fused_us"], ent["unfused_us"])
    assert ent["tile_v"] == ent["tile_u"] == 0
    assert autotune.lookup(kernel, n, b, count=False, device=CPU) == ent
    assert autotune.autotune_stats()["autotune_sweep_s"] > 0
    bound = kernel != "merge"
    assert autotune.tune(kernels=(kernel,) if bound else (), ns=(n,),
                         bs=(b,), merge_shapes=() if bound else ((n, b),),
                         device=CPU) == []             # already tuned
    on_disk = json.loads((tmp_path / autotune.TABLE_FILE).read_text())
    assert list(on_disk["entries"]) == [f"cpu|{kernel}|N={n}|B={b}"]


# ------------------------------------------- one table, both packages

REF_ROWS = [("lsa", 16, 64, {"impl": "fused", "tile_u": 8}),
            ("bma", 16, 64, {"impl": "fused", "tile_v": 8, "tile_u": 4}),
            ("merge", 1024, 128, {"impl": "fused"}),
            ("lsa", 32, 8, {"impl": "unfused"})]


def _fields(d):
    return (d.lsa_fused, d.lsa_tile_u, d.bma_fused, d.bma_tile_v,
            d.bma_tile_u, d.merge_fused)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tuning_file_reads_the_same_in_both_packages(tmp_path, writer):
    for kernel, n, b, entry in REF_ROWS:
        if writer == "reference":
            ref_autotune.enable_autotune(str(tmp_path))
            ref_autotune.put(kernel, n, b, entry)
        else:
            autotune.enable_autotune(str(tmp_path))
            autotune.put(kernel, n, b, entry, device=CPU)
    autotune.reset()
    ref_autotune.reset()
    autotune.enable_autotune(str(tmp_path))
    ref_autotune.enable_autotune(str(tmp_path))
    for slots, batch in ((16, 8), (32, 2), (64, 4)):
        got = autotune.resolve_config(EngineConfig(use_kernel="auto"), slots,
                                      batch, device=CPU).dispatch
        want = ref_autotune.resolve_config(RefConfig(use_kernel="auto"),
                                           slots, batch).dispatch
        assert _fields(got) == _fields(want), (slots, batch)
    assert autotune.autotune_stats()["autotune_entries"] == len(REF_ROWS)


# ------------------------------------------------- engine parity (the gate)

_DISPATCHES = [
    KernelDispatch(),
    KernelDispatch(lsa_fused=True, bma_fused=True),
    KernelDispatch(lsa_fused=True, lsa_tile_u=8,
                   bma_fused=True, bma_tile_v=8, bma_tile_u=8),
    KernelDispatch(merge_fused=True),
    KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=True),
]


@pytest.mark.parametrize("strategy", ["astar", "dfs"])
@pytest.mark.parametrize("verification", [False, True])
def test_engine_bit_identical_across_dispatch(strategy, verification):
    pairs = _make_pairs(23 if not verification else 27, 6)
    packed = pack_pairs(pairs, slots=16)
    taus = np.asarray([2.0, 3.0, 2.0, 4.0, 1.0, 3.0], np.float32)
    base = dict(pool=128, expand=4, max_iters=64, strategy=strategy)
    want = dispatch_packed(packed, taus, EngineConfig(use_kernel=False,
                                                      **base),
                           verification, device=CPU)
    for d in _DISPATCHES:
        got = dispatch_packed(packed, taus, EngineConfig(
            use_kernel="auto", dispatch=d, **base), verification, device=CPU)
        assert set(got) == set(want)
        for key in got:
            assert torch.equal(got[key], want[key]), (strategy, d, key)


# ----------------------------------------------------------------- facade

def test_facade_accepts_auto_on_every_backend():
    pairs = _make_pairs(3, 3, nmin=4, nmax=7)
    outs = {}
    for backend in ("torch", "cuda", "exact", "auto"):
        eng = ged.GedEngine(backend, device=CPU, use_kernel="auto",
                            pool=128, max_iters=128)
        assert eng.config.use_kernel == "auto"
        outs[backend] = [(o.ged, o.certified) for o in eng.compute(pairs)]
    assert outs["torch"] == outs["cuda"] == outs["exact"] == outs["auto"]
    with pytest.raises(ValueError):
        ged.GedEngine("torch", device=CPU, use_kernel=True)
    with pytest.raises(ValueError):
        ged.GedEngine("cuda", device=CPU, use_kernel=False)


def test_facade_stats_surface_autotune(tmp_path):
    eng = ged.GedEngine("torch", device=CPU, use_kernel="auto",
                        autotune_dir=str(tmp_path), pool=128, max_iters=128)
    assert eng.autotune_dir == str(tmp_path)
    eng.compute(_make_pairs(5, 2, nmin=4, nmax=7))
    s = eng.stats
    for key in ("autotune_hits", "autotune_misses", "autotune_sweep_s",
                "autotune_entries", "executor_calls"):
        assert key in s, key
    assert s["autotune_misses"] >= 1


def test_facade_auto_resolution_per_bucket(tmp_path, monkeypatch):
    """Two buckets, one engine: the tuned bucket resolves to its table
    winner, the other to the heuristic; the outcomes equal the unfused
    engine's."""
    small = _make_pairs(7, 2, nmin=4, nmax=7)
    big = _make_pairs(9, 2, nmin=10, nmax=13)
    buckets = ged.build_plan(small + big).buckets
    assert len(buckets) >= 2
    tuned = buckets[0]
    autotune.enable_autotune(str(tmp_path))
    autotune.put("lsa", tuned.slots, tuned.packed.batch * 8,
                 {"impl": "fused"}, device=CPU)
    seen = []
    real = autotune.resolve_config

    def spy(cfg, slots, batch, device=None):
        out = real(cfg, slots, batch, device)
        seen.append((slots, out.dispatch))
        return out

    monkeypatch.setattr(autotune, "resolve_config", spy)
    eng = ged.GedEngine("torch", device=CPU, use_kernel="auto", pool=128,
                        max_iters=128)
    outs = eng.compute(small + big)
    assert seen == [(b.slots, KernelDispatch(lsa_fused=b is tuned))
                    for b in buckets]
    want = ged.GedEngine("torch", device=CPU, pool=128,
                         max_iters=128).compute(small + big)
    for a, b in zip(outs, want):
        assert (a.ged, a.certified, a.lower_bound) == \
            (b.ged, b.certified, b.lower_bound)
