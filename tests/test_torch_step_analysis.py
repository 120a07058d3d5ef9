"""``launch/step_analysis.py``, the port's stand-in for the reference's
``hlo_analysis``: the counterparts of ``tests/test_hlo_analysis.py`` and
``test_hlo_analyzer_counts_scan_trips``.

An L = 7 loop of ``(16, 256) @ (256, 256)`` with the weights sharded over
``model`` on a fake ``(2, 4)`` mesh counts per-device dot FLOPs within
``[1, 1.2] x 2*8*64*256*L`` and collective bytes of at least
``8*64*4*L``, with no warnings; the loop's carry keeps its layout from
trip to trip, as a scanned carry does.  A collective over ``pod`` counts
as DCN, one over ``data`` does not.  Process groups run in a subprocess
with a timeout of its own."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.launch.step_analysis import StepCounter, analyze_step

ROOT = Path(__file__).resolve().parents[1]

FAKE = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.step_analysis import analyze_step
    out = {}
    init_fake_group(8)
    mesh = make_test_mesh((2, 4), ("data", "model"))
    L, D = 7, 256
    w = distribute_tensor(torch.empty(L, D, D, device="meta"), mesh,
                          [Replicate(), Shard(2)])
    x = distribute_tensor(torch.empty(16, D, device="meta"), mesh,
                          [Shard(0), Replicate()])

    def step(w, x):
        c = x
        for i in range(L):
            # the carry keeps its layout across trips (a scanned carry)
            c = torch.tanh(c @ w[i]).redistribute(mesh, x.placements)
        return c.sum()

    out["loop"] = analyze_step(step, (w, x), mesh)
    dist.destroy_process_group()

    init_fake_group(8)
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    y = distribute_tensor(torch.empty(8, 64, device="meta"), mesh,
                          [Shard(0), Replicate(), Replicate()])
    z = distribute_tensor(torch.empty(8, 64, device="meta"), mesh,
                          [Replicate(), Shard(0), Replicate()])
    rep = [Replicate()] * 3
    out["pod"] = analyze_step(lambda t: t.redistribute(mesh, rep), (y,),
                              mesh)
    out["data"] = analyze_step(lambda t: t.redistribute(mesh, rep), (z,),
                               mesh)
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", FAKE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


def test_loop_counts_every_trip(fake_runs):
    out, L = fake_runs["loop"], 7
    dot_flops = 2 * 8 * 64 * 256 * L          # per device, L trips
    assert dot_flops <= out["flops"] <= dot_flops * 1.2, out
    assert out["collective_bytes"] >= 8 * 64 * 4 * L, out  # all-gather x L
    assert out["collective_by_op"]["all-gather"] >= 8 * 64 * 4 * L
    assert not out["warnings"], out["warnings"]
    assert out["dcn_bytes"] == 0
    assert out["f32_staging_bytes"] == 0
    assert set(out) >= {"flops", "bytes_accessed", "collective_bytes",
                        "dcn_bytes", "collective_by_op", "collective_count",
                        "f32_staging_bytes", "warnings", "n_computations"}


def test_dcn_attribution(fake_runs):
    pod, data = fake_runs["pod"], fake_runs["data"]
    assert pod["dcn_bytes"] == pod["collective_bytes"] == 4 * 64 * 4 > 0
    assert data["dcn_bytes"] == 0 and data["collective_bytes"] == 4 * 64 * 4
    assert not pod["warnings"] and not data["warnings"]


@pytest.mark.parametrize("dtype,size", [(torch.bfloat16, 2),
                                        (torch.float32, 4),
                                        (torch.int32, 4)])
def test_output_bytes_by_dtype(dtype, size):
    x = torch.ones(8, 64, dtype=torch.float64)
    out = analyze_step(lambda t: t.to(dtype), (x,))
    assert out["bytes_accessed"] == 8 * 64 * 8 + 8 * 64 * size
    assert out["peak_live_bytes"] == 8 * 64 * size


def test_tuple_outputs_and_flop_rules():
    x = torch.randn(8, 64)
    out = analyze_step(lambda t: torch.sort(t, -1), (x,))
    # values f32 + indices int64, and a sort counts operand bytes / 4
    assert out["bytes_accessed"] == 8 * 64 * 4 * 2 + 8 * 64 * 8
    assert out["flops"] == 8 * 64 * 4 / 4
    w = torch.randn(64, 32)
    out = analyze_step(lambda a, b: torch.tanh(a @ b), (x, w))
    assert out["flops"] == 2 * 8 * 32 * 64 + 8 * 32
    conv = torch.nn.functional.conv1d
    out = analyze_step(lambda a, k: conv(a, k, groups=2),
                       (torch.randn(1, 4, 16), torch.randn(6, 2, 3)))
    assert out["flops"] == 2 * (1 * 6 * 14) * 3 * 2
    out = analyze_step(lambda t: t.view(64, 8).t(), (x,))
    assert out["bytes_accessed"] == 0 and out["flops"] == 0


def test_counter_ignores_what_runs_outside_it():
    counter = StepCounter()
    with counter:
        torch.ones(4) + 1
    torch.ones(1000) * 2
    assert counter.costs()["flops"] == 4


# ------------------------------------------------ peak live bytes (P4)

def test_peak_live_bytes_follow_each_tensors_last_use():
    """a -> b -> c with ``a`` dead after ``b``: the peak is a + b, at the
    op that reads ``a`` last, though ``a`` stays bound until the step
    returns."""
    x = torch.ones(8, 64)

    def chain(t):
        a = t * 2                 # 8 * 64 * 4 bytes
        b = a.sum(0)              # 64 * 4
        c = b * 3                 # 64 * 4
        return c

    assert analyze_step(chain, (x,))["peak_live_bytes"] == \
        8 * 64 * 4 + 64 * 4


def test_peak_live_bytes_do_not_depend_on_when_python_collects():
    """A tensor kept alive by a reference cycle dies at its last use
    whether the cycle is collected in the step (a forced ``gc.collect()``)
    or never (the collector off)."""
    import gc

    def step(t, collect):
        a = t * 2
        holder = [a]
        holder.append(holder)     # a cycle: only the collector frees a
        del a
        b = holder[0].sum()
        del holder
        if collect:
            gc.collect()
        c = t * 3
        return b + c.sum()

    x = torch.ones(8, 64)
    gc.disable()
    try:
        lazy = analyze_step(lambda t: step(t, False), (x,))
    finally:
        gc.enable()
    forced = analyze_step(lambda t: step(t, True), (x,))
    assert lazy["peak_live_bytes"] == forced["peak_live_bytes"] == \
        4 + 8 * 64 * 4 + 4                   # b, c and c.sum()


def test_reduced_cell_peak_is_the_same_every_run(monkeypatch):
    """A reduced qwen3-8b prefill cell (meta tensors, as the dry run's
    abstract cells), analysed twice: once with the collector off, once
    with a ``gc.collect()`` forced inside every norm.  Same peak."""
    import functools
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.launch.shapes import ShapeSpec, input_specs
    from repro_torch.launch.steps import _prefill_fn, abstract_params
    from repro_torch.models import layers
    from repro_torch.models.config import reduced

    cfg = reduced(get_arch("qwen3-8b"), layers=3, d_model=64, vocab=512,
                  d_ff=128, heads=4)
    args = (abstract_params(cfg, torch.bfloat16),
            input_specs(cfg, ShapeSpec("p", "prefill", 64, 8)))
    fn = functools.partial(_prefill_fn, cfg=cfg, impl="auto",
                           schedule="dense")
    gc.disable()
    try:
        lazy = analyze_step(fn, args)
    finally:
        gc.enable()
    norm = layers.norm

    def collecting_norm(*a, **k):
        gc.collect()
        return norm(*a, **k)

    monkeypatch.setattr(layers, "norm", collecting_norm)
    forced = analyze_step(fn, args)
    assert forced["peak_live_bytes"] == lazy["peak_live_bytes"] > 0
    assert forced["flops"] == lazy["flops"]
