"""The port's fault-tolerant loop (``repro_torch.runtime.train_loop``) and
training launcher (``python -m repro_torch.launch.train``) on the CPU.

The reference's ``tests/test_runtime.py`` fault checks run on the port's
loop; a reduced qwen3-8b run with two injected faults replays exactly
(losses and final parameters bit-equal to the clean run); the launcher's
fault and clean runs print equal loss lines, and its checkpoint directory
restores in the reference's ``CheckpointManager``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_arch as ref_get_arch
from repro.models.config import reduced as ref_reduced
from repro.models.params import init_params as ref_init_params
from repro.optim import adamw_init as ref_adamw_init

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FaultInjector, SimulatedFault, train_loop

ROOT = Path(__file__).resolve().parent.parent


def _toy_problem():
    """Deterministic quadratic: state is a vector, batch is data index."""
    target = torch.linspace(-1, 1, 8)

    def step(w, batch):
        x = torch.as_tensor(batch, dtype=torch.float32)
        loss = torch.mean((w - target) ** 2) + 0.0 * x.sum()
        g = 2 * (w - target) / w.numel()
        return w - 0.1 * g, {"loss": loss}

    def make_pipeline(start):
        def gen():
            k = start
            while True:
                yield np.full((2,), k)
                k += 1
        return gen()

    return step, make_pipeline


def _run(tmp_path, faults, steps=30):
    step, make_pipeline = _toy_problem()
    ckpt = CheckpointManager(tmp_path, async_save=False)
    w, hist = train_loop(step, torch.zeros(8), make_pipeline, ckpt,
                         total_steps=steps, ckpt_every=10,
                         injector=FaultInjector(faults), log_every=1)
    return w.numpy(), [h["loss"] for h in hist]


# -------------------------------- the reference's tests/test_runtime.py

def test_fault_recovery_exact_replay(tmp_path):
    w_clean, h_clean = _run(tmp_path / "clean", faults=[])
    w_fault, h_fault = _run(tmp_path / "fault", faults=[15, 25])
    np.testing.assert_array_equal(w_clean, w_fault)
    assert h_clean == h_fault


def test_fault_before_first_checkpoint_raises(tmp_path):
    with pytest.raises(RuntimeError):
        _run(tmp_path, faults=[3])


def test_too_many_faults_raises(tmp_path):
    step, make_pipeline = _toy_problem()
    ckpt = CheckpointManager(tmp_path, async_save=False)

    class Always(FaultInjector):
        def maybe_fail(self, step):
            if step == 15:
                raise SimulatedFault("again")

    with pytest.raises(RuntimeError):
        train_loop(step, torch.zeros(8), make_pipeline, ckpt,
                   total_steps=30, ckpt_every=10, injector=Always([]),
                   max_restarts=3)


def test_fault_steps_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_STEPS", "7, 13")
    inj = FaultInjector()
    assert inj.fail_at == {7, 13}
    with pytest.raises(SimulatedFault):
        inj.maybe_fail(7)
    inj.maybe_fail(7)                     # fires once per step


# ------------------------------------- a reduced model, replayed exactly

def _lm_run(tmp_path, faults):
    cfg = dataclasses.replace(reduced(get_arch("qwen3-8b")), remat="none")
    params = init_params(cfg, seed=0, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup=2, total_steps=10)
    step_raw = T.make_train_step(cfg, opt_cfg, impl="naive")

    def step_fn(state, batch):
        p, o, m = step_raw(*state, {"tokens": batch[0], "labels": batch[1]})
        return (p, o), m

    ckpt = CheckpointManager(tmp_path, keep_last_k=2)
    (params, _), hist = train_loop(
        step_fn, (params, adamw_init(params)),
        lambda s: TokenPipeline(0, 2, 16, cfg.vocab, start_step=s), ckpt,
        total_steps=10, ckpt_every=3, injector=FaultInjector(faults),
        log_every=1)
    return params, hist


def test_reduced_qwen3_training_replays_exactly_after_two_faults(tmp_path):
    clean_p, clean_h = _lm_run(tmp_path / "clean", [])
    fault_p, fault_h = _lm_run(tmp_path / "fault", [4, 8])
    assert [h["loss"] for h in clean_h] == [h["loss"] for h in fault_h]
    assert clean_h == fault_h and len(clean_h) == 10
    for (path, a), (_, b) in zip(tree_leaves(clean_p), tree_leaves(fault_p)):
        assert torch.equal(a, b), path
    assert clean_h[-1]["loss"] < clean_h[0]["loss"]


# --------------------------------------------------------- the launcher

LAUNCH = ["-m", "repro_torch.launch.train", "--arch", "qwen3-8b",
          "--scale", "reduced", "--steps", "20", "--batch", "4", "--seq",
          "16", "--ckpt-every", "5", "--d-model", "64", "--layers", "2"]


def _launch(args, **env):
    full_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable] + LAUNCH + args, env=full_env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))


def test_launcher_replays_faults_and_its_checkpoints_restore_in_the_reference(
        tmp_path):
    clean = _launch(["--device", "cpu", "--ckpt-dir", str(tmp_path / "c")])
    fault = _launch(["--device", "cpu", "--ckpt-dir", str(tmp_path / "f"),
                     "--fault-steps", "7,12"])
    assert clean.returncode == 0, clean.stderr[-3000:]
    assert fault.returncode == 0, fault.stderr[-3000:]
    lines = [ln for ln in clean.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and lines == [
        ln for ln in fault.stdout.splitlines() if ln.startswith("step")]
    assert clean.stdout.splitlines()[0].startswith(
        "arch=qwen3-8b family=dense params=")
    assert "done: 20 steps" in clean.stdout

    cfg = ref_reduced(ref_get_arch("qwen3-8b"), layers=2, d_model=64,
                      vocab=2048, d_ff=256, heads=4)
    rp = ref_init_params(cfg, seed=1)
    template = (rp, ref_adamw_init(rp))
    for run in ("c", "f"):
        ref = RefManager(tmp_path / run)
        assert ref.all_steps() == [15, 20]
        step, (params, opt), _ = ref.restore(template)
        assert step == 20 and int(opt["step"]) == 20
        assert jax.tree.structure(params) == jax.tree.structure(rp)
    _, (pc, _), _ = RefManager(tmp_path / "c").restore(template)
    _, (pf, _), _ = RefManager(tmp_path / "f").restore(template)
    for a, b in zip(jax.tree.leaves(pc), jax.tree.leaves(pf)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_launcher_without_a_gpu_asks_for_the_cpu(tmp_path):
    res = _launch(["--ckpt-dir", str(tmp_path)], CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "device='cpu'" in res.stderr
    assert not any(p.name.startswith("step_") for p in tmp_path.iterdir())
