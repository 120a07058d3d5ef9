"""The port's GPipe schedule (``repro_torch.parallel.pipeline``) against a
sequential oracle on a CPU ``DeviceMesh``, and against the reference's
``pipeline_apply`` on 8 fake JAX devices (in a subprocess: the device
count is fixed when JAX starts).  Tolerance 1e-5, as the reference's
``tests/test_pipeline.py``."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel.pipeline import pipeline_apply, stack_stages
from repro_torch.parallel.sharding import DeviceMesh

ROOT = Path(__file__).resolve().parent.parent
L, D, B = 8, 16, 32           # the reference test's sizes


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(L, D, D)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(L, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    return w, b, x


def _layer(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


def _stage_fn(stage_params, a):
    for i in range(stage_params["w"].shape[0]):
        a = _layer({k: v[i] for k, v in stage_params.items()}, a)
    return a


def _mesh():
    return DeviceMesh([["cpu"] * 2] * 4, ("pod", "data"))


@pytest.mark.parametrize("microbatches", [8, None, 32])
def test_pipeline_matches_sequential(microbatches):
    w, b, x = _inputs()
    layers = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    want = _stage_fn(layers, torch.from_numpy(x))
    got = pipeline_apply(_stage_fn, stack_stages(layers, 4),
                         torch.from_numpy(x), _mesh(), axis="pod",
                         microbatches=microbatches)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_stage_layout_and_errors():
    w, b, x = _inputs()
    staged = stack_stages({"w": torch.from_numpy(w)}, 4)
    assert staged["w"].shape == (4, 2, D, D)
    assert torch.equal(staged["w"][1, 0], torch.from_numpy(w[2]))
    with pytest.raises(ValueError):
        stack_stages({"w": torch.from_numpy(w)}, 3)
    with pytest.raises(ValueError):
        pipeline_apply(_stage_fn, stack_stages(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, 4),
            torch.from_numpy(x), _mesh(), microbatches=5)
    with pytest.raises(ValueError):
        pipeline_apply(_stage_fn, staged, torch.from_numpy(x), _mesh(),
                       axis="model")


REF = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.pipeline import pipeline_apply, stack_stages

    w, b, x = (np.asarray(a, np.float32) for a in json.loads(sys.stdin.read()))
    mesh = jax.make_mesh((4, 2), ("pod", "data"))
    layers = {"w": jnp.asarray(w), "b": jnp.asarray(b)}

    def stage_fn(stage_params, a):
        def body(c, lp):
            return jnp.tanh(c @ lp["w"] + lp["b"]), None
        out, _ = jax.lax.scan(body, a, stage_params)
        return out

    got = pipeline_apply(stage_fn, stack_stages(layers, 4), jnp.asarray(x),
                         mesh, axis="pod", microbatches=8)
    print(json.dumps(np.asarray(got).tolist()))
""")


def test_pipeline_equals_the_reference_on_eight_fake_devices():
    w, b, x = _inputs()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", REF],
                          input=json.dumps([w.tolist(), b.tolist(),
                                            x.tolist()]),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.asarray(json.loads(proc.stdout.splitlines()[-1]), np.float32)
    layers = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = pipeline_apply(_stage_fn, stack_stages(layers, 4),
                         torch.from_numpy(x), _mesh(), axis="pod",
                         microbatches=8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
