"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim`` on the CPU.

Inputs are made with numpy from a seed.  Tolerances: the schedule and
every AdamW quantity within 1e-6 (absolute, f32 values of order 1); the
int8 codes equal and the scales and residuals within 1e-7.  The
reference's ``tests/test_compress.py`` checks run on the port unchanged in
substance.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro.optim import schedule as ref_schedule

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_int8, cosine_schedule,
                               decompress_int8, error_feedback_update,
                               global_norm, psum_compressed)
from repro_torch.models.params import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=0, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _tree(rng, scale=1.0):
    return {"embed": (rng.normal(size=(16, 8)) * scale).astype(np.float32),
            "layers": {"w": (rng.normal(size=(3, 8, 8)) * scale)
                       .astype(np.float32),
                       "b": (rng.normal(size=(3, 8)) * scale)
                       .astype(np.float32)},
            "final_norm": {"scale": np.ones(8, np.float32)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("warmup,total,min_frac", [(3, 12, 0.1), (0, 7, 0.0),
                                                   (5, 5, 0.25)])
def test_cosine_schedule_equals_the_reference_at_every_step(warmup, total,
                                                            min_frac):
    ref = ref_schedule.cosine_schedule(warmup, total, min_frac)
    port = cosine_schedule(warmup, total, min_frac)
    for step in range(total + 3):
        want = float(ref(jnp.int32(step)))
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_adamw_equals_the_reference_over_several_steps(grad_scale):
    """Five steps from the same params, grads and state; at
    ``grad_scale=10`` the grad norm (about 250) is far above
    ``clip_norm``, so every step clips.  Largest difference seen: 6e-8."""
    rng = np.random.default_rng(0)
    cfg = AdamWConfig(lr=1e-2, warmup=2, total_steps=6)
    params = _tree(rng)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = ref_adamw.adamw_init(ref_p)
    port_p = _torch_tree(params)
    port_s = adamw_init(port_p)
    ref_sched = ref_schedule.cosine_schedule(cfg.warmup, cfg.total_steps,
                                             cfg.min_lr_frac)
    port_sched = cosine_schedule(cfg.warmup, cfg.total_steps,
                                 cfg.min_lr_frac)
    for _ in range(5):
        grads = _tree(rng, grad_scale)
        ref_p, ref_s, ref_m = ref_adamw.adamw_update(
            ref_p, jax.tree.map(jnp.asarray, grads), ref_s,
            ref_adamw.AdamWConfig(**vars(cfg)), ref_sched)
        port_p, port_s, port_m = adamw_update(port_p, _torch_tree(grads),
                                              port_s, cfg, port_sched)
        if grad_scale > 1:
            assert float(port_m["grad_norm"]) > cfg.clip_norm
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(port_m[k]), float(ref_m[k]),
                                       rtol=1e-6)
        assert int(port_s["step"]) == int(ref_s["step"])
        assert port_s["step"].dtype == torch.int32
        for tree_r, tree_p in ((ref_p, port_p), (ref_s["m"], port_s["m"]),
                               (ref_s["v"], port_s["v"])):
            want = dict(tree_leaves(jax.tree.map(np.asarray, tree_r)))
            for path, got in tree_leaves(tree_p):
                np.testing.assert_allclose(_np(got), want[path], **TOL)


def test_adamw_updates_in_place_and_global_norm_matches():
    rng = np.random.default_rng(1)
    params = _torch_tree(_tree(rng))
    ptrs = [t.data_ptr() for _, t in tree_leaves(params)]
    state = adamw_init(params)
    grads = _torch_tree(_tree(rng))
    new_p, new_s, _ = adamw_update(params, grads, state, AdamWConfig())
    assert [t.data_ptr() for _, t in tree_leaves(new_p)] == ptrs
    assert new_s["m"] is state["m"]
    want = float(ref_adamw.global_norm(
        jax.tree.map(jnp.asarray, _tree(np.random.default_rng(1)))))
    got = float(global_norm(_torch_tree(_tree(np.random.default_rng(1)))))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_compress_and_error_feedback_equal_the_reference():
    rng = np.random.default_rng(2)
    for scale in (3.0, 1e-3, 0.0):
        x = (rng.normal(size=(33, 17)) * scale).astype(np.float32)
        r = (rng.normal(size=(33, 17)) * scale * 0.01).astype(np.float32)
        q, s = compress_int8(torch.from_numpy(x))
        qr, sr = ref_compress.compress_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(_np(q), np.asarray(qr))
        np.testing.assert_allclose(float(s), float(sr), rtol=1e-7)
        np.testing.assert_allclose(_np(decompress_int8(q, s)),
                                   np.asarray(ref_compress.decompress_int8(
                                       qr, sr)), rtol=1e-7, atol=0)
        q, s, nr = error_feedback_update(torch.from_numpy(x),
                                         torch.from_numpy(r))
        qr, sr, nrr = ref_compress.error_feedback_update(jnp.asarray(x),
                                                         jnp.asarray(r))
        np.testing.assert_array_equal(_np(q), np.asarray(qr))
        np.testing.assert_allclose(_np(nr), np.asarray(nrr), atol=1e-7,
                                   rtol=0)


# --------------------------------- the reference's tests/test_compress.py

def test_roundtrip_bounded_error(rng):
    x = torch.from_numpy(np.asarray(rng.normal(size=(64, 64)) * 3.0,
                                    np.float32))
    q, scale = compress_int8(x)
    err = torch.abs(decompress_int8(q, scale) - x)
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_converges(rng):
    """Residual carry: the long-run mean of decompressed grads equals the
    true gradient (unbiasedness of error feedback)."""
    g = torch.from_numpy(np.asarray(rng.normal(size=(32,)) * 1e-3,
                                    np.float32))
    r = torch.zeros_like(g)
    acc = np.zeros((32,), np.float64)
    n = 50
    for _ in range(n):
        q, s, r = error_feedback_update(g, r)
        acc += _np(decompress_int8(q, s)).astype(np.float64)
    np.testing.assert_allclose(acc / n, _np(g), atol=float(s) / n + 1e-7)


def _shards(seed, n):
    rng = np.random.default_rng(seed)
    grads = [{"g": (rng.normal(size=(16,)) * (i + 1)).astype(np.float32),
              "h": {"w": rng.normal(size=(3, 4)).astype(np.float32)}}
             for i in range(n)]
    res = [{"g": (rng.normal(size=(16,)) * 0.01).astype(np.float32),
            "h": {"w": (rng.normal(size=(3, 4)) * 0.01).astype(np.float32)}}
           for i in range(n)]
    return grads, res


def test_psum_compressed_multidevice():
    """The reference test's property on the port: the int8 mean across 4
    shards is within max|g| / 127 of the true mean, and every shard
    decodes the identical reduced gradient."""
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(4, 16)).astype(np.float32)
    out, new_r = psum_compressed(
        [{"g": torch.from_numpy(g)} for g in grads],
        [{"g": torch.zeros(16)} for _ in range(4)])
    want = np.mean(grads, axis=0)
    got = _np(out[0]["g"])
    tol = float(np.abs(grads).max()) / 127 + 1e-6
    np.testing.assert_allclose(got, want, atol=tol)
    for i in range(1, 4):
        np.testing.assert_array_equal(_np(out[i]["g"]), got)
    assert len(new_r) == 4


PSUM_REF = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.optim.compress import psum_compressed
    from repro.parallel.ops import shard_map

    grads, res = json.loads(sys.stdin.read())
    n = len(grads)
    mesh = jax.make_mesh((n,), ("pod",))

    def stack(trees, key):
        return jnp.asarray(np.stack([np.asarray(t[key], np.float32)
                                     for t in trees]))

    g = {"g": stack(grads, "g"),
         "h": {"w": stack([t["h"] for t in grads], "w")}}
    r = {"g": stack(res, "g"), "h": {"w": stack([t["h"] for t in res], "w")}}

    def f(g_s, r_s):
        out, new_r = psum_compressed(jax.tree.map(lambda a: a[0], g_s),
                                     jax.tree.map(lambda a: a[0], r_s),
                                     "pod")
        return (jax.tree.map(lambda a: a[None], out),
                jax.tree.map(lambda a: a[None], new_r))

    spec = jax.tree.map(lambda _: P("pod"), g)
    out, new_r = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                   out_specs=(spec, spec), check=False))(g, r)
    print(json.dumps({"out": jax.tree.map(lambda a: np.asarray(a).tolist(),
                                          out),
                      "res": jax.tree.map(lambda a: np.asarray(a).tolist(),
                                          new_r)}))
""")


def test_psum_compressed_equals_the_reference_shard_map():
    """8 shards: the port's lists against the reference's ``shard_map``
    over 8 fake JAX devices in a subprocess (the device count is fixed
    when JAX starts).  Reduced gradients within 1e-6; residuals, which
    are ``g + r - q * scale`` with ``|g|`` up to 24 and which XLA computes
    with a fused multiply-add, within two f32 ulps of the largest ``|g|``
    (3.8e-6; largest difference seen 1.03e-6)."""
    grads, res = _shards(3, 8)
    payload = json.dumps([jax.tree.map(lambda a: a.tolist(), grads),
                          jax.tree.map(lambda a: a.tolist(), res)])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", PSUM_REF], input=payload,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.splitlines()[-1])
    out, new_r = psum_compressed(
        [_torch_tree(t) for t in grads], [_torch_tree(t) for t in res])
    gmax = max(float(np.abs(a).max()) for t in grads
               for _, a in tree_leaves(t))
    tol = {"out": 1e-6, "res": 2 * float(np.spacing(np.float32(gmax)))}
    for i in range(8):
        for key, got, want in (("out", out[i], ref["out"]),
                               ("res", new_r[i], ref["res"])):
            want_i = dict(tree_leaves(jax.tree.map(
                lambda a: np.asarray(a, np.float32)[i], want,
                is_leaf=lambda a: isinstance(a, list)
                and not isinstance(a[0], dict))))
            for path, t in tree_leaves(got):
                np.testing.assert_allclose(_np(t), want_i[path], rtol=0,
                                           atol=tol[key], err_msg=key)
