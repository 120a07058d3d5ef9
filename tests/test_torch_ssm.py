"""The port's state-space mixers (``repro_torch.models.ssm``: Mamba2's
SSD and RWKV6's WKV6, chunked and recurrent) against the reference's
``repro.models.ssm`` on the CPU.

Inputs are made with numpy from a seed; weights are the reference's,
carried across with ``params_from_numpy``.  Sequence lengths are chosen so
that S is not a multiple of ``chunk`` (the zero padding must leave the
final state unchanged) and spans more than one chunk.  Outputs and final
states are held to the reference within ``rtol=1e-4, atol=1e-5`` (f32),
and the chunked form to the port's own recurrent decode, step by step,
within ``rtol=1e-4, atol=1e-4``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import ssm as ref_ssm
from repro.models.config import reduced
from repro.models.params import init_params

from repro_torch.models import config as port_config
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.params import params_from_numpy

F32 = dict(rtol=1e-4, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-4)


def port_cfg(cfg):
    """The reference config as the port's dataclass, field for field."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(port_config, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(v)})
        return v
    return port_config.ArchConfig(**{f.name: conv(getattr(cfg, f.name))
                                     for f in dataclasses.fields(cfg)})


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def close(got, want, tol=F32):
    np.testing.assert_allclose(np_(got), np_(want), **tol)


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced(get_arch(arch)), remat="none",
                               compute_dtype=dtype)


def _layer(cfg, key):
    """Layer 0's mixer weights: (reference jax tree, port tensor tree)."""
    rp = jax.tree.map(lambda a: a[0], init_params(cfg, seed=3)["layers"][key])
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def _n(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------- chunk scans

@pytest.mark.parametrize("s,chunk", [(13, 8), (16, 8), (5, 16), (37, 16)])
def test_ssd_chunk_scan_matches_the_reference(s, chunk):
    """Outputs and final state at f32; 2 groups over 4 heads."""
    rng = np.random.default_rng(s)
    b, h, p, g, n = 2, 4, 8, 2, 6
    xh, bb, cc = _n(rng, b, s, h, p), _n(rng, b, s, g, n), _n(rng, b, s, g, n)
    dt = np.abs(_n(rng, b, s, h, scale=0.3))
    a_log = -np.abs(_n(rng, h)) - 0.1
    d_skip = _n(rng, h)
    args = (xh, dt, a_log, bb, cc, d_skip)
    want = ref_ssm._ssd_chunk_scan(*map(jnp.asarray, args), chunk)
    got = ssm_lib._ssd_chunk_scan(*map(torch.from_numpy, args), chunk)
    assert tuple(got[0].shape) == (b, s, h, p)
    close(got[0], want[0])
    close(got[1], want[1])
    # zero padding leaves the state alone: one more chunk of padding agrees
    longer = ssm_lib._ssd_chunk_scan(
        *[torch.from_numpy(np.concatenate(
            [a, np.zeros((b, chunk) + a.shape[2:], np.float32)], 1))
          if a.ndim > 1 else torch.from_numpy(a) for a in args], chunk)
    close(longer[1], got[1], dict(rtol=0, atol=0))


@pytest.mark.parametrize("s,chunk", [(13, 8), (16, 8), (5, 16), (37, 16)])
def test_wkv6_chunk_scan_matches_the_reference(s, chunk):
    rng = np.random.default_rng(s + 100)
    b, h, hd = 2, 3, 8
    r, k, v = (_n(rng, b, s, h, hd) for _ in range(3))
    w_log = -np.exp(_n(rng, b, s, h, hd, scale=0.5) - 1.0)
    u = _n(rng, h, hd)
    want = ref_ssm._wkv6_chunk_scan(*map(jnp.asarray, (r, k, v, w_log, u)),
                                    chunk)
    got = ssm_lib._wkv6_chunk_scan(*map(torch.from_numpy,
                                        (r, k, v, w_log, u)), chunk)
    assert tuple(got[0].shape) == (b, s, h, hd)
    close(got[0], want[0])
    close(got[1], want[1])


# ------------------------------------------------------------------ Mamba2

@pytest.mark.parametrize("s", [11, 20])
def test_mamba2_train_and_decode_match_the_reference(s):
    """``mamba2_train`` with its state, then ``mamba2_decode`` from that
    state and from a zero state (``mamba2_init_state``), at f32."""
    cfg = _cfg("zamba2-7b")
    pc = port_cfg(cfg)
    rp, pp = _layer(cfg, "mamba")
    rng = np.random.default_rng(s)
    x = _n(rng, 2, s + 1, cfg.d_model)
    want, wst = ref_ssm.mamba2_train(jnp.asarray(x[:, :s]), rp, cfg,
                                     return_state=True)
    got, gst = ssm_lib.mamba2_train(torch.from_numpy(x[:, :s]), pp, pc,
                                    return_state=True)
    close(got, want)
    assert gst.keys() == wst.keys()
    for key in wst:
        close(gst[key], wst[key])
    close(ssm_lib.mamba2_train(torch.from_numpy(x[:, :s]), pp, pc), want)
    zero = ssm_lib.mamba2_init_state(pc, 2)
    rzero = ref_ssm.mamba2_init_state(cfg, 2)
    assert {k: tuple(v.shape) for k, v in zero.items()} == \
        {k: v.shape for k, v in rzero.items()}
    for (gs, ws) in ((gst, wst), (zero, rzero)):
        wo, wnext = ref_ssm.mamba2_decode(jnp.asarray(x[:, s:]), rp, cfg, ws)
        go, gnext = ssm_lib.mamba2_decode(torch.from_numpy(x[:, s:]), pp, pc,
                                          gs)
        close(go, wo)
        for key in wnext:
            close(gnext[key], wnext[key])


def test_mamba2_chunked_equals_recurrent_step_by_step():
    """The chunked prefill over S tokens (S spans two chunks and a pad)
    equals the port's own recurrent decode run from a zero state one
    token at a time: every output row and the final states."""
    cfg = _cfg("zamba2-7b")
    pc = port_cfg(cfg)
    _, pp = _layer(cfg, "mamba")
    s = 2 * cfg.ssm.chunk + 5
    x = torch.from_numpy(_n(np.random.default_rng(4), 2, s, cfg.d_model))
    full, fst = ssm_lib.mamba2_train(x, pp, pc, return_state=True)
    st = ssm_lib.mamba2_init_state(pc, 2)
    for t in range(s):
        out, st = ssm_lib.mamba2_decode(x[:, t:t + 1], pp, pc, st)
        close(out, full[:, t:t + 1], STEP)
    close(st["ssd"], fst["ssd"], STEP)
    close(st["conv"], fst["conv"], dict(rtol=0, atol=0))


# ------------------------------------------------------------------- RWKV6

@pytest.mark.parametrize("s", [11, 20])
def test_rwkv6_time_and_channel_mix_match_the_reference(s):
    """Prefill form (no state), then one decode step with the carried
    state and token shift, and one from a fresh random state, at f32."""
    cfg = _cfg("rwkv6-3b")
    pc = port_cfg(cfg)
    rp, pp = _layer(cfg, "rwkv")
    rng = np.random.default_rng(s)
    x = _n(rng, 2, s + 1, cfg.d_model)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = ref_ssm.rwkv6_time_mix(jx[:, :s], rp, cfg)
    got = ssm_lib.rwkv6_time_mix(tx[:, :s], pp, pc)
    for g, w in zip(got, want):
        close(g, w)
    cw = ref_ssm.rwkv6_channel_mix(jx[:, :s], rp, cfg)
    cg = ssm_lib.rwkv6_channel_mix(tx[:, :s], pp, pc)
    for g, w in zip(cg, cw):
        close(g, w)
    dims = ssm_lib.rwkv6_dims(pc)
    fresh = _n(rng, 2, dims["n_heads"], dims["head_dim"], dims["head_dim"],
               scale=0.1)
    prev = _n(rng, 2, cfg.d_model)
    for (state, px) in (((want[1], want[2]), (got[1], got[2])),
                        ((jnp.asarray(fresh), jnp.asarray(prev)),
                         (torch.from_numpy(fresh), torch.from_numpy(prev)))):
        wd = ref_ssm.rwkv6_time_mix(jx[:, s:], rp, cfg, prev_x=state[1],
                                    state=state[0])
        gd = ssm_lib.rwkv6_time_mix(tx[:, s:], pp, pc, prev_x=px[1],
                                    state=px[0])
        for g, w in zip(gd, wd):
            close(g, w)
        close(ssm_lib.rwkv6_channel_mix(tx[:, s:], pp, pc, prev_x=px[1])[0],
              ref_ssm.rwkv6_channel_mix(jx[:, s:], rp, cfg,
                                        prev_x=state[1])[0])


def test_rwkv6_chunked_equals_recurrent_step_by_step():
    """The chunked time-mix over S tokens equals the recurrent form run
    one token at a time from a zero state: outputs, final WKV state and
    the token-shift carry."""
    cfg = _cfg("rwkv6-3b")
    pc = port_cfg(cfg)
    _, pp = _layer(cfg, "rwkv")
    s = 2 * cfg.ssm.chunk + 5
    x = torch.from_numpy(_n(np.random.default_rng(5), 2, s, cfg.d_model))
    full, fst, fx = ssm_lib.rwkv6_time_mix(x, pp, pc)
    dims = ssm_lib.rwkv6_dims(pc)
    st = torch.zeros((2, dims["n_heads"], dims["head_dim"],
                      dims["head_dim"]))
    px = torch.zeros((2, cfg.d_model))
    for t in range(s):
        out, st, px = ssm_lib.rwkv6_time_mix(x[:, t:t + 1], pp, pc,
                                             prev_x=px, state=st)
        close(out, full[:, t:t + 1], STEP)
    close(st, fst, STEP)
    close(px, fx, dict(rtol=0, atol=0))


@pytest.mark.parametrize("s", [13, 32])
def test_rwkv6_time_mix_gradients_match_the_reference(s):
    """The chunked WKV6 scan backpropagates: the gradients of a weighted
    sum of the time-mix output with respect to its input and to every
    mixer weight equal the reference's ``jax.grad`` at f32 (within 1e-5
    of each leaf's largest gradient), across a padded last chunk (13) and
    two full chunks (32, chunk 16)."""
    cfg = _cfg("rwkv6-3b")
    pc = port_cfg(cfg)
    rp, pp = _layer(cfg, "rwkv")
    rng = np.random.default_rng(s + 100)
    x = _n(rng, 2, s, cfg.d_model)
    wgt = _n(rng, 2, s, cfg.d_model)

    def ref_loss(p, xx):
        return jnp.sum(ref_ssm.rwkv6_time_mix(xx, p, cfg)[0] * wgt)
    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    names = sorted(pp)
    for name in names:
        pp[name].requires_grad_(True)
    out = ssm_lib.rwkv6_time_mix(tx, pp, pc)[0]
    grads = torch.autograd.grad((out * torch.from_numpy(wgt)).sum(),
                                [tx] + [pp[n] for n in names],
                                allow_unused=True)
    for name, g, w in zip(["x"] + names, grads,
                          [want_x] + [want_p[n] for n in names]):
        w = np.asarray(w)
        if g is None:           # channel-mix weights: no path from here
            assert not np.any(w), name
            continue
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(np_(g), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
