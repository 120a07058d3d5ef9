"""The port's flash attention backward (``repro_torch.models.flash``)
against the reference's custom VJP on the CPU.

``dq`` / ``dk`` / ``dv`` are held within 2e-5 (absolute; inputs and
cotangents of order 1, f32) of the reference's ``jax.vjp`` through
``flash_attention`` and of autograd through the naive attention, for both
schedules, GQA, a sliding window, ``kv_valid`` and a query offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as ref_flash

from repro_torch.models import flash as port_flash


# -------------------------------------------------------- flash backward

FLASH_CASES = {
    # name: (S, T, Hq, Hk, causal, window, kv_valid, q_offset)
    "causal": (128, 128, 4, 4, True, 0, 10 ** 9, 0),
    "gqa": (128, 128, 4, 2, True, 0, 10 ** 9, 0),
    "window": (128, 128, 4, 2, True, 40, 10 ** 9, 0),
    "kv_valid": (64, 128, 4, 1, False, 0, 100, 0),
    "offset": (64, 128, 2, 1, True, 0, 10 ** 9, 64),
}


@pytest.mark.parametrize("schedule", ["dense", "tri"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_grads_equal_the_reference_vjp_and_naive_autograd(case,
                                                                schedule):
    s, t, hq, hk, causal, window, kv_valid, q_offset = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(2, s, hq, 16)).astype(np.float32)
    k = rng.normal(size=(2, t, hk, 16)).astype(np.float32)
    v = rng.normal(size=(2, t, hk, 16)).astype(np.float32)
    do = rng.normal(size=(2, s, hq, 16)).astype(np.float32)

    # the reference's "tri" ignores q_offset (ROADMAP.md, R4): hold the
    # port's offset "tri" to the reference's "dense"
    ref_sched = "dense" if q_offset else schedule
    out_r, vjp = jax.vjp(
        lambda a, b, c: ref_flash.flash_attention(
            a, b, c, causal, ref_sched, 32, 32, window, kv_valid, q_offset),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port_flash.flash_attention(qt, kt, vt, causal, schedule, 32, 32,
                                     window, kv_valid, q_offset)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    naive = torch.autograd.grad(
        port_flash.reference_attention(qt, kt, vt, causal, window,
                                       kv_valid, q_offset),
        (qt, kt, vt), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_r),
                               atol=2e-5, rtol=0)
    for name, g, w, n in zip("qkv", got, want, naive):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0, err_msg="d" + name)
        np.testing.assert_allclose(g.numpy(), n.numpy(), atol=2e-5, rtol=0,
                                   err_msg="d" + name + " naive")


def test_flash_without_grad_keeps_its_forward():
    """The serving path (no grad) gives the same output as with grad."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 64, 2, 8)).astype(
        np.float32)) for _ in range(3))
    with torch.no_grad():
        a = port_flash.flash_attention(q, k, v, True, "tri", 16, 16)
    b = port_flash.flash_attention(q.requires_grad_(), k, v, True, "tri",
                                   16, 16)
    assert torch.equal(a, b.detach()) and b.requires_grad
