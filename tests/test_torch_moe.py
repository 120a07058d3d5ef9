"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the CPU.

The six checks of ``tests/test_moe.py`` run on the port, and each piece
is held to the reference on the same numpy inputs and weights (carried
across with ``params_from_numpy``): router ids and dispatch indices
exactly, f32 values within ``rtol=1e-4, atol=1e-5``, bf16 compute within
``rtol=3e-2, atol=3e-2``.  Whenever nothing is dropped the two agree; at a
dropping capacity the port equals a per-token oracle and the reference
does not (``ROADMAP.md``, R5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch
from repro.models import moe as ref_moe
from repro.models.config import reduced
from repro.models.params import init_params

from repro_torch.models import config as port_config
from repro_torch.models import moe as moe_lib
from repro_torch.models.params import params_from_numpy

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


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


def _cfg(capacity_factor=16.0, dtype="float32", **moe_over):
    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor,
                                     **moe_over))


def _params(cfg):
    """One layer's MoE weights: (reference jax tree, port tensor tree)."""
    rp = jax.tree.map(lambda a: a[0], init_params(cfg, seed=0)["layers"]["moe"])
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np_(got), np_(want), **tol)


# ------------------------------------------- tests/test_moe.py on the port

def test_router_topk_distinct_and_normalized(rng):
    cfg = port_cfg(_cfg())
    _, p = _params(_cfg())
    x = torch.from_numpy(rng.normal(size=(32, cfg.d_model)).astype(np.float32))
    w, ids, probs = moe_lib.router_topk(x, p["router"], cfg)
    assert tuple(w.shape) == (32, cfg.moe.top_k)
    for row in ids.tolist():
        assert len(set(row)) == cfg.moe.top_k
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert tuple(probs.shape) == (32, cfg.moe.total_experts)


def test_padded_experts_never_selected(rng):
    ref = _cfg(num_experts=6, padded_experts=8)
    _, p = _params(ref)
    x = torch.from_numpy(rng.normal(size=(64, ref.d_model)).astype(np.float32))
    _, ids, probs = moe_lib.router_topk(x, p["router"], port_cfg(ref))
    assert int(ids.max()) < 6
    assert not bool(probs[:, 6:].any())


def _dense_expert_sum(x, p, cfg):
    """sum_k w_k * expert_k(x) + shared(x), one token at a time (f32)."""
    xt = x.reshape(-1, cfg.d_model)
    w, ids, _ = moe_lib.router_topk(xt, p["router"], cfg)
    keep = torch.ones_like(ids, dtype=torch.bool)
    return _per_token_oracle(xt, p, cfg, w, ids, keep)


def _per_token_oracle(xt, p, cfg, w, ids, keep):
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(ids.shape[1]):
            if keep[t, j]:
                e = int(ids[t, j])
                h = F.silu(xt[t] @ p["wg"][e]) * (xt[t] @ p["wi"][e])
                out[t] += w[t, j] * (h @ p["wo"][e])
    if cfg.moe.shared_experts:
        sh = F.silu(xt @ p["shared_wg"]) * (xt @ p["shared_wi"])
        out += sh @ p["shared_wo"]
    return out


def test_moe_mlp_matches_dense_expert_sum(rng):
    """With no drops, output == sum_k w_k * expert_k(x) computed densely."""
    cfg = port_cfg(_cfg(capacity_factor=64.0))
    _, p = _params(_cfg(capacity_factor=64.0))
    x = torch.from_numpy((rng.normal(size=(2, 8, cfg.d_model)) * 0.1)
                         .astype(np.float32))
    out = moe_lib.moe_mlp(x, p, cfg)
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(),
                               _dense_expert_sum(x, p, cfg).numpy(),
                               atol=2e-4)


def test_grouped_equals_global_when_capacity_ample(rng, monkeypatch):
    """G > 1 grouped dispatch == G = 1 when capacity admits every token."""
    cfg = port_cfg(_cfg(capacity_factor=64.0))
    _, p = _params(_cfg(capacity_factor=64.0))
    x = torch.from_numpy((rng.normal(size=(4, 8, cfg.d_model)) * 0.1)
                         .astype(np.float32))
    out_g1 = moe_lib.moe_mlp(x, p, cfg)
    monkeypatch.setattr(moe_lib, "_num_groups", lambda b, s: 4)
    out_g4 = moe_lib.moe_mlp(x, p, cfg)
    np.testing.assert_allclose(out_g1.numpy(), out_g4.numpy(), atol=1e-5)


def test_capacity_drop_is_graceful(rng):
    """Tiny capacity: output stays finite, and each token gets its kept
    assignments and the shared experts, uncorrupted by dropped ones."""
    cfg = port_cfg(_cfg(capacity_factor=0.1))
    _, p = _params(_cfg(capacity_factor=0.1))
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model))
                         .astype(np.float32))
    out = moe_lib.moe_mlp(x, p, cfg)
    assert bool(torch.isfinite(out).all())
    xt = x.reshape(-1, cfg.d_model)
    w, ids, _ = moe_lib.router_topk(xt, p["router"], cfg)
    keep = _kept(ids, moe_lib.capacity(xt.shape[0], cfg))
    assert not bool(keep.all())
    np.testing.assert_allclose(
        out.reshape(-1, cfg.d_model).numpy(),
        _per_token_oracle(xt, p, cfg, w, ids, keep).numpy(), atol=2e-4)


def test_aux_loss_balanced_is_one():
    cfg = port_cfg(_cfg())
    e = cfg.moe.total_experts
    t = 4 * e
    probs = torch.full((t, e), 1.0 / e)
    ids = torch.from_numpy(np.arange(t * cfg.moe.top_k) % e).reshape(
        t, cfg.moe.top_k)
    assert abs(float(moe_lib.aux_loss(probs, ids, cfg)) - 1.0) < 1e-4


# ------------------------------------------------ against the reference

def test_router_topk_matches_the_reference_with_ties(rng):
    """ids exactly equal (ties to the lower index, as the reference's
    stable sort), weights and probs at f32; also with padded experts."""
    for over in ({}, dict(num_experts=6, padded_experts=8)):
        ref = _cfg(**over)
        rp, p = _params(ref)
        wr = np.asarray(rp["router"]).copy()
        wr[:, 3] = wr[:, 1]                  # experts 1 and 3 tie exactly
        wr[:, 5] = wr[:, 2]                  # and 2 and 5
        x = rng.normal(size=(48, ref.d_model)).astype(np.float32)
        x[:8] = 0.0                          # all-equal rows: every expert ties
        want = ref_moe.router_topk(jnp.asarray(x), jnp.asarray(wr), ref)
        got = moe_lib.router_topk(torch.from_numpy(x), torch.from_numpy(wr),
                                  port_cfg(ref))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        close(got[0], want[0], F32)
        close(got[2], want[2], F32)
        assert got[1][:8].tolist() == [[0, 1]] * 8


def test_capacity_equals_the_reference():
    for cf in (0.1, 1.0, 1.25, 2.0, 16.0):
        for pad in (0, 16):
            ref = _cfg(capacity_factor=cf, padded_experts=pad)
            for tokens in (1, 7, 8, 16, 33, 128, 500, 4096):
                assert moe_lib.capacity(tokens, port_cfg(ref)) == \
                    ref_moe.capacity(tokens, ref)


def _ids(rng, tg, k, e):
    """(tg, k) distinct experts per token, as the router gives them."""
    return np.stack([rng.permutation(e)[:k] for _ in range(tg)]).astype(
        np.int32)


@pytest.mark.parametrize("tg,k,e", [(16, 2, 8), (33, 4, 16), (5, 1, 4)])
def test_dispatch_and_combine_match_the_reference(rng, tg, k, e):
    """Drop-free capacity: slot, keep and inv integer-equal, the expert
    buffer and the combined rows equal the reference's."""
    d = 12
    cap = -(-tg // 8) * 8
    x = rng.normal(size=(tg, d)).astype(np.float32)
    ids = _ids(rng, tg, k, e)
    want = ref_moe._dispatch_group(jnp.asarray(x), jnp.asarray(ids), e, cap,
                                   jnp.float32)
    got = moe_lib._dispatch_group(torch.from_numpy(x),
                                  torch.from_numpy(ids).long(), e, cap,
                                  torch.float32)
    assert bool(got[2].all())
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    ex_out = rng.normal(size=(e * cap, d)).astype(np.float32)
    close(moe_lib._combine_group(torch.from_numpy(ex_out), *got[1:], tg, k),
          ref_moe._combine_group(jnp.asarray(ex_out), *want[1:], tg, k),
          dict(rtol=0, atol=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_the_reference(rng, dtype):
    """Drop-free capacity: the whole layer at f32 and in bf16 compute."""
    ref = _cfg(capacity_factor=16.0, dtype=dtype)
    rp, p = _params(ref)
    x = (rng.normal(size=(2, 12, ref.d_model)) * 0.5).astype(np.float32)
    jx = jnp.asarray(x, ref.compute_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = moe_lib.moe_mlp(tx, p, port_cfg(ref))
    assert got.dtype == tx.dtype
    close(got, ref_moe.moe_mlp(jx, rp, ref),
          F32 if dtype == "float32" else BF16)


def test_aux_loss_matches_the_reference(rng):
    ref = _cfg()
    probs = rng.dirichlet(np.ones(8), size=20).astype(np.float32)
    ids = _ids(rng, 20, 2, 8)
    close(moe_lib.aux_loss(torch.from_numpy(probs),
                           torch.from_numpy(ids).long(), port_cfg(ref)),
          ref_moe.aux_loss(jnp.asarray(probs), jnp.asarray(ids), ref), F32)


# ------------------------------------------------------------------- R5

def _kept(ids, cap):
    """Per expert, the first ``cap`` assignments in token-major order."""
    seen, keep = {}, torch.zeros_like(ids, dtype=torch.bool)
    for t in range(ids.shape[0]):
        for j in range(ids.shape[1]):
            e = int(ids[t, j])
            keep[t, j] = seen.get(e, 0) < cap
            seen[e] = seen.get(e, 0) + 1
    return keep


def test_r5_a_dropped_assignment_leaves_kept_slots_alone():
    """Tg = 16, k = 1, E = 4, cap = 8: token 0 goes to expert 2, tokens
    1-15 to expert 3, so seven of expert 3's assignments drop.  The
    reference writes them to row Tg*k = 16, which is expert 2's slot 0,
    and token 0's row is overwritten; the port's expert-2 slot 0 holds
    token 0's row."""
    tg, e, cap, d = 16, 4, 8, 4
    x = np.repeat(np.arange(1, tg + 1, dtype=np.float32)[:, None], d, 1)
    ids = np.array([[2]] + [[3]] * (tg - 1), np.int32)
    want = ref_moe._dispatch_group(jnp.asarray(x), jnp.asarray(ids), e, cap,
                                   jnp.float32)
    got = moe_lib._dispatch_group(torch.from_numpy(x),
                                  torch.from_numpy(ids).long(), e, cap,
                                  torch.float32)
    assert got[0][2, 0].tolist() == [1.0] * d
    assert np.asarray(want[0])[2, 0].tolist() != [1.0] * d
    assert int((~got[2]).sum()) == 7
    assert got[1][~got[2]].tolist() == [e * cap] * 7       # the spare row
    # every kept slot holds its own token's row
    ex = got[0].reshape(e * cap, d)
    tok = torch.arange(tg).repeat_interleave(1)[torch.argsort(
        torch.from_numpy(ids).long().reshape(-1), stable=True)]
    for s, kp, t in zip(got[1].tolist(), got[2].tolist(), tok.tolist()):
        if kp:
            assert ex[s].tolist() == [float(t + 1)] * d


def test_r5_moe_mlp_at_a_dropping_capacity_equals_the_per_token_oracle(rng):
    """T = 16, k = 2, E = 8, cap = 8 with a constructed router: token 0
    goes to experts 4 and 0, tokens 1-15 to experts 7 and 6, so 14
    assignments drop.  The port's output is every token's kept
    assignments plus the shared experts; the reference's dropped rows land
    in expert 4's slot 0 (row Tg*k = 32) and corrupt token 0's output."""
    ref = _cfg(capacity_factor=0.1)
    rp, p = _params(ref)
    cfg = port_cfg(ref)
    d, e = ref.d_model, ref.moe.total_experts
    wr = np.zeros((d, e), np.float32)
    wr[np.arange(e), np.arange(e)] = 1.0
    x = (rng.normal(size=(2, 8, d)) * 0.1).astype(np.float32)
    xt = x.reshape(16, d)                    # a view: logits = x[:, :E]
    xt[:, :e] = 0.0
    xt[0, [4, 0]] = [6.0, 5.0]
    xt[1:, 7], xt[1:, 6] = 6.0, 5.0
    rp = dict(rp, router=jnp.asarray(wr))
    p = dict(p, router=torch.from_numpy(wr))
    assert moe_lib.capacity(16, cfg) == 8
    tx = torch.from_numpy(x)
    got = moe_lib.moe_mlp(tx, p, cfg).reshape(16, d)
    w, ids, _ = moe_lib.router_topk(tx.reshape(16, d), p["router"], cfg)
    assert ids[0].tolist() == [4, 0] and ids[1].tolist() == [7, 6]
    keep = _kept(ids, 8)
    assert int((~keep).sum()) == 14
    oracle = _per_token_oracle(tx.reshape(16, d), p, cfg, w, ids, keep)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=2e-4)
    want = np.asarray(ref_moe.moe_mlp(jnp.asarray(x), rp, ref)).reshape(16, d)
    assert not np.allclose(want[0], oracle[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(want[1:], oracle[1:].numpy(), atol=2e-4)
