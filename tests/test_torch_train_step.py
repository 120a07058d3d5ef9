"""The port's ``make_train_step`` on the CPU: the reference's
``tests/test_archs.py`` train-step checks on the port, gradient
accumulation against one big batch and against the reference's
``accum=2``, activation checkpointing (``remat="full"``), and the
training graph's one ``UnbindBackward`` per stacked leaf.

Tolerances: the reference test's (loss within ``rtol=2e-4``, the first
leaf within ``atol=2e-4``) for accumulation on the port; against the
reference's ``accum=2`` the loss within 1e-5, the first moments (linear
in the gradient) within 1e-5 of each leaf's largest, and the parameters
within 1e-6 where the gradient is not near 0 (AdamW's first step moves
each parameter by about ``lr * sign(g)``, so a gradient within float
noise of 0 may move either way: those are counted, at most 0.1%).
``remat="full"`` gives bit-equal gradients.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_arch
from repro.models import params as ref_params
from repro.models import transformer as RT
from repro.models.config import reduced
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init

from repro_torch.models import config as port_config
from repro_torch.models import transformer as PT
from repro_torch.models.params import (init_params, params_from_numpy,
                                       tree_leaves, tree_map)
from repro_torch.optim import AdamWConfig, adamw_init

ARCH_IDS = sorted(ARCHS)


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


def _smoke_cfg(name):
    """``tests/test_archs.py``'s reduced config: 3 layers for windowed
    archs, f32 compute, no remat."""
    base = get_arch(name)
    cfg = reduced(base, layers=3 if base.window_pattern else 2)
    return dataclasses.replace(cfg, remat="none", compute_dtype="float32")


def _batch_for(cfg, b, s, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.vlm is not None:
        batch["patches"] = (rng.normal(size=(b, cfg.vlm.num_patches,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = (rng.normal(size=(b, cfg.encdec.enc_seq,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)
    return batch


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# ------------------------- the reference's tests/test_archs.py train steps

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    cfg = port_cfg(_smoke_cfg(arch))
    params = init_params(cfg, seed=0, device="cpu")
    before = _clone(params)
    opt = adamw_init(params)
    step = PT.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup=1,
                                               total_steps=10),
                              accum=1, impl="naive")
    batch = _batch_for(cfg, 2, 16, np.random.default_rng(0))
    params2, opt2, metrics = step(params, opt, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    # params actually moved
    delta = sum(float((a - b).abs().sum()) for (_, a), (_, b) in
                zip(tree_leaves(params2), tree_leaves(before)))
    assert delta > 0
    assert all(torch.isfinite(t).all() for _, t in tree_leaves(params2))
    assert int(opt2["step"]) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_accum_matches(arch):
    """Gradient accumulation (sequential microbatches) == one big batch."""
    cfg = port_cfg(_smoke_cfg(arch))
    params = init_params(cfg, seed=0, device="cpu")
    batch = _batch_for(cfg, 4, 8, np.random.default_rng(1))
    out = []
    for accum in (1, 2):
        p = _clone(params)
        step = PT.make_train_step(cfg, AdamWConfig(lr=1e-3), accum=accum,
                                  impl="naive")
        p, _, m = step(p, adamw_init(p), batch)
        out.append((p, m))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-4)
    l1 = next(tree_leaves(p1))[1]
    l2 = next(tree_leaves(p2))[1]
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=2e-4)


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b"])
def test_accum_two_equals_the_reference(arch):
    cfg = _smoke_cfg(arch)
    rp = ref_params.init_params(cfg, seed=0)
    np_params = jax.tree.map(np.asarray, rp)
    batch = _batch_for(cfg, 4, 8, np.random.default_rng(2))
    ref_step = RT.make_train_step(cfg, RefAdamWConfig(lr=1e-3), accum=2,
                                  impl="naive")
    rp2, ropt, rm = jax.jit(ref_step)(
        rp, ref_adamw_init(rp), {k: jnp.asarray(v) for k, v in batch.items()})
    pp = params_from_numpy(np_params, device="cpu")
    step = PT.make_train_step(port_cfg(cfg), AdamWConfig(lr=1e-3), accum=2,
                              impl="naive")
    pp2, popt, pm = step(pp, adamw_init(pp), batch)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    want_m = dict(tree_leaves(jax.tree.map(np.asarray, ropt["m"])))
    want_p = dict(tree_leaves(jax.tree.map(np.asarray, rp2)))
    old_p = dict(tree_leaves(np_params))
    flipped = total = 0
    for path, m in tree_leaves(popt["m"]):
        w = want_m[path]
        np.testing.assert_allclose(m.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=path)
        # where |m| is well above the noise the step is sign(g) * lr
        sure = np.abs(w) > 1e-4 * float(np.abs(w).max())
        got_p = dict(tree_leaves(pp2))[path].numpy()
        np.testing.assert_allclose(got_p[sure], want_p[path][sure], rtol=0,
                                   atol=1e-6, err_msg=path)
        flipped += int((np.abs(got_p - want_p[path]) > 1e-6).sum())
        total += w.size
        assert not np.array_equal(want_p[path], old_p[path]) or \
            not np.any(w), path
    assert flipped <= 1e-3 * total, (flipped, total)


# --------------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-3b", "zamba2-7b",
                                  "whisper-large-v3", "qwen2-moe-a2.7b"])
def test_remat_full_gives_the_same_grads_and_recomputes(arch, monkeypatch):
    base = get_arch(arch)
    cfg = port_cfg(reduced(base, layers=7 if base.hybrid_attn_every else 3))
    if base.hybrid_attn_every:
        cfg = dataclasses.replace(cfg, hybrid_attn_every=6)
    batch = _batch_for(cfg, 2, 16, np.random.default_rng(3))
    calls = collections.Counter()
    for fn in ("rwkv_block", "mamba_block", "dense_block",
               "shared_attn_block"):
        orig = getattr(PT, fn)

        def counted(*a, _orig=orig, _fn=fn, **k):
            calls[_fn] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(PT, fn, counted)
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat, compute_dtype="float32")
        p = init_params(c, seed=0, device="cpu")
        calls.clear()
        out[remat] = PT._value_and_grad(p, batch, c, "naive", "dense")
        out[remat + "_calls"] = sum(calls.values())
    (l0, g0), (l1, g1) = out["none"], out["full"]
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b), path
    if arch != "whisper-large-v3":      # whisper's layers are closures
        assert out["full_calls"] == 2 * out["none_calls"] > 0


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_stacked_leaves_unbind_once(arch):
    """The backward reaches each stacked ``(L, ...)`` parameter through
    one ``UnbindBackward`` and never through a per-layer select, which
    would allocate a zero tensor of the whole stack per layer."""
    base = get_arch(arch)
    cfg = dataclasses.replace(port_cfg(reduced(
        base, layers=7 if base.hybrid_attn_every else 2)), remat="none")
    p = init_params(cfg, seed=0, device="cpu")
    batch = _batch_for(cfg, 2, 8, np.random.default_rng(4))
    for _, leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    loss = PT.loss_fn(p, batch, cfg, impl="naive")
    seen, names, stack = set(), collections.Counter(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names[type(node).__name__] += 1
        nxt = [f for f, _ in node.next_functions]
        if type(node).__name__ == "SelectBackward0":
            assert not any(type(f).__name__ == "AccumulateGrad"
                           for f in nxt if f is not None)
        stack.extend(nxt)
    stacked = sum(1 for k, _ in tree_leaves(p)
                  if k.startswith(("layers/", "enc_layers/")))
    assert names["UnbindBackward0"] == stacked
