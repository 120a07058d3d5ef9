"""The port's training inputs and backward against the reference on the
CPU: the token pipeline, and ``loss_fn`` with every parameter's gradient
for all ten archs (the flash backward is in
``tests/test_torch_flash_backward.py``).

Tolerances:

* token batches byte-equal;
* ``loss_fn`` within 1e-5 of the reference's, and every gradient leaf
  within 1e-5 of the reference's ``jax.value_and_grad``, relative to that
  leaf's largest gradient (largest seen: 2.5e-6, zamba2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_arch
from repro.data import tokens as ref_tokens
from repro.models import params as ref_params
from repro.models import transformer as RT
from repro.models.config import reduced

from repro_torch.data import tokens as port_tokens
from repro_torch.models import config as port_config
from repro_torch.models import transformer as PT
from repro_torch.models.params import params_from_numpy, tree_leaves

GRAD_TOL = 1e-5


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


# ------------------------------------------------------------- tokens

def test_token_batches_are_byte_equal_including_a_resume():
    args = (7, 3, 24, 101)
    ref = ref_tokens.synthetic_token_batches(*args)
    port = port_tokens.synthetic_token_batches(*args)
    for _ in range(4):
        (rt, rl), (pt, pl) = next(ref), next(port)
        assert rt.dtype == pt.dtype == np.int32
        assert rt.tobytes() == pt.tobytes() and rl.tobytes() == pl.tobytes()
    ref_pipe = ref_tokens.TokenPipeline(*args, start_step=5)
    port_pipe = port_tokens.TokenPipeline(*args, start_step=5)
    try:
        for k in range(3):
            (rt, rl), (pt, pl) = next(ref_pipe), next(port_pipe)
            assert rt.tobytes() == pt.tobytes()
            assert rl.tobytes() == pl.tobytes()
            assert pt.tobytes() == port_tokens._batch_at(
                7, 5 + k, 3, 24, 101)[:, :-1].tobytes()
        assert port_pipe.step == ref_pipe.step == 8
    finally:
        ref_pipe.close()
        port_pipe.close()


# ------------------------------------------------- per-arch loss and grads

def train_cfg(name):
    """The reference tests' small config at f32 compute; zamba2 with 7
    layers at ``hybrid_attn_every=6`` so its shared block runs; MoE at
    drop-free capacity (R5)."""
    base = get_arch(name)
    layers = 3 if base.window_pattern else 7 if base.hybrid_attn_every else 2
    cfg = reduced(base, layers=layers)
    over = {}
    if base.hybrid_attn_every:
        over["hybrid_attn_every"] = 6
    if cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=16.0)
    return dataclasses.replace(cfg, remat="none", compute_dtype="float32",
                               **over)


def train_batch(cfg, b, s, rng):
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


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_every_gradient_equal_the_reference(arch):
    cfg = train_cfg(arch)
    rp = ref_params.init_params(cfg, seed=0)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    batch = train_batch(cfg, 2, 16, np.random.default_rng(0))
    if arch == "qwen2-vl-2b":
        batch["loss_mask"] = (np.arange(16)[None] % 3 != 0).astype(
            np.float32).repeat(2, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_r, grads_r = jax.value_and_grad(
        lambda p: RT.loss_fn(p, jb, cfg, impl="naive"))(rp)
    loss, grads = PT._value_and_grad(pp, batch, port_cfg(cfg), "naive",
                                     "dense")
    np.testing.assert_allclose(float(loss), float(loss_r), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(
        float(PT.loss_fn(pp, batch, port_cfg(cfg), impl="naive")),
        float(loss), atol=1e-6, rtol=0)
    want = dict(tree_leaves(jax.tree.map(np.asarray, grads_r)))
    got = list(tree_leaves(grads))
    assert {p for p, _ in got} == set(want)
    for path, g in got:
        w = want[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        scale = float(np.abs(w).max())
        assert scale > 0, f"{path} gets no gradient"
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=path)
