"""The port's LM serving path (``repro_torch.serving.generate`` and
``launch/serve.py --mode lm``) against the reference's on the CPU.

The reference's weights are carried across with ``params_from_numpy``;
prompts are made with numpy from a seed.  At f32 compute the greedy
tokens must be equal.  At bf16 compute (the configs' own) a token must be
equal at every step up to and including the first whose reference logits
have a top-2 margin of 3e-2 or less (beyond it, a near tie may go either
way and the streams diverge).

For qwen2-vl-2b the reference's ``generate`` decodes from position S
instead of ``num_patches + S`` and cuts the prefilled stream (``ROADMAP.md``,
R3), so there the port is held to greedy decoding by the reference's full
forward pass over the whole stream.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.config import reduced
from repro.models.params import init_params as ref_init
from repro.serving import generate as ref_generate
from repro.serving.lm_decode import _grow_caches as ref_grow

from repro_torch.models import config as port_config
from repro_torch.models import transformer as PT
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serving import generate
from repro_torch.serving.lm_decode import _grow_caches, greedy_sample

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["gemma3-1b", "nemotron-4-15b", "qwen2-72b", "qwen3-8b"]
MARGIN = 3e-2


def port_cfg(cfg):
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(port_config, type(v).__name__)
            return cls(**{f.name: getattr(v, f.name)
                          for f in dataclasses.fields(v)})
        return v
    return port_config.ArchConfig(**{f.name: conv(getattr(cfg, f.name))
                                     for f in dataclasses.fields(cfg)})


def small_cfg(name, dtype):
    base = get_arch(name)
    cfg = reduced(base, layers=3 if base.window_pattern else 2)
    return dataclasses.replace(cfg, remat="none", compute_dtype=dtype)


def weights(cfg, seed=0):
    rp = ref_init(cfg, seed=seed)
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def ref_margins(rp, prompt, cfg, max_new):
    """The reference's greedy tokens and the top-2 margin of the logits
    each came from, step by step (its ``generate``'s own loop)."""
    b, s = prompt.shape
    logits, caches = RT.prefill_step(rp, jnp.asarray(prompt), cfg,
                                     impl="naive")
    caches = ref_grow(caches, cfg, b, s, s + max_new)
    toks, margins = [], []
    for i in range(max_new):
        lg = np.asarray(logits)[:, :cfg.vocab]
        top2 = np.sort(lg, -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(lg.argmax(-1).astype(np.int32))
        if i + 1 < max_new:
            logits, caches = RT.decode_step(
                rp, caches, jnp.asarray(toks[-1][:, None]),
                jnp.int32(s + i), cfg)
    return np.stack(toks, 1), np.stack(margins, 1)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_the_reference(arch, dtype):
    """``generate`` (B = 2, S = 12, 6 new tokens; gemma3's 8-slot rings
    wrap) gives the reference's ``generate``'s tokens: all of them at f32,
    and up to the first near tie at bf16."""
    cfg = small_cfg(arch, dtype)
    rp, pp = weights(cfg)
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    want = np.asarray(ref_generate(rp, prompt, cfg, max_new=6,
                                   impl="naive"))
    got = generate(pp, prompt, port_cfg(cfg), max_new=6, impl="naive",
                   device="cpu")
    assert got.shape == (2, 6) and got.dtype == np.int32
    if dtype == "float32":
        assert np.array_equal(got, want)
        return
    toks, margins = ref_margins(rp, prompt, cfg, 6)
    assert np.array_equal(toks, want)
    for row in range(2):
        tied = np.flatnonzero(margins[row] <= MARGIN)
        upto = tied[0] + 1 if tied.size else 6
        assert np.array_equal(got[row, :upto], want[row, :upto]), row


def full_forward_greedy(rp, prompt, patches, cfg, max_new):
    """Greedy decoding by the reference's full forward pass over the whole
    stream (patches, prompt and the tokens so far) at every step."""
    toks = np.asarray(prompt)
    out = []
    for _ in range(max_new):
        h = RT.forward_hidden(rp, jnp.asarray(toks), cfg,
                              patches=jnp.asarray(patches), impl="naive")
        h = RL.norm(h, rp["final_norm"], cfg)
        logits = np.asarray(RL.lm_logits(h[:, -1:], rp, cfg))[:, 0]
        nxt = logits[:, :cfg.vocab].argmax(-1).astype(np.int32)
        out.append(nxt)
        toks = np.concatenate([toks, nxt[:, None]], 1)
    return np.stack(out, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_vlm_generate_equals_the_full_forward_oracle(seed):
    """qwen2-vl-2b (8 patches, B = 2, S = 8, 4 new tokens, f32 compute):
    the port decodes from position ``num_patches + S`` against a cache of
    ``num_patches + S + max_new`` slots and equals greedy decoding by the
    full forward pass; the reference's ``generate`` does not (R3)."""
    cfg = small_cfg("qwen2-vl-2b", "float32")
    rp, pp = weights(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    patches = (rng.normal(size=(2, cfg.vlm.num_patches, cfg.d_model))
               * 0.02).astype(np.float32)
    oracle = full_forward_greedy(rp, prompt, patches, cfg, 4)
    got = generate(pp, prompt, port_cfg(cfg), max_new=4, patches=patches,
                   impl="naive", device="cpu")
    assert np.array_equal(got, oracle)
    ref = np.asarray(ref_generate(rp, prompt, cfg, max_new=4,
                                  patches=patches, impl="naive"))
    assert np.array_equal(ref[:, 0], oracle[:, 0])   # the prefill agrees
    assert not np.array_equal(ref, oracle)           # R3: decode does not


def test_grow_caches_and_greedy_sample():
    """``_grow_caches`` keeps the prefilled stream at the front of the
    grown cache (a ring already at its size unchanged) as the reference's
    does; ``greedy_sample`` masks the vocab padding and takes the first
    index on a tie."""
    cfg = small_cfg("gemma3-1b", "float32")
    rp, pp = weights(cfg)
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    _, rc = RT.prefill_step(rp, jnp.asarray(prompt), cfg, impl="naive")
    _, pc = PT.prefill_step(pp, prompt, port_cfg(cfg), impl="naive")
    want = ref_grow(rc, cfg, 2, 12, 20)
    got = _grow_caches(pc, port_cfg(cfg), 2, 12, 20)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   rtol=2.0 ** -7, atol=1e-5)
    assert got["local_k"].shape == pc["local_k"].shape     # 8-slot rings
    logits = torch.zeros((3, 10))
    logits[0, 9] = 5.0                     # padding beyond vocab 8
    logits[1, [2, 5]] = 1.0                # a tie
    logits[2, 7] = -1.0
    assert greedy_sample(logits, 8).tolist() == [[0], [2], [0]]
    assert greedy_sample(logits, 8).dtype == torch.int32


def test_generate_defaults_to_the_card(monkeypatch):
    """``generate`` runs on the card unless told otherwise, raises without
    one, and refuses weights that lie elsewhere than ``device``."""
    cfg = port_cfg(small_cfg("qwen3-8b", "float32"))
    pp = init_params(cfg, seed=0, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(pp, prompt, cfg, max_new=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lie on cpu"):
        generate(pp, prompt, cfg, max_new=2, device="cuda")


OTHER = ["moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "rwkv6-3b",
         "whisper-large-v3", "zamba2-7b"]


def other_cfg(arch):
    """f32 compute; drop-free MoE capacity (``tests/test_archs.py``'s);
    zamba2 at 4 layers, so one group (two mamba layers and the shared
    block) and one mamba layer after it; ``mamba2`` is a constructed
    pure-``ssm`` stack (no shipped arch uses it)."""
    if arch == "mamba2":
        return dataclasses.replace(small_cfg("zamba2-7b", "float32"),
                                   family="ssm", hybrid_attn_every=0)
    cfg = small_cfg(arch, "float32")
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


@pytest.mark.parametrize("arch", OTHER + ["mamba2"])
def test_generate_other_families_matches_the_reference(arch):
    """``tests/test_serving.py::test_lm_generate_ssm_runs`` in reduced
    form for every family beyond the dense stack: ``generate`` (B = 2,
    S = 10, 5 new tokens, f32) gives the reference's tokens; whisper's
    encoder runs on frames made from a seed (normal x 0.02)."""
    cfg = other_cfg(arch)
    rp, pp = weights(cfg)
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    frames = None
    if cfg.family == "audio":
        frames = (rng.normal(size=(2, cfg.encdec.enc_seq, cfg.d_model))
                  * 0.02).astype(np.float32)
    want = np.asarray(ref_generate(
        rp, prompt, cfg, max_new=5, impl="naive",
        frames=None if frames is None else jnp.asarray(frames)))
    got = generate(pp, prompt, port_cfg(cfg), max_new=5, frames=frames,
                   impl="naive", device="cpu")
    assert got.shape == (2, 5) and got.dtype == np.int32
    assert np.array_equal(got, want)


def test_grow_caches_keeps_states_and_cross_caches():
    """``_grow_caches`` leaves the O(1) SSM states and whisper's cross
    caches as they are and grows the self-attention caches, as the
    reference's does."""
    for arch in ("rwkv6-3b", "zamba2-7b", "whisper-large-v3"):
        cfg = other_cfg(arch)
        pc = port_cfg(cfg)
        _, pp = weights(cfg)
        prompt = np.zeros((2, 6), np.int32)
        frames = (np.zeros((2, cfg.encdec.enc_seq, cfg.d_model), np.float32)
                  if cfg.family == "audio" else None)
        _, caches = PT.prefill_step(pp, prompt, pc, frames=frames,
                                    impl="naive")
        grown = _grow_caches(caches, pc, 2, 6, 10)
        want = PT.cache_shapes(pc, 2, 10)
        assert {k: tuple(v.shape) for k, v in grown.items()} == \
            {k: s for k, (s, _) in want.items()}
        for key, v in caches.items():
            if tuple(v.shape) == want[key][0]:
                assert torch.equal(grown[key], v), key
            else:
                assert torch.equal(grown[key][:, :, :6], v), key
                assert not grown[key][:, :, 6:].any(), key


@pytest.mark.parametrize("arch", OTHER)
def test_launcher_serves_the_other_families_on_the_cpu(arch):
    """``--mode lm --device cpu`` for the moe, ssm, hybrid and audio
    archs (whisper with zero frames, as the reference's launcher)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--arch", arch, "--device", "cpu", "--batch", "2",
         "--prompt-len", "20", "--max-new", "3"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"arch={arch} (reduced)" in res.stdout
    assert "generated (2, 3)" in res.stdout, res.stdout


def test_launcher_serves_every_dense_path_arch_on_the_cpu():
    """``--mode lm --device cpu`` for qwen2-vl-2b (patches prepended) and
    gemma3-1b (ring buffers), each with 3 prompts of 40 tokens, which
    wraps gemma3's 8-slot rings, like the reference's launcher."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch in ("qwen2-vl-2b", "gemma3-1b"):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
             "lm", "--arch", arch, "--device", "cpu", "--batch", "3",
             "--prompt-len", "40", "--max-new", "5"], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr
        assert f"arch={arch} (reduced)" in res.stdout
        assert "generated (3, 5)" in res.stdout, res.stdout
