"""The port's LM model substrate (``repro_torch.models``) against the
reference's ``repro.models`` on the CPU.

Inputs are made with numpy from a seed; the reference's parameters are
carried across with ``params_from_numpy``.  Configs are the reference
tests' small ones (``reduced``: 2 layers, 3 for gemma3's windowed stack,
``d_model`` 64; for the other families see ``other_cfg``).  Tolerances:

* f32 compute: logits and KV caches within ``rtol=1e-4, atol=1e-5``,
  greedy tokens equal;
* bf16 compute (the configs' own): logits within ``rtol=3e-2,
  atol=3e-2``, and the argmax equal wherever the reference's top-2
  margin exceeds 3e-2.

Each test's docstring gives the largest difference seen on this machine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_arch
from repro.models import flash as ref_flash
from repro.models import layers as RL
from repro.models import params as ref_params
from repro.models import transformer as RT
from repro.models.config import reduced

from repro_torch import configs as port_configs
from repro_torch.models import config as port_config
from repro_torch.models import flash as port_flash
from repro_torch.models import layers as PL
from repro_torch.models import params as port_params
from repro_torch.models import transformer as PT
from repro_torch.models.params import params_from_numpy

DENSE = ["gemma3-1b", "nemotron-4-15b", "qwen2-72b", "qwen2-vl-2b",
         "qwen3-8b"]
OTHER = sorted(set(ARCHS) - set(DENSE))
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
MARGIN = 3e-2


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


def small_cfg(name, dtype="float32", **over):
    base = get_arch(name)
    cfg = reduced(base, layers=3 if base.window_pattern else 2)
    return dataclasses.replace(cfg, remat="none", compute_dtype=dtype,
                               **over)


def both_params(cfg, seed=0):
    rp = ref_params.init_params(cfg, seed=seed)
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np_(got), np_(want), **tol)


def close_cache(got, want, tol):
    """A bf16 cache holds f32 values rounded once: an f32-level difference
    upstream can flip that rounding, so a bf16 entry may also be one bf16
    step from the reference's (2**-7 of the value at most, 8 significant
    bits).  Other dtypes go through ``close``."""
    if got.dtype != torch.bfloat16:
        return close(got, want, tol)
    g, w = np_(got), np_(want)
    np.testing.assert_allclose(g, w, rtol=max(tol["rtol"], 2.0 ** -7),
                               atol=tol["atol"])
    assert np.mean(g == w) > 0.99 or tol is BF16


def same_argmax_where_decided(got, want):
    """Argmax equal on every row whose reference top-2 margin > MARGIN."""
    g, w = np_(got), np_(want)
    top2 = np.sort(w, -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert np.array_equal(g.argmax(-1)[decided], w.argmax(-1)[decided])


def tensor(rng, *shape, scale=1.0, dtype=np.float32):
    return (rng.normal(size=shape) * scale).astype(dtype)


def both(x, dtype=None):
    """The same numpy array as a jax array and a torch tensor."""
    j = jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)
    t = torch.from_numpy(np.array(x))
    if dtype is not None:
        t = t.to(getattr(torch, jnp.dtype(dtype).name))
    return j, t


def layer_params(rp, pp, i=0):
    return (jax.tree.map(lambda a: a[i], rp["layers"]),
            PT._layer(pp["layers"], i))


# --------------------------------------------------------------- configs

def test_configs_are_the_references():
    """All ten arch files, ``windows()``, ``padded_vocab``, ``hd`` and
    ``reduced`` equal the reference's."""
    assert port_configs.list_archs() == sorted(ARCHS)
    for name in ARCHS:
        ref, port = get_arch(name), port_configs.get_arch(name)
        assert port == port_cfg(ref)
        assert port.windows() == ref.windows()
        assert (port.padded_vocab, port.hd) == (ref.padded_vocab, ref.hd)
        assert port_config.reduced(port, layers=3) == \
            port_cfg(reduced(ref, layers=3))
    with pytest.raises(KeyError):
        port_configs.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_and_specs_equal_the_references(arch):
    """``param_count`` at full size (arithmetic only) and every leaf's
    shape, axes and init kind, for all ten archs."""
    cfg = get_arch(arch)
    assert port_params.param_count(port_cfg(cfg)) == \
        ref_params.param_count(cfg)
    want = {jax.tree_util.keystr(k): s for k, s in
            jax.tree_util.tree_flatten_with_path(
                ref_params.param_specs(cfg),
                is_leaf=lambda x: isinstance(x, ref_params.PSpec))[0]}
    got = dict(port_params.tree_leaves(port_params.param_specs(
        port_cfg(cfg))))
    assert len(got) == len(want)
    for (path, s), (_, r) in zip(sorted(got.items()), sorted(want.items())):
        assert (s.shape, s.axes, s.init, s.scale) == \
            (r.shape, r.axes, r.init, r.scale), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shapes_equal_the_references(arch):
    cfg = reduced(get_arch(arch))
    for cfg in (cfg, dataclasses.replace(cfg, kv_quant=True)):
        want = RT.cache_shapes(cfg, 3, 20)
        got = PT.cache_shapes(port_cfg(cfg), 3, 20)
        assert {k: (s, str(d).replace("torch.", "")) for k, (s, d)
                in got.items()} == \
            {k: (s, jnp.dtype(d).name) for k, (s, d) in want.items()}


def test_init_params_shapes_seed_and_default_device(monkeypatch):
    """Leaves have the specs' shapes and the config's dtype; one seed
    gives the same weights, another different ones; ``init_params`` and
    ``params_from_numpy`` default to the card and raise without one."""
    cfg = port_cfg(small_cfg("gemma3-1b"))
    a = port_params.init_params(cfg, seed=3, device="cpu")
    b = port_params.init_params(cfg, seed=3, device="cpu")
    c = port_params.init_params(cfg, seed=4, device="cpu")
    specs = dict(port_params.tree_leaves(port_params.param_specs(cfg)))
    leaves = dict(port_params.tree_leaves(a))
    assert leaves.keys() == specs.keys()
    for path, t in leaves.items():
        assert tuple(t.shape) == specs[path].shape
        assert t.dtype == torch.float32
        assert torch.equal(t, dict(port_params.tree_leaves(b))[path])
    assert not torch.equal(a["embed"], c["embed"])
    # rmsnorm1p scales start at zero, normal leaves near 0.02
    assert not a["final_norm"]["scale"].any()
    assert 0.015 < float(a["embed"].std()) < 0.025
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: port_params.init_params(cfg),
                 lambda: params_from_numpy({"embed": np.zeros(2)}),
                 lambda: PT.init_caches(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------- layers

NORMS = [("qwen3-8b", "rmsnorm"), ("gemma3-1b", "rmsnorm1p"),
         ("nemotron-4-15b", "layernorm1p"), ("whisper-large-v3",
                                             "layernorm")]


@pytest.mark.parametrize("arch,kind", NORMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_head_rmsnorm(arch, kind, dtype):
    """All four norm kinds on f32 and bf16 inputs with non-trivial scale
    and bias; f32 agrees to 5e-7, bf16 to one rounding."""
    cfg = small_cfg(arch)
    assert cfg.norm == kind
    rng = np.random.default_rng(1)
    x = tensor(rng, 2, 5, cfg.d_model, scale=3.0)
    p = {"scale": tensor(rng, cfg.d_model), "bias": tensor(rng, cfg.d_model)}
    jx, tx = both(x, dtype)
    want = RL.norm(jx, {k: jnp.asarray(v) for k, v in p.items()}, cfg)
    got = PL.norm(tx, {k: torch.from_numpy(v) for k, v in p.items()},
                  port_cfg(cfg))
    assert got.dtype == getattr(torch, dtype)
    close(got, want, F32 if dtype == "float32" else BF16)
    hx = tensor(rng, 2, 5, 3, 16)
    s = tensor(rng, 16)
    close(PL.head_rmsnorm(torch.from_numpy(hx), torch.from_numpy(s)),
          RL.head_rmsnorm(jnp.asarray(hx), jnp.asarray(s)), F32)


ROPES = [("qwen3-8b", None, 2), ("qwen3-8b", 123.0, 2),
         ("nemotron-4-15b", None, 2),         # partial RoPE, rope_pct 0.5
         ("gemma3-1b", 1e6, 2),               # global theta
         ("qwen2-vl-2b", None, 3)]            # M-RoPE on (3, B, S)


@pytest.mark.parametrize("arch,theta,pos_dims", ROPES)
def test_apply_rope(arch, theta, pos_dims):
    """Standard, partial and M-RoPE, with and without a theta override,
    at positions up to 5000 (f32 within 1e-4 relative).  M-RoPE's
    reduced sections (4, 6, 6) need hd = 32, so that case runs 2 heads."""
    cfg = small_cfg(arch)
    if pos_dims == 3:
        cfg = dataclasses.replace(reduced(get_arch(arch), heads=2),
                                  compute_dtype="float32")
    rng = np.random.default_rng(2)
    x = tensor(rng, 2, 6, 4, cfg.hd)
    shape = (3, 2, 6) if pos_dims == 3 else (2, 6)
    pos = rng.integers(0, 5000, shape).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg, theta)
    got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        port_cfg(cfg), theta)
    close(got, want, dict(rtol=1e-4, atol=1e-4))
    if cfg.rope_pct < 1:             # the pass-through half is untouched
        rot = int(cfg.hd * cfg.rope_pct)
        assert torch.equal(got[..., rot:], torch.from_numpy(x)[..., rot:])


PROJ = ["qwen3-8b", "qwen2-72b", "gemma3-1b", "nemotron-4-15b",
        "whisper-large-v3"]


@pytest.mark.parametrize("arch", PROJ)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_attention_train_and_mlp(arch, dtype):
    """``qkv_project`` (bias, qk-norm), ``attention_train`` causal with
    and without a window and as cross-attention, and ``mlp`` (swiglu,
    squared ReLU, gelu with bias) against the reference, with random
    non-zero biases and norm scales."""
    cfg = small_cfg(arch, dtype, qkv_bias=arch != "qwen3-8b",
                    attn_out_bias=True)
    pc = port_cfg(cfg)
    rp, pp = both_params(cfg, seed=5)
    rng = np.random.default_rng(3)
    # biases and scales start at 0/1: make them random on both sides
    for key in ("bq", "bk", "bv", "bo", "q_norm", "k_norm"):
        if key in pp["layers"]["attn"]:
            v = tensor(rng, *pp["layers"]["attn"][key].shape, scale=0.1)
            rp["layers"]["attn"][key] = jnp.asarray(v)
            pp["layers"]["attn"][key] = torch.from_numpy(v)
    for key in ("bi", "bo"):
        if key in pp["layers"]["mlp"]:
            v = tensor(rng, *pp["layers"]["mlp"][key].shape, scale=0.1)
            rp["layers"]["mlp"][key] = jnp.asarray(v)
            pp["layers"]["mlp"][key] = torch.from_numpy(v)
    rl, pl = layer_params(rp, pp)
    tol = F32 if dtype == "float32" else BF16
    x = tensor(rng, 2, 8, cfg.d_model)
    kv = tensor(rng, 2, 5, cfg.d_model)
    jx, tx = both(x, dtype)
    for a, b in zip(PL.qkv_project(tx, pl["attn"], pc),
                    RL.qkv_project(jx, rl["attn"], cfg)):
        close(a, b, tol)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    for window in (0, 3):
        close(PL.attention_train(tx, pl["attn"], pc, torch.from_numpy(pos),
                                 window=window),
              RL.attention_train(jx, rl["attn"], cfg, jnp.asarray(pos),
                                 window=window), tol)
    close(PL.attention_train(tx, pl["attn"], pc, torch.from_numpy(pos),
                             kv_x=torch.from_numpy(kv).to(tx.dtype)),
          RL.attention_train(jx, rl["attn"], cfg, jnp.asarray(pos),
                             kv_x=jnp.asarray(kv, jx.dtype)), tol)
    close(PL.mlp(tx, pl["mlp"], pc), RL.mlp(jx, rl["mlp"], cfg), tol)


# (arch, rolling, cache_len, cache slots, int8 cache); int8 caches are
# the dense (non-ring) stack's
DECODES = [("qwen3-8b", False, 5, 12, False), ("qwen3-8b", False, 5, 12, True),
           ("qwen2-72b", False, 11, 12, False),
           ("qwen2-72b", False, 11, 12, True),
           ("gemma3-1b", True, 5, 8, False),          # ring not yet full
           ("gemma3-1b", True, 13, 8, False),         # ring wrapped
           ("nemotron-4-15b", False, 7, 12, False),
           ("nemotron-4-15b", False, 7, 12, True)]


@pytest.mark.parametrize("arch,rolling,cache_len,t,quant", DECODES)
def test_attention_decode(arch, rolling, cache_len, t, quant):
    """One-token decode on a bf16 (or int8 with scales) cache, plain and
    as a ring buffer before and after it wraps: the output within the f32
    tolerance, the written cache exactly equal to the reference's."""
    cfg = small_cfg(arch)
    pc = port_cfg(cfg)
    rp, pp = both_params(cfg, seed=6)
    rl, pl = layer_params(rp, pp)
    rng = np.random.default_rng(4)
    x = tensor(rng, 2, 1, cfg.d_model)
    shape = (2, t, cfg.n_kv_heads, cfg.hd)
    if quant:
        kc = rng.integers(-127, 128, shape).astype(np.int8)
        vc = rng.integers(-127, 128, shape).astype(np.int8)
        ks = np.abs(tensor(rng, 2, cfg.n_kv_heads, scale=0.01)) + 1e-3
        vs = np.abs(tensor(rng, 2, cfg.n_kv_heads, scale=0.01)) + 1e-3
        extra_r = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        extra_p = dict(k_scale=torch.from_numpy(ks),
                       v_scale=torch.from_numpy(vs))
        jk, tk = jnp.asarray(kc), torch.from_numpy(kc.copy())
        jv, tv = jnp.asarray(vc), torch.from_numpy(vc.copy())
    else:
        kc, vc = tensor(rng, *shape), tensor(rng, *shape)
        extra_r = extra_p = {}
        jk, tk = both(kc, jnp.bfloat16)
        jv, tv = both(vc, jnp.bfloat16)
    pos = np.full((2,), cache_len, np.int32)
    want, wk, wv = RL.attention_decode(
        jnp.asarray(x), rl["attn"], cfg, jk, jv, jnp.asarray(pos),
        jnp.int32(cache_len), window=t if rolling else 0, theta=1e4,
        rolling=rolling, **extra_r)
    got, gk, gv = PL.attention_decode(
        torch.from_numpy(x), pl["attn"], pc, tk, tv, torch.from_numpy(pos),
        cache_len, window=t if rolling else 0, theta=1e4, rolling=rolling,
        **extra_p)
    close(got, want, F32)
    assert gk is tk and gv is tv            # written in place
    assert np.array_equal(np_(gk), np_(wk)) and \
        np.array_equal(np_(gv), np_(wv))


def test_quantize_kv_and_cross_attention_decode():
    """``quantize_kv`` equals the reference's exactly (int8 values and
    scales; round half to even), ``cross_attention_decode`` within the
    f32 tolerance."""
    rng = np.random.default_rng(5)
    kc = tensor(rng, 2, 3, 8, 4, 16, scale=2.0)
    vc = tensor(rng, 2, 3, 8, 4, 16)
    kc[0, 0, 0, 0, :4] = [0.5, 1.5, -2.5, 127.0]      # ties and the clip
    got = PL.quantize_kv(torch.from_numpy(kc), torch.from_numpy(vc))
    want = RL.quantize_kv(jnp.asarray(kc), jnp.asarray(vc))
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, jnp.dtype(w.dtype).name)
        assert np.array_equal(g.numpy(), np.asarray(w))
    cfg = small_cfg("whisper-large-v3")
    rp, pp = both_params(cfg, seed=7)
    rl, pl = layer_params(rp, pp)
    x = tensor(rng, 2, 1, cfg.d_model)
    ck = tensor(rng, 2, 16, cfg.n_kv_heads, cfg.hd)
    cv = tensor(rng, 2, 16, cfg.n_kv_heads, cfg.hd)
    close(PL.cross_attention_decode(torch.from_numpy(x), pl["cross"],
                                    port_cfg(cfg), torch.from_numpy(ck),
                                    torch.from_numpy(cv)),
          RL.cross_attention_decode(jnp.asarray(x), rl["cross"], cfg,
                                    jnp.asarray(ck), jnp.asarray(cv)), F32)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_logits_and_cross_entropy(arch, dtype):
    """``embed_tokens`` (gemma3's ``embed_scale`` rounds sqrt(d) to the
    compute dtype first: bit-equal to the reference in bf16),
    ``lm_logits`` tied (gemma3) and untied (qwen3), ``cross_entropy``."""
    cfg = small_cfg(arch, dtype)
    pc = port_cfg(cfg)
    rp, pp = both_params(cfg, seed=8)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    want = RL.embed_tokens(jnp.asarray(toks), rp["embed"], cfg)
    got = PL.embed_tokens(torch.from_numpy(toks), pp["embed"], pc)
    assert np.array_equal(np_(got), np_(want))
    close(PL.lm_logits(got, pp, pc), RL.lm_logits(want, rp, cfg),
          F32 if dtype == "float32" else BF16)
    logits = tensor(rng, 2, 7, 50, scale=3.0)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    close(PL.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), 50),
          RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 50),
          F32)


# ----------------------------------------------------------------- flash

FLASH = [dict(), dict(window=40), dict(kv_valid=100, causal=False),
         dict(q_offset=64, window=50), dict(causal=False)]


@pytest.mark.parametrize("opts", FLASH, ids=lambda o: "-".join(
    f"{k}{v}" for k, v in o.items()) or "causal")
@pytest.mark.parametrize("schedule", ["dense", "tri"])
def test_flash_attention_matches_the_references(opts, schedule):
    """``flash_attention`` (both schedules) and ``reference_attention``
    against the reference's, GQA (8 q heads on 2 kv heads), blocks of 32
    over S = 128 (T = 192 when q_offset shifts the queries); f32 within
    9e-7 of each other and of the naive oracle.  With a ``q_offset`` the
    reference's ``"tri"`` schedule drops tiles it needs (R4; off by up to
    2.9 here), so there the port is held to the reference's ``"dense"``
    schedule and to the naive oracle."""
    rng = np.random.default_rng(7)
    t = 192 if "q_offset" in opts else 128
    q = tensor(rng, 2, 128, 8, 16)
    k = tensor(rng, 2, t, 2, 16)
    v = tensor(rng, 2, t, 2, 16)
    causal = opts.get("causal", True)
    extra = {k_: v_ for k_, v_ in opts.items() if k_ != "causal"}
    r4 = schedule == "tri" and "q_offset" in opts
    want = ref_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        "dense" if r4 else schedule, 32, 32, extra.get("window", 0),
        extra.get("kv_valid", 10 ** 9), extra.get("q_offset", 0))
    if r4:
        quirk = ref_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, "tri",
            32, 32, extra["window"], 10 ** 9, extra["q_offset"])
        assert float(jnp.abs(quirk - want).max()) > 0.1
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = port_flash.flash_attention(tq, tk, tv, causal, schedule, 32, 32,
                                     **extra)
    close(got, want, F32)
    naive = port_flash.reference_attention(tq, tk, tv, causal, **extra)
    close(naive, ref_flash.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, **extra),
        F32)
    close(got, naive, F32)


def test_flash_attention_bf16_and_block_errors():
    """bf16 inputs accumulate in f32 (within one bf16 rounding of the
    reference); lengths that are not block multiples raise."""
    rng = np.random.default_rng(8)
    q, k, v = (tensor(rng, 1, 64, 4, 16) for _ in range(3))
    jq, tq = both(q, jnp.bfloat16)
    jk, tk = both(k, jnp.bfloat16)
    jv, tv = both(v, jnp.bfloat16)
    want = ref_flash.flash_attention(jq, jk, jv, True, "tri", 16, 16)
    got = port_flash.flash_attention(tq, tk, tv, True, "tri", 16, 16)
    assert got.dtype == torch.bfloat16
    close(got, want, BF16)
    with pytest.raises(ValueError, match="multiples"):
        port_flash.flash_attention(tq[:, :40], tk, tv, True, "dense", 16, 16)


# ------------------------------------------------------- prefill / decode

def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    patches = None
    if cfg.vlm is not None:
        patches = tensor(rng, b, cfg.vlm.num_patches, cfg.d_model,
                         scale=0.02)
    return toks, patches


def _ref_prefill_decode(rp, toks, patches, cfg, s, total):
    logits_p, caches = RT.prefill_step(
        rp, jnp.asarray(toks[:, :s]), cfg,
        patches=None if patches is None else jnp.asarray(patches),
        impl="naive")
    stream = s + (0 if patches is None else patches.shape[1])
    from repro.serving.lm_decode import _grow_caches
    grown = _grow_caches(caches, cfg, toks.shape[0], stream, total)
    logits_d, after = RT.decode_step(rp, grown, jnp.asarray(toks[:, s:s + 1]),
                                     jnp.int32(stream), cfg)
    return logits_p, caches, logits_d, after


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_step_match_the_reference(arch, dtype):
    """``prefill_step`` (last logits, every cache) and one
    ``decode_step`` (logits, every cache after the write) against the
    reference on the same weights, B = 2, S = 12 (gemma3's 8-slot rings
    wrapped).  Largest differences seen: f32 logits 3e-7; the bf16 caches
    equal but for one entry of gemma3's one bf16 rounding apart (3.1e-5,
    see ``close_cache``); bf16 logits 3.9e-3."""
    cfg = small_cfg(arch, dtype)
    pc = port_cfg(cfg)
    rp, pp = both_params(cfg)
    b, s = 2, 12
    toks, patches = _inputs(cfg, b, s + 1, seed=2)
    stream = s + (0 if patches is None else patches.shape[1])
    total = stream + 4
    rl_p, rc, rl_d, rafter = _ref_prefill_decode(rp, toks, patches, cfg, s,
                                                 total)
    pl_p, caches = PT.prefill_step(pp, toks[:, :s], pc, patches=patches,
                                   impl="naive")
    tol = F32 if dtype == "float32" else BF16
    close(pl_p, rl_p, tol)
    assert caches.keys() == rc.keys()
    for key in rc:
        assert caches[key].dtype == getattr(torch, jnp.dtype(rc[key].dtype)
                                            .name)
        close_cache(caches[key], rc[key], tol)
    from repro_torch.serving.lm_decode import _grow_caches
    grown = _grow_caches(caches, pc, b, stream, total)
    pl_d, after = PT.decode_step(pp, grown, toks[:, s:s + 1], stream, pc)
    close(pl_d, rl_d, tol)
    for key in rafter:
        close_cache(after[key], rafter[key], tol)
    if dtype == "float32":
        assert np.array_equal(np_(pl_d).argmax(-1), np_(rl_d).argmax(-1))
    else:
        same_argmax_where_decided(pl_d, rl_d)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """The port's own oracle (``tests/test_archs.py``'s, with its
    tolerance ``atol=2e-3, rtol=2e-2``): prefill logits at the last
    prompt position and decode logits at position s equal the full
    forward's at f32 compute.  Largest difference seen: 6e-7."""
    cfg = port_cfg(small_cfg(arch))
    pp = port_params.init_params(cfg, seed=0, device="cpu")
    b, s = 2, 12
    toks, patches = _inputs(cfg, b, s + 1, seed=2)
    stream = s + (0 if patches is None else patches.shape[1])
    from repro_torch.serving.lm_decode import _grow_caches
    logits_p, caches = PT.prefill_step(pp, toks[:, :s], cfg,
                                       patches=patches, impl="naive")
    caches = _grow_caches(caches, cfg, b, stream, stream + 4)
    logits_d, _ = PT.decode_step(pp, caches, toks[:, s:s + 1], stream, cfg)
    h = PT.forward_hidden(pp, toks, cfg, patches=patches, impl="naive")
    full = PL.lm_logits(PL.norm(h, pp["final_norm"], cfg), pp, cfg)
    tol = dict(atol=2e-3, rtol=2e-2)
    close(logits_p, full[:, stream - 1], tol)
    close(logits_d, full[:, stream], tol)


def test_forward_hidden_flash_equals_naive_and_the_reference():
    """``forward_hidden`` with ``impl="flash"`` (blocks of 512 over
    S = 512, gemma3's 8-token windows on the local layers) equals
    ``impl="naive"`` and the reference's forward, f32."""
    cfg = small_cfg("gemma3-1b")
    pc = port_cfg(cfg)
    rp, pp = both_params(cfg)
    toks, _ = _inputs(cfg, 1, 512, seed=9)
    want = RT.forward_hidden(rp, jnp.asarray(toks), cfg, impl="naive")
    flash = PT.forward_hidden(pp, toks, pc, impl="flash", schedule="tri")
    naive = PT.forward_hidden(pp, toks, pc, impl="naive")
    close(flash, naive, F32)
    close(flash, want, F32)


# ------------------------------------------------------------- kv_quant

def _quant_cfgs():
    cfg = reduced(get_arch("qwen3-8b"))
    f = dataclasses.replace(cfg, remat="none", compute_dtype="float32")
    return f, dataclasses.replace(f, kv_quant=True)


def test_quantize_roundtrip_bounded(rng):
    """``tests/test_kv_quant.py``'s first check on the port."""
    kc = torch.from_numpy(tensor(rng, 2, 3, 8, 4, 16, scale=2.0))
    vc = torch.from_numpy(tensor(rng, 2, 3, 8, 4, 16))
    kq, vq, ks, vs = PL.quantize_kv(kc, vc)
    assert kq.dtype == torch.int8 and tuple(ks.shape) == (2, 3, 4)
    back = kq.float() * ks[:, :, None, :, None]
    bound = ks[:, :, None, :, None] * 0.5 + 1e-6
    assert bool(((back - kc).abs() <= bound).all())


def test_kv_quant_decode_close_to_bf16_path(rng):
    """``tests/test_kv_quant.py``'s second check on the port, and the
    int8 path's prefill and decode against the reference's (int8 caches
    exactly equal, logits within the f32 tolerance)."""
    cfg_f, cfg_q = _quant_cfgs()
    rp, pp = both_params(cfg_f)
    b, s = 2, 12
    toks = rng.integers(0, cfg_f.vocab, (b, s + 1)).astype(np.int32)
    from repro_torch.serving.lm_decode import _grow_caches
    out = {}
    for cfg in (cfg_f, cfg_q):
        pc = port_cfg(cfg)
        logits, caches = PT.prefill_step(pp, toks[:, :s], pc, impl="naive")
        rl, rc, rd, rafter = _ref_prefill_decode(rp, toks, None, cfg, s,
                                                 s + 4)
        grown = _grow_caches(caches, pc, b, s, s + 4)
        d, after = PT.decode_step(pp, grown, toks[:, s:s + 1], s, pc)
        close(logits, rl, F32)
        close(d, rd, F32)
        if cfg.kv_quant:
            for key in ("k", "v", "k_scale", "v_scale"):
                assert np.array_equal(np_(caches[key]), np_(rc[key])), key
                assert np.array_equal(np_(after[key]), np_(rafter[key])), key
        out[cfg.kv_quant] = (logits, caches, d)
    (lf, cf, df), (lq, cq, dq) = out[False], out[True]
    assert cq["k"].dtype == torch.int8
    close(lq, lf, dict(rtol=0, atol=1e-5))
    denom = float(df.abs().max()) + 1e-6
    assert float((dq - df).abs().max()) / denom < 0.05
    assert torch.equal(dq.argmax(-1), df.argmax(-1))


def test_cache_shapes_quant_layout():
    """``tests/test_kv_quant.py``'s third check on the port."""
    cfg = port_cfg(_quant_cfgs()[1])
    shapes = PT.cache_shapes(cfg, 4, 64)
    assert shapes["k"][1] == torch.int8
    assert shapes["k_scale"][0] == (cfg.n_layers, 4, cfg.n_kv_heads)
    caches = PT.init_caches(cfg, 4, 64, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in caches.items()} == \
        shapes


# --------------------------------- the moe, ssm, hybrid and audio families

def other_cfg(arch, dtype="float32"):
    """``small_cfg`` for the families beyond the dense stack: drop-free
    MoE capacity (``tests/test_archs.py``'s), and zamba2 at 7 layers, two
    groups of two mamba layers, each followed by the shared block, and
    one more mamba layer after them (at 2 layers no group forms)."""
    if arch == "mamba2":      # no shipped arch is a pure mamba2 stack
        return dataclasses.replace(small_cfg("zamba2-7b", dtype),
                                   family="ssm", hybrid_attn_every=0)
    cfg = small_cfg(arch, dtype)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=7)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return cfg


def _frames(cfg, b, seed):
    if cfg.family != "audio":
        return None
    rng = np.random.default_rng(seed)
    return tensor(rng, b, cfg.encdec.enc_seq, cfg.d_model, scale=0.02)


def _family_matches_the_reference(cfg, tol, s=12):
    """``forward_hidden``, ``prefill_step`` (logits and every cache) and
    one ``decode_step`` (logits and every cache after it) on the same
    weights and inputs as the reference; returns the decode logits."""
    pc = port_cfg(cfg)
    rp, pp = both_params(cfg)
    b = 2
    toks, _ = _inputs(cfg, b, s + 1, seed=2)
    frames = _frames(cfg, b, seed=3)
    jf = None if frames is None else jnp.asarray(frames)
    close(PT.forward_hidden(pp, toks, pc, frames=frames, impl="naive"),
          RT.forward_hidden(rp, jnp.asarray(toks), cfg, frames=jf,
                            impl="naive"), tol)
    rl_p, rc = RT.prefill_step(rp, jnp.asarray(toks[:, :s]), cfg, frames=jf,
                               impl="naive")
    pl_p, caches = PT.prefill_step(pp, toks[:, :s], pc, frames=frames,
                                   impl="naive")
    close(pl_p, rl_p, tol)
    assert caches.keys() == rc.keys()
    for key in rc:
        assert caches[key].dtype == getattr(torch, jnp.dtype(rc[key].dtype)
                                            .name)
        assert tuple(caches[key].shape) == rc[key].shape, key
        close_cache(caches[key], rc[key], tol)
    from repro.serving.lm_decode import _grow_caches as ref_grow
    from repro_torch.serving.lm_decode import _grow_caches
    rgrown = ref_grow(rc, cfg, b, s, s + 4)
    grown = _grow_caches(caches, pc, b, s, s + 4)
    rl_d, rafter = RT.decode_step(rp, rgrown, jnp.asarray(toks[:, s:s + 1]),
                                  jnp.int32(s), cfg)
    pl_d, after = PT.decode_step(pp, grown, toks[:, s:s + 1], s, pc)
    close(pl_d, rl_d, tol)
    assert after.keys() == rafter.keys()
    for key in rafter:
        close_cache(after[key], rafter[key], tol)
    return pl_d, rl_d


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise_naming_the_roadmap(arch):
    """Each family beyond the dense stack (moe, ssm, hybrid, audio; the id
    is kept from when they raised, naming ROADMAP.md) answers like the
    reference's at f32: ``forward_hidden``, ``prefill_step`` (logits and
    every cache: SSM states, shared-attention and cross caches) and
    ``decode_step``, B = 2, S = 12.  Largest differences seen: 4.8e-7
    (f32 logits, hidden states and SSM states), 1.5e-5 (bf16 caches)."""
    pl_d, rl_d = _family_matches_the_reference(other_cfg(arch), F32)
    assert np.array_equal(np_(pl_d).argmax(-1), np_(rl_d).argmax(-1))


@pytest.mark.parametrize("arch", OTHER + ["mamba2"])
def test_other_families_bf16_and_across_chunks(arch):
    """bf16 compute (the configs' own) at S = 12, and f32 at S = 37,
    which spans three SSM chunks of 16 with padding; the pure-``ssm``
    mamba2 stack (a constructed config: no shipped arch uses it) at
    both.  bf16 logits within 3e-2, argmax equal where the reference's
    top-2 margin exceeds 3e-2.  Largest differences seen: 1.6e-2 (bf16
    logits); at S = 37, 6.0e-7 (f32) and one bf16 step (9.8e-4, caches)."""
    pl_d, rl_d = _family_matches_the_reference(other_cfg(arch, "bfloat16"),
                                               BF16)
    same_argmax_where_decided(pl_d, rl_d)
    _family_matches_the_reference(other_cfg(arch), F32, s=37)


@pytest.mark.parametrize("arch", OTHER + ["mamba2"])
def test_other_families_prefill_decode_consistency(arch):
    """``tests/test_archs.py``'s oracle on the port (drop-free MoE, f32):
    prefill logits at the last prompt position and decode logits at
    position s equal the full forward's within ``atol=2e-3, rtol=2e-2``.
    Largest difference seen: 2.4e-4."""
    cfg = port_cfg(other_cfg(arch))
    pp = port_params.init_params(cfg, seed=0, device="cpu")
    b, s = 2, 12
    toks, _ = _inputs(cfg, b, s + 1, seed=2)
    frames = _frames(cfg, b, seed=3)
    from repro_torch.serving.lm_decode import _grow_caches
    logits_p, caches = PT.prefill_step(pp, toks[:, :s], cfg, frames=frames,
                                       impl="naive")
    caches = _grow_caches(caches, cfg, b, s, s + 4)
    logits_d, _ = PT.decode_step(pp, caches, toks[:, s:s + 1], s, cfg)
    h = PT.forward_hidden(pp, toks, cfg, frames=frames, impl="naive")
    full = PL.lm_logits(PL.norm(h, pp["final_norm"], cfg), pp, cfg)
    tol = dict(atol=2e-3, rtol=2e-2)
    close(logits_p, full[:, s - 1], tol)
    close(logits_d, full[:, s], tol)


def test_whisper_sinusoids_and_encoder_padding(monkeypatch):
    """``sinusoid_pos`` / ``sinusoid_row`` equal the reference's (the row
    at the table's positions too); ``_enc_pad`` pads 1500 frames to 1536
    and leaves 16 alone; and the encoder's output ignores its padding:
    with blocks of 12, 16 frames pad to 24, and the output equals the
    reference's unpadded encoder."""
    for seq, d in ((16, 64), (40, 1280)):
        tab = PT.sinusoid_pos(seq, d)
        close(tab, RT.sinusoid_pos(seq, d), dict(rtol=0, atol=0))
        for pos in (0, 7, seq - 1):
            close(PT.sinusoid_row(pos, d), RT.sinusoid_row(jnp.int32(pos), d),
                  F32)
            close(PT.sinusoid_row(pos, d), tab[pos], F32)
    full = port_cfg(get_arch("whisper-large-v3"))
    assert PT._enc_pad(full) == RT._enc_pad(get_arch("whisper-large-v3")) \
        == 1536
    cfg = other_cfg("whisper-large-v3")
    assert PT._enc_pad(port_cfg(cfg)) == 16
    rp, pp = both_params(cfg)
    frames = _frames(cfg, 2, seed=4)
    want = RT.whisper_encode(rp, jnp.asarray(frames), cfg, impl="naive")
    close(PT.whisper_encode(pp, frames, port_cfg(cfg), impl="naive"), want,
          F32)
    monkeypatch.setattr(PT, "BLOCK", 12)
    assert PT._enc_pad(port_cfg(cfg)) == 24
    close(PT.whisper_encode(pp, frames, port_cfg(cfg), impl="naive"), want,
          F32)
