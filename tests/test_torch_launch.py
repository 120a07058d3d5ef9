"""The port's launch layer against the reference's, on the CPU: the
(arch x shape) grid, the skip policy, ``input_specs`` shapes and dtypes,
``model_flops`` (every key of every LM cell, ``rel=1e-12``), and the
sharding specs of ``param_pspecs``, ``_cache_pspecs`` and every step
builder's in/out shardings on both production meshes, equal to the
reference's ``PartitionSpec``s as tuples (the reference built on a
``jax.sharding.AbstractMesh``, the port on its own ``DeviceMesh``: the
rules read axis names and sizes only).  Also ``dryrun --list``."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS, get_arch as ref_arch
from repro.launch import flops as ref_flops
from repro.launch import shapes as ref_shapes
from repro.launch import steps as ref_steps
from repro.models import params as ref_params
from repro.parallel import sharding as ref_sharding

import repro.parallel as ref_parallel
import repro_torch.parallel as port_parallel
from repro_torch.configs import get_arch
from repro_torch.launch import flops, shapes, steps
from repro_torch.launch.dryrun import all_cells
from repro_torch.models import params as port_params
from repro_torch.models import transformer as PT
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import DeviceMesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
LM_CELLS = [(a, s) for a in sorted(ARCHS) for s in shapes.SHAPE_ORDER]


def _port_mesh(kind):
    shape, names = MESHES[kind]

    def grid(sh):
        return "cpu" if not sh else [grid(sh[1:]) for _ in range(sh[0])]
    return DeviceMesh(grid(shape), names)


def _ref_mesh(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names)


@pytest.fixture(autouse=True)
def _no_rules():
    yield
    sharding.set_rules(None)
    ref_sharding.set_rules(None)


# -------------------------------------------------------------- the grid

def test_grid_is_40_cells():
    assert len(ARCHS) == 10 and shapes.SHAPE_ORDER == ref_shapes.SHAPE_ORDER
    assert len(all_cells()) == 42
    assert {k: (v.kind, v.seq_len, v.global_batch, v.subquadratic_only)
            for k, v in shapes.SHAPES.items()} == \
        {k: (v.kind, v.seq_len, v.global_batch, v.subquadratic_only)
         for k, v in ref_shapes.SHAPES.items()}
    assert shapes.GED_ARCHS == ref_shapes.GED_ARCHS
    assert {k: tuple(vars(v).values()) for k, v in shapes.GED_SHAPES.items()} \
        == {k: tuple(vars(v).values())
            for k, v in ref_shapes.GED_SHAPES.items()}


def test_skip_policy():
    skipped = {(a, s) for a in ARCHS for s in shapes.SHAPE_ORDER
               if shapes.cell_skip_reason(get_arch(a), shapes.SHAPES[s])}
    assert skipped == {(a, "long_500k") for a in ARCHS
                       if not get_arch(a).subquadratic}
    assert {a for a, _ in skipped} == {
        "qwen3-8b", "nemotron-4-15b", "qwen2-72b", "qwen2-vl-2b",
        "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "whisper-large-v3"}
    for a, s in LM_CELLS:
        assert shapes.cell_skip_reason(get_arch(a), shapes.SHAPES[s]) == \
            ref_shapes.cell_skip_reason(ref_arch(a), ref_shapes.SHAPES[s])


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_the_reference(arch):
    for s in shapes.SHAPE_ORDER:
        port = shapes.input_specs(get_arch(arch), shapes.SHAPES[s])
        ref = ref_shapes.input_specs(ref_arch(arch), ref_shapes.SHAPES[s])
        assert sorted(port) == sorted(ref), (arch, s)
        for k, v in port.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (arch, s, k)
            assert _dtype_name(v.dtype) == str(jnp.dtype(ref[k].dtype))
    for name, spec in shapes.GED_SHAPES.items():
        port = shapes.ged_input_specs(spec, 256)
        ref = ref_shapes.ged_input_specs(ref_shapes.GED_SHAPES[name], 256)
        assert {k: (tuple(v.shape), _dtype_name(v.dtype))
                for k, v in port.items()} == \
            {k: (tuple(v.shape), str(jnp.dtype(v.dtype)))
             for k, v in ref.items()}


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    port = flops.model_flops(get_arch(arch), shapes.SHAPES[shape])
    ref = ref_flops.model_flops(ref_arch(arch), ref_shapes.SHAPES[shape])
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-12), (arch, shape, k)


def test_model_flops_scaling_and_the_known_cell():
    cfg = get_arch("qwen3-8b")
    f_train = flops.model_flops(cfg, shapes.SHAPES["train_4k"])
    f_pre = flops.model_flops(cfg, shapes.SHAPES["prefill_32k"])
    f_dec = flops.model_flops(cfg, shapes.SHAPES["decode_32k"])
    ratio = (f_train["model_flops"] / f_train["tokens"]) / \
        (f_pre["model_flops"] / f_pre["tokens"])
    assert 1.8 < ratio < 3.2
    assert f_dec["model_flops"] < f_pre["model_flops"] / 100
    assert f_train["model_flops"] == pytest.approx(5.14161766343639e16,
                                                   rel=1e-12)
    assert f_train["n_matmul_params"] == 7_568_401_408


def test_moe_flops_count_active_only():
    f = flops.model_flops(get_arch("qwen2-moe-a2.7b"),
                          shapes.SHAPES["train_4k"])
    assert 1.5e9 < f["n_active_matmul_params"] < 4.5e9


# ------------------------------------------------------------------ specs

def _ref_spec(ns_or_p):
    spec = getattr(ns_or_p, "spec", ns_or_p)
    return tuple(spec)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, (tuple, list)) and tree and not isinstance(
            tree[0], (str, type(None), tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _port_specs(tree):
    return {k: tuple(getattr(v, "spec", v)) for k, v in _flat(tree).items()}


def _ref_specs(tree):
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec") or x is None)[0]
    out = {}
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                       for p in path)
        out[key] = _ref_spec(leaf)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_reference(arch, mesh):
    """``param_pspecs`` (FSDP and serving rules), ``_cache_pspecs`` and
    every builder's in/out shardings, as tuples."""
    pm, rm = _port_mesh(mesh), _ref_mesh(mesh)
    cfg, rcfg = get_arch(arch), ref_arch(arch)
    for fsdp in (True, False):
        pr = sharding.default_rules(pm, fsdp=fsdp)
        rr = ref_sharding.default_rules(rm, fsdp=fsdp)
        assert pr.table == {k: (tuple(v) if isinstance(v, tuple) else v)
                            for k, v in rr.table.items()}
        assert _port_specs(port_params.param_pspecs(cfg, pr)) == \
            _ref_specs(ref_params.param_pspecs(rcfg, rr))
    rr = ref_sharding.default_rules(rm, fsdp=False)
    pr = sharding.default_rules(pm, fsdp=False)
    assert steps._cache_pspecs(cfg, 128, 32768, pr) == {
        k: _ref_spec(v)
        for k, v in ref_steps._cache_pspecs(rcfg, 128, 32768, rr).items()}
    assert PT.cache_axes(cfg) == __import__(
        "repro.models.transformer", fromlist=["x"]).cache_axes(rcfg)
    for s in shapes.SHAPE_ORDER:
        if shapes.cell_skip_reason(cfg, shapes.SHAPES[s]):
            continue
        port = steps.build_cell(cfg, shapes.SHAPES[s], pm)
        ref = ref_steps.build_cell(rcfg, ref_shapes.SHAPES[s], rm)
        assert port.donate_argnums == ref.donate_argnums
        assert port.meta["kind"] == ref.meta["kind"]
        assert _port_specs(port.in_shardings) == \
            _ref_specs(ref.in_shardings), (arch, s)
        assert _port_specs(port.out_shardings) == \
            _ref_specs(ref.out_shardings), (arch, s)
        sharding.set_rules(None)
        ref_sharding.set_rules(None)


def test_spec_to_placements_rules():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _port_mesh("multi")
    assert sharding.spec_to_placements((("pod", "data"), None, "model"),
                                       mesh) == (Shard(0), Shard(0), Shard(2))
    assert sharding.spec_to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        sharding.spec_to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.spec_to_placements(("model",), mesh, (8,))
    rules = sharding.default_rules(mesh)
    # a dim the mapped axes do not divide is replicated (gemma3's 4 heads)
    assert sharding.logical_spec((4, 32), ("heads", "batch"), rules) == \
        (None, ("pod", "data"))
    assert sharding.named_sharding(rules, (32,), ("batch",)).spec == \
        (("pod", "data"),)


def test_constrain_is_the_identity_without_rules_or_on_plain_tensors():
    x = torch.ones(4, 8)
    assert sharding.constrain(x, "batch", None) is x
    sharding.set_rules(sharding.default_rules(_port_mesh("single")))
    assert sharding.constrain(x, "batch", None) is x


def test_parallel_exports_cover_the_reference():
    assert set(ref_parallel.__all__) <= set(port_parallel.__all__)
    assert all(hasattr(port_parallel, n) for n in port_parallel.__all__)


# -------------------------------------------------------------------- CLI

def test_dryrun_list_equals_the_reference():
    def run(mod):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-m", mod, "--list"], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        return res.stdout
    port = run("repro_torch.launch.dryrun")
    assert port == run("repro.launch.dryrun")
    assert len(port.splitlines()) == 42
