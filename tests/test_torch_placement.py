"""Multi-device placement of the port's train, prefill and decode steps
(``launch/steps.py`` over ``torch.distributed.tensor``), on the CPU.

* ``spec_to_placements`` gives every rank of a ``(2, 2, 2)`` mesh (an
  8-process ``gloo`` group) the offsets of the reference's
  ``NamedSharding(...).devices_indices_map`` (8 fake JAX devices).
* The train, prefill and decode cells of reduced qwen3-8b,
  qwen2-moe-a2.7b, rwkv6-3b and zamba2-7b run on ``meta`` tensors over a
  fake ``(2, 2, 2)`` group with ``flops > 0`` (they fail in the
  reference, R2).
* ``build_train`` on an 8-process ``gloo`` ``(2, 2, 2)`` group, two
  steps from the reference's weights, equals the port's one-process step
  with the same rules installed: loss within ``rtol=2e-4``, every
  parameter within ``1e-5 * max|w|`` (``tests/test_torch_train_step.py``'s
  tolerance); ``build_prefill`` / ``build_decode`` on the same group
  equal ``prefill_step`` / ``decode_step`` (f32 compute): logits within
  ``1e-5 * max|logits|``, caches within one bf16 step (``2**-7`` of
  their magnitude).
* With the ``(2, 2, 2)`` rules installed, ``moe_mlp`` at ``b = 8`` (four
  dispatch groups) equals the reference's under the same rules.
* A reduced GED cell of the dry run runs on ``device="cpu"``.

Every process group lives in a subprocess with a timeout of its own.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import params as ref_params
from repro.models.config import reduced as ref_reduced

from repro_torch.configs import get_arch
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as PT
from repro_torch.models.config import reduced
from repro_torch.models.params import (params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import DeviceMesh

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
JAX8 = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8")
MESH3 = ((2, 2, 2), ("pod", "data", "model"))


def _run(code, *args):
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout=600):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


def _port_mesh3():
    return DeviceMesh([[["cpu"] * 2] * 2] * 2, MESH3[1])


@pytest.fixture(autouse=True)
def _no_rules():
    yield
    sharding.set_rules(None)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every subprocess group of this file, started together (they are
    CPU-bound and independent); each test waits for its own group."""
    tmp = tmp_path_factory.mktemp("placement")
    groups = {}
    groups["offsets_jax"] = [subprocess.Popen(
        [sys.executable, "-c", OFFSETS_JAX], env=JAX8,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    groups["offsets"] = [_run(OFFSETS_RANK, r, tmp / "store_offsets")
                         for r in range(8)]
    groups["cells"] = [_run(CELLS, a) for a in REDUCED_ARCHS]
    inputs = _sharded_inputs(tmp)
    groups["sharded"] = [_run(SHARDED_RANK, r, tmp / "store_sharded",
                              tmp / "in.npz", tmp / "out.json",
                              json.dumps(SHARDED_ARCHS)) for r in range(8)]
    groups["moe"] = [subprocess.Popen(
        [sys.executable, "-c", MOE_REF, str(tmp / "moe.npz")], env=JAX8,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    groups["ged"] = [_run(GED_CELL, tmp)]
    yield {"tmp": tmp, "groups": groups, "inputs": inputs}
    for procs in groups.values():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()


# ------------------------------------------------------------ local offsets

SPECS = [(("pod", "data"), None, "model"), (None, "data", "model"),
         (("pod", "data", "model"), None, None), ("model", "pod", None),
         (None, None, None)]
SHAPE = (8, 4, 4)

OFFSETS_RANK = textwrap.dedent("""
    import json, sys, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import spec_to_placements
    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    specs = %r
    full = torch.arange(8 * 4 * 4).reshape(8, 4, 4)
    out = {"coord": mesh.get_coordinate(), "offsets": []}
    for spec in specs:
        pl = spec_to_placements(tuple(spec), mesh, full.shape)
        local = distribute_tensor(full, mesh, list(pl)).to_local()
        first = int(local.reshape(-1)[0])
        idx = [first // 16, (first // 4) %% 4, first %% 4]
        out["offsets"].append([[i, i + n] for i, n in zip(idx, local.shape)])
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out))
""") % (SPECS,)

OFFSETS_JAX = textwrap.dedent("""
    import json, jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    specs = %r
    out = {}
    for coord in [(a, b, c) for a in range(2) for b in range(2)
                  for c in range(2)]:
        dev = mesh.devices[coord]
        rows = []
        for spec in specs:
            m = NamedSharding(mesh, P(*spec)).devices_indices_map((8, 4, 4))
            rows.append([[s.start or 0, s.stop if s.stop is not None else n]
                         for s, n in zip(m[dev], (8, 4, 4))])
        out[str(list(coord))] = rows
    print(json.dumps(out))
""") % (SPECS,)


def test_local_offsets_equal_devices_indices_map(launched):
    (ref,) = _wait(launched["groups"]["offsets_jax"], 300)
    want = json.loads(ref.splitlines()[-1])
    outs = _wait(launched["groups"]["offsets"], 300)
    got = {}
    for o in outs:
        rec = json.loads(o.splitlines()[-1])
        got[str(list(rec["coord"]))] = rec["offsets"]
    assert got == want


# ------------------------------------------- reduced cells on a fake mesh

CELLS = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.launch.steps import build_cell, placed_args
    from repro_torch.models.config import reduced
    from repro_torch.parallel.sharding import set_rules
    init_fake_group(8)
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = reduced(get_arch(sys.argv[1]), layers=3, d_model=64, vocab=512,
                  d_ff=128, heads=4)
    cfg = dataclasses.replace(cfg, train_accum=2)
    out = {}
    for spec in (ShapeSpec("t", "train", 64, 8),
                 ShapeSpec("p", "prefill", 64, 8),
                 ShapeSpec("d", "decode", 64, 8)):
        plan = build_cell(cfg, spec, mesh)
        args = placed_args(plan, mesh)
        assert all(a.device_mesh is mesh for a in
                   [args[0]["embed"]]), "params are not placed"
        out[spec.kind] = analyze_step(plan.fn, args, mesh)
        set_rules(None)
    print(json.dumps(out))
""")
REDUCED_ARCHS = ["qwen3-8b", "qwen2-moe-a2.7b", "rwkv6-3b", "zamba2-7b"]


@pytest.fixture(scope="module")
def reduced_cells(launched):
    outs = _wait(launched["groups"]["cells"], 900)
    return {a: json.loads(o.splitlines()[-1])
            for a, o in zip(REDUCED_ARCHS, outs)}


@pytest.mark.parametrize("arch", REDUCED_ARCHS)
def test_build_cell_runs_multipod_reduced(reduced_cells, arch):
    """All three step kinds run on a (2, 2, 2) (pod, data, model) mesh."""
    for kind in ("train", "prefill", "decode"):
        a = reduced_cells[arch][kind]
        assert a["flops"] > 0, (arch, kind)
        assert not a["warnings"], a["warnings"]
    # the train step reduce-scatters / all-gathers over data (FSDP) and
    # sums gradients across pods
    train = reduced_cells[arch]["train"]
    assert train["collective_bytes"] > 0 and train["dcn_bytes"] > 0


# ------------------------------------- sharded against unsharded (gloo x 8)

def _cfg(name):
    cfg = reduced(get_arch(name), layers=3, d_model=64, vocab=512, d_ff=128,
                  heads=4)
    return dataclasses.replace(cfg, train_accum=2, remat="none",
                               compute_dtype="float32")


def _ref_cfg(name):
    cfg = ref_reduced(ref_arch(name), layers=3, d_model=64, vocab=512,
                      d_ff=128, heads=4)
    return dataclasses.replace(cfg, train_accum=2, remat="none",
                               compute_dtype="float32")


B, S = 8, 32
SHARDED_RANK = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import (build_decode, build_prefill,
                                          build_train, shard_like)
    from repro_torch.models.config import reduced
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import is_distributed, set_rules
    rank, store, inp, outp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    B, S = %d, %d

    def unflat(flat):
        tree = {}
        for path, arr in flat.items():
            node = tree
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(np.array(arr))
        return tree

    def full(t):
        return (t.full_tensor() if is_distributed(t) else t).detach().cpu()

    data = np.load(inp)
    results = {}
    for arch in json.loads(sys.argv[5]):
        cfg = reduced(get_arch(arch), layers=3, d_model=64, vocab=512,
                      d_ff=128, heads=4)
        cfg = dataclasses.replace(cfg, train_accum=2, remat="none",
                                  compute_dtype="float32")
        params = unflat({k[len(arch) + 3:]: data[k] for k in data.files
                         if k.startswith(arch + "/p/")})
        batches = [{k: torch.from_numpy(data[f"{arch}/b{i}/{k}"])
                    for k in ("tokens", "labels")} for i in range(2)]
        plan = build_train(cfg, ShapeSpec("t", "train", S, B), mesh)
        p, o = shard_like((params, adamw_init(params)),
                          plan.in_shardings[:2])
        losses = []
        for b in batches:
            bb = shard_like(b, plan.in_shardings[2])
            p, o, m = plan.fn(p, o, bb)
            losses.append(float(full(m["loss"])))
        res = {"losses": losses}
        res.update({"p/" + k: full(v).numpy().tolist()
                    for k, v in tree_leaves(p)})
        res.update({"m/" + k: full(v).numpy().tolist()
                    for k, v in tree_leaves(o["m"])})
        set_rules(None)
        # serving: bf16 weights, prefill then one decode step
        bf = tree_map(lambda t: t.to(torch.bfloat16), params)
        plan = build_prefill(cfg, ShapeSpec("p", "prefill", S, B), mesh)
        args = shard_like((bf, {"tokens": batches[0]["tokens"]}),
                          plan.in_shardings)
        logits, caches = plan.fn(*args)
        res["prefill_logits"] = full(logits).numpy().tolist()
        res.update({"prefill/" + k: full(v).float().numpy().tolist()
                    for k, v in caches.items()})
        set_rules(None)
        plan = build_decode(cfg, ShapeSpec("d", "decode", S, B), mesh)
        caches = {k: full(v) for k, v in caches.items()}
        args = shard_like((bf, caches, batches[1]["tokens"][:, :1],
                           plan.args[3]), plan.in_shardings)
        logits, caches = plan.fn(*args)
        res["decode_logits"] = full(logits).numpy().tolist()
        res.update({"decode/" + k: full(v).float().numpy().tolist()
                    for k, v in caches.items()})
        set_rules(None)
        results[arch] = res
    dist.barrier()
    if rank == 0:
        with open(outp, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()
""") % (B, S)
SHARDED_ARCHS = ["qwen3-8b", "qwen2-moe-a2.7b"]


def _ref_weights(name, seed):
    p = ref_params.init_params(_ref_cfg(name), seed=seed)
    return jax.tree.map(np.asarray, p)


def _sharded_inputs(tmp):
    """The reference's weights and two token batches per arch, saved for
    the ranks (``in.npz``) and kept for the one-process steps."""
    rng = np.random.default_rng(7)
    arrays, inputs = {}, {}
    for i, arch in enumerate(SHARDED_ARCHS):
        w = _ref_weights(arch, seed=i)
        inputs[arch] = {"params": w, "batches": []}
        for path, leaf in tree_leaves(w):
            arrays[f"{arch}/p/{path}"] = leaf
        for j in range(2):
            b = {k: rng.integers(0, 512, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
            inputs[arch]["batches"].append(b)
            for k, v in b.items():
                arrays[f"{arch}/b{j}/{k}"] = v
    np.savez(tmp / "in.npz", **arrays)
    return inputs


@pytest.fixture(scope="module")
def sharded_runs(launched):
    _wait(launched["groups"]["sharded"], 900)
    return (launched["inputs"],
            json.loads((launched["tmp"] / "out.json").read_text()))


def _unsharded(arch, inputs):
    """The port's one-process steps with the (2, 2, 2) rules installed."""
    cfg = _cfg(arch)
    sharding.set_rules(sharding.default_rules(_port_mesh3()))
    params = params_from_numpy(inputs["params"], device="cpu")
    opt = adamw_init(params)
    step = PT.make_train_step(cfg, AdamWConfig(), accum=2)
    losses = []
    for b in inputs["batches"]:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    sharding.set_rules(sharding.default_rules(_port_mesh3(), fsdp=False))
    bf = tree_map(lambda t: t.to(torch.bfloat16),
                  params_from_numpy(inputs["params"], device="cpu"))
    pl, pc = PT.prefill_step(bf, inputs["batches"][0]["tokens"], cfg)
    pc_copy = {k: v.clone() for k, v in pc.items()}
    dl, dc = PT.decode_step(bf, pc_copy,
                            inputs["batches"][1]["tokens"][:, :1], S - 1, cfg)
    sharding.set_rules(None)
    return losses, params, opt, (pl, pc), (dl, dc)


@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_train_step_equals_one_process(sharded_runs, arch):
    inputs, results = sharded_runs
    res = results[arch]
    losses, params, opt, _, _ = _unsharded(arch, inputs[arch])
    np.testing.assert_allclose(res["losses"], losses, rtol=2e-4)
    # tests/test_torch_train_step.py's rule: the first moments (linear in
    # the gradient) within 1e-5 of each leaf's largest; the parameters
    # within 1e-6 where the moment is well above the noise (AdamW moves
    # them by about lr * sign(g)), at most 0.1% moving otherwise
    want_p = dict(tree_leaves(params))
    flipped = total = 0
    for path, m in tree_leaves(opt["m"]):
        w = m.numpy()
        got_m = np.asarray(res["m/" + path], np.float32)
        np.testing.assert_allclose(got_m, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"{arch} m {path}")
        sure = np.abs(w) > 1e-4 * float(np.abs(w).max())
        got_p = np.asarray(res["p/" + path], np.float32)
        want = want_p[path].numpy()
        np.testing.assert_allclose(got_p[sure], want[sure], rtol=0,
                                   atol=1e-6, err_msg=f"{arch} {path}")
        flipped += int((np.abs(got_p - want) > 1e-6).sum())
        total += w.size
    assert flipped <= 1e-3 * total, (flipped, total)


@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_prefill_and_decode_equal_one_process(sharded_runs, arch):
    inputs, results = sharded_runs
    res = results[arch]
    _, _, _, (pl, pc), (dl, dc) = _unsharded(arch, inputs[arch])
    for name, want in (("prefill_logits", pl), ("decode_logits", dl)):
        want = want.numpy()
        np.testing.assert_allclose(
            np.asarray(res[name]), want, rtol=0,
            atol=1e-5 * float(np.abs(want).max()), err_msg=name)
    for prefix, caches in (("prefill/", pc), ("decode/", dc)):
        for k, v in caches.items():
            want = v.float().numpy()
            got = np.asarray(res[prefix + k], np.float32)
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=1e-6, err_msg=prefix + k)


# --------------------------------------------------------- MoE dispatch groups

MOE_REF = textwrap.dedent("""
    import dataclasses, sys
    import jax, numpy as np
    from repro.configs import get_arch
    from repro.models.config import reduced
    from repro.models import moe, params as P
    from repro.parallel.sharding import default_rules, set_rules
    cfg = reduced(get_arch("qwen2-moe-a2.7b"), layers=1, d_model=64,
                  vocab=512, d_ff=128, heads=4)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=1.0))
    from jax.sharding import AxisType
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     P.init_params(cfg, seed=3)["layers"]["moe"])
    x = np.random.default_rng(5).normal(size=(8, 16, 64)).astype(np.float32)
    set_rules(default_rules(mesh))
    with mesh:
        groups = moe._num_groups(8, 16)
        out = jax.jit(lambda x, p: moe.moe_mlp(x, p, cfg))(x, p)
    np.savez(sys.argv[1], out=np.asarray(out), x=x, groups=groups,
             **{"p/" + k: v for k, v in p.items()})
""")


def test_moe_groups_follow_the_rules(launched):
    _wait(launched["groups"]["moe"], 300)
    ref = np.load(launched["tmp"] / "moe.npz")
    cfg = reduced(get_arch("qwen2-moe-a2.7b"), layers=1, d_model=64,
                  vocab=512, d_ff=128, heads=4)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=1.0))
    p = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files
         if k.startswith("p/")}
    assert port_moe._num_groups(8, 16) == 1
    sharding.set_rules(sharding.default_rules(_port_mesh3()))
    assert port_moe._num_groups(8, 16) == int(ref["groups"]) == 4
    out = port_moe.moe_mlp(torch.from_numpy(ref["x"]), p, cfg)
    np.testing.assert_allclose(out.numpy(), ref["out"], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- GED cell

GED_CELL = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.shapes import GedShapeSpec
    spec = GedShapeSpec("verify_db", True, 4, 8, 32, 2, 16, 2)
    rec = run_cell("ged-verify", "verify_db", "single", Path(sys.argv[1]),
                   force=True, device="cpu", ged_spec=spec)
    print(json.dumps(rec))
""")


def test_reduced_ged_cell_runs_on_the_cpu(launched):
    (out,) = _wait(launched["groups"]["ged"], 300)
    tmp_path = launched["tmp"]
    rec = json.loads(out.splitlines()[-1])
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["n_pairs_run"] == 4
    assert rec["meta"]["pairs"] == 4 * 256
    assert rec["hlo"]["flops"] > 0 and rec["hlo"]["collective_bytes"] == 0
    assert rec["launches"]["reduced_top2"] == 0        # CPU: no kernel
    assert (tmp_path / "ged-verify__verify_db__single.json").exists()
