"""Multi-pod dry run: every (arch x shape x mesh) cell, placed and run.

The reference's ``repro/launch/dryrun.py`` lowers and compiles each cell
for 512 placeholder host devices.  The port's counterpart of
"lower + compile" is running the step once:

  1. an in-process ``"fake"`` process group of world size 256 (the
     ``(16, 16)`` mesh) or 512 (``(2, 16, 16)``) backs the production
     mesh (``launch/mesh.py``); collectives on it move nothing.  A missing
     fake backend raises; nothing falls back;
  2. the cell's step comes from ``launch/steps.py``, its arguments are
     ``meta`` tensors placed as DTensors by ``shard_like`` (no memory: a
     72B tree is free);
  3. the step runs under ``launch/step_analysis.py``'s counter, which
     sees each device's local ops and collectives: success proves the
     placement is coherent (every op has a sharding rule or runs under an
     explicit ``local_map``), and the counts give per-device FLOPs, eager
     bytes, collective and DCN bytes;
  4. the record holds the memory of the local shards (argument, output
     and alias bytes, exact; the peak of live bytes the step allocated),
     analytic MODEL_FLOPS, and the roofline terms at the NVIDIA H100 SXM5
     80GB data sheet's rates (700 W), in
     ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

The GED cells run concretely on one device's share of the pairs, on
``--device`` (default the card), as the port's search loop reads its
termination on the host.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.flops import model_flops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (GED_SHAPES, SHAPE_ORDER, SHAPES,
                                       GedShapeSpec, cell_skip_reason)
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.launch.steps import build_cell, build_ged, placed_args
from repro_torch.models.params import tree_leaves
from repro_torch.parallel.sharding import is_distributed, set_rules

# NVIDIA H100 SXM5 80GB data sheet, 700 W (per device)
PEAK_FLOPS = 989.4e12        # bf16 dense FLOP/s, H100 SXM5
HBM_BW = 3.35e12             # bytes/s, H100 SXM5 HBM3
LINK_BW = 450e9              # bytes/s per direction, H100 SXM5 NVLink 4
DEVICE_BYTES = 80e9          # H100 SXM5 80GB

GED_CELLS = {"ged-verify": "verify_db", "ged-compute": "compute"}


def all_cells():
    cells = []
    for arch in sorted(ARCHS):
        for shape in SHAPE_ORDER:
            cells.append((arch, shape))
    for arch, shape in GED_CELLS.items():
        cells.append((arch, shape))
    return cells


def init_fake_group(world_size: int) -> None:
    """An in-process ``"fake"`` process group of ``world_size`` ranks (this
    process is rank 0).  The fake backend lives in torch's testing
    package; without it this raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _local_bytes(tree) -> int:
    total = 0
    for t in _leaves(tree):
        local = t.to_local() if is_distributed(t) else t
        total += local.numel() * local.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for _, leaf in tree_leaves(tree):
            yield from _leaves(leaf)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _memory(args, out, donate) -> Dict[str, Any]:
    donated = {id(t) for i in donate for t in _leaves(args[i])}
    alias = sum(_local_bytes(t) for t in _leaves(out) if id(t) in donated)
    return {"argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "alias_bytes": alias}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             force: bool = False, device=None, seed: int = 0,
             ged_spec: Optional[GedShapeSpec] = None) -> dict:
    """One cell's record (also written to ``out_dir``).  ``ged_spec``
    replaces a GED cell's shape (reduced runs)."""
    import torch.distributed as dist

    tag = f"{arch}__{shape_name}__{mesh_kind}"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        print(f"[skip-cached] {tag}: {rec.get('status')}")
        return rec

    multi = mesh_kind == "multi"
    n_chips = 512 if multi else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": n_chips, "status": "error"}
    t0 = time.time()
    try:
        init_fake_group(n_chips)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        if arch in GED_CELLS:
            from repro_torch.kernels.ops import (launch_counts,
                                                 reset_launch_counts)
            spec = ged_spec or GED_SHAPES[shape_name]
            plan = build_ged(spec, mesh, seed=seed, device=device)
            mf = None
            reset_launch_counts()
        else:
            cfg = get_arch(arch)
            sh = SHAPES[shape_name]
            skip = cell_skip_reason(cfg, sh)
            if skip:
                rec["status"] = "skipped"
                rec["reason"] = skip
                out_path.write_text(json.dumps(rec, indent=1))
                print(f"[skipped ] {tag}: {skip}")
                return rec
            plan = build_cell(cfg, sh, mesh)
            mf = model_flops(cfg, sh)
        args = placed_args(plan, mesh)
        t_build = time.time() - t0
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        costs, out = analyze_step(plan.fn, args, mesh, return_output=True)
        t_run = time.time() - t0 - t_build

        mem = _memory(args, out, plan.donate_argnums)
        mem["peak_live_step_bytes"] = costs.pop("peak_live_bytes")
        mem["peak_bytes_per_device"] = mem["argument_bytes"] \
            + mem["peak_live_step_bytes"]
        mem["f32_staging_bytes"] = costs["f32_staging_bytes"]
        mem["device_bytes"] = DEVICE_BYTES
        if plan.rules is None and str(plan.meta.get("device", "")) \
                .startswith("cuda"):
            mem["cuda_max_allocated_bytes"] = \
                torch.cuda.max_memory_allocated()
        rec["memory"] = mem
        rec["hlo"] = costs

        terms = {
            "compute_s": costs["flops"] / PEAK_FLOPS,
            "memory_s": costs["bytes_accessed"] / HBM_BW,
            "collective_s": costs["collective_bytes"] / LINK_BW,
        }
        terms["bottleneck"] = max(terms, key=lambda k: terms[k]
                                  if k.endswith("_s") else -1)
        rec["roofline"] = terms
        rec["roofline_device"] = ("NVIDIA H100 SXM5 80GB data sheet, 700 W: "
                                  f"{PEAK_FLOPS:.4g} bf16 FLOP/s, "
                                  f"{HBM_BW:.4g} B/s HBM3, "
                                  f"{LINK_BW:.4g} B/s NVLink per direction")
        if mf is not None:
            rec["model_flops"] = mf
            per_dev_model = mf["model_flops"] / n_chips
            rec["roofline"]["model_compute_s"] = per_dev_model / PEAK_FLOPS
            rec["roofline"]["useful_flops_ratio"] = (
                per_dev_model / costs["flops"] if costs["flops"] else 0.0)

        step_s = max(terms["compute_s"], terms["memory_s"],
                     terms["collective_s"])
        rec["roofline"]["step_time_lower_bound_s"] = step_s
        if mf is not None and step_s > 0:
            rec["roofline"]["mfu_upper_bound"] = (
                mf["model_flops"] / n_chips / PEAK_FLOPS) / step_s

        rec["timing"] = {"build_s": round(t_build, 2),
                         "run_s": round(t_run, 2)}
        rec["meta"] = {k: v for k, v in plan.meta.items()}
        if arch in GED_CELLS:
            rec["launches"] = launch_counts()
            rec["result"] = {k: v.detach().cpu().tolist()[:8]
                             for k, v in out.items()
                             if k in ("similar", "ged", "exact")}
            rec["n_pairs_run"] = int(args[0].shape[0])
        rec["status"] = "ok"
        print(f"[ok       ] {tag}: build {t_build:.1f}s run {t_run:.1f}s "
              f"bottleneck={terms['bottleneck']} "
              f"peak/dev={mem['peak_bytes_per_device'] / 2 ** 30:.2f}GiB")
    except Exception as e:          # record the failure — it is a bug
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL     ] {tag}: {rec['error']}")
    finally:
        set_rules(None)
        if dist.is_initialized():
            dist.destroy_process_group()

    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="arch id | 'all' | 'ged-verify' | 'ged-compute'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the GED cells (default: the card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the GED cells' pairs")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.list:
        for a, s in cells:
            print(f"{a:24s} {s}")
        return

    if args.arch != "all":
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape != "all":
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    n_ok = n_fail = 0
    for mesh_kind in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, mesh_kind, out_dir,
                           force=args.force, device=args.device,
                           seed=args.seed)
            if rec["status"] == "error":
                n_fail += 1
            else:
                n_ok += 1
    print(f"\ndry-run complete: {n_ok} ok/skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
