"""End-to-end fault-tolerant trainer (the reference's
``repro/launch/train.py``).

Examples (CPU, reduced scale):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-8b --scale reduced --steps 60 --batch 8 --seq 128 \\
      --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-8b --scale reduced --steps 60 --fault-steps 25,45

On the card (the default device), at full size:
  PYTHONPATH=src python -m repro_torch.launch.train --scale full \\
      --arch gemma3-1b

The data pipeline is deterministic by step, the optimizer updates the
state in place, and checkpoints are written async and atomically in the
reference's layout.  This trainer runs on one device; the same step
placed over a ``torch.distributed`` mesh (FSDP over ``data``, TP over
``model``) is ``launch/steps.py::build_train``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, list_archs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced
from repro_torch.models.params import init_params, param_count
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FaultInjector, train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--scale", default="reduced",
                    choices=("reduced", "full"))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fault-steps", default="",
                    help="comma-separated steps at which to inject failures")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=256,
                    help="reduced-scale width (256 -> ~15-100M params)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.scale == "reduced":
        cfg = reduced(cfg, layers=args.layers, d_model=args.d_model,
                      vocab=2048, d_ff=args.d_model * 4, heads=4)
        cfg = dataclasses.replace(cfg, remat="none")

    print(f"arch={cfg.name} family={cfg.family} params={param_count(cfg):,}")

    params = init_params(cfg, seed=args.seed, device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, warmup=10, total_steps=args.steps)
    opt = adamw_init(params)
    step_raw = T.make_train_step(cfg, opt_cfg, accum=args.accum,
                                 impl="naive")

    def step_fn(state, batch):
        params, opt = state
        tokens, labels = batch
        b = {"tokens": torch.as_tensor(tokens, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
        if cfg.vlm is not None:
            b["patches"] = torch.zeros(
                (tokens.shape[0], cfg.vlm.num_patches, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if cfg.family == "audio":
            b["frames"] = torch.zeros(
                (tokens.shape[0], cfg.encdec.enc_seq, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        params, opt, metrics = step_raw(params, opt, b)
        return (params, opt), metrics

    def make_pipeline(start_step: int):
        return TokenPipeline(args.seed, args.batch, args.seq, cfg.vocab,
                             start_step=start_step)

    ckpt = CheckpointManager(args.ckpt_dir, keep_last_k=2)
    injector = FaultInjector(
        [int(x) for x in args.fault_steps.split(",") if x.strip()])

    t0 = time.time()
    (params, opt), history = train_loop(
        step_fn, (params, opt), make_pipeline, ckpt,
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        injector=injector, log_every=10,
        on_metrics=lambda s, m: print(
            f"step {s:5d}  loss {m['loss']:.4f}  gnorm {m['grad_norm']:.3f}",
            flush=True))
    dt = time.time() - t0
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"\ndone: {args.steps} steps in {dt:.1f}s — "
              f"loss {first:.4f} -> {last:.4f}")
        if last >= first:
            print("WARNING: loss did not decrease")
    return 0


if __name__ == "__main__":
    sys.exit(main())
