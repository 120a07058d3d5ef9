"""Serving launcher of the port: GED verification service or LM decode.

GED verification (the paper's workload; the default), on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode ged \\
      --pairs 200 --tau 9 --size 16

LM decode (reduced scale, random weights; any of the ten archs):
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
      --arch gemma3-1b --batch 4 --prompt-len 32 --max-new 16

``--device cpu`` runs either on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs import get_arch, list_archs


def serve_ged(args) -> None:
    from repro_torch.data.graphs import perturb, random_graph
    from repro_torch.serving import GedRequest, GedVerificationService

    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.pairs):
        q = random_graph(rng, args.size)
        g = perturb(rng, q, int(rng.integers(1, 12)))
        reqs.append(GedRequest(q, g, tau=args.tau))

    svc = GedVerificationService(batch_size=args.batch, device=args.device)
    t0 = time.time()
    results = svc.verify(reqs)
    dt = time.time() - t0
    n_sim = sum(1 for r in results if r.similar)
    n_cert = sum(1 for r in results if r.certified)
    print(f"verified {len(reqs)} pairs in {dt:.2f}s "
          f"({len(reqs)/dt:.1f} pairs/s) on {svc.engine.device}")
    print(f"similar: {n_sim}/{len(reqs)}   certified: {n_cert}/{len(reqs)}")
    print(f"service stats: {svc.stats}")


def serve_lm(args) -> None:
    import dataclasses
    from repro_torch.models.config import reduced
    from repro_torch.models.params import init_params, param_count
    from repro_torch.serving import generate

    cfg = reduced(get_arch(args.arch))
    cfg = dataclasses.replace(cfg, remat="none")
    print(f"arch={cfg.name} (reduced) params={param_count(cfg):,}")
    params = init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab,
                          size=(args.batch, args.prompt_len)).astype(np.int32)
    frames = patches = None
    if cfg.family == "audio":
        frames = np.zeros((args.batch, cfg.encdec.enc_seq, cfg.d_model),
                          np.float32)
    if cfg.vlm is not None:
        patches = np.zeros((args.batch, cfg.vlm.num_patches, cfg.d_model),
                           np.float32)
    t0 = time.time()
    out = generate(params, prompt, cfg, max_new=args.max_new,
                   frames=frames, patches=patches, impl="naive",
                   device=args.device)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"generated {out.shape} in {dt:.2f}s ({toks/dt:.1f} tok/s) on "
          f"{params['embed'].device}")
    print("sample:", out[0][:12])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="ged", choices=("ged", "lm"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the service (default: the card)")
    # ged
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--tau", type=float, default=9.0)
    ap.add_argument("--size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=64)
    # lm
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    if args.mode == "ged":
        serve_ged(args)
        return 0
    args.batch = min(args.batch, 8)
    serve_lm(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
