"""Serving launcher of the port: the GED verification service.

GED verification (the paper's workload; the default), on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode ged \\
      --pairs 200 --tau 9 --size 16

``--device cpu`` runs it on the CPU.  ``--mode lm`` (LM decode) belongs to
the LM substrate, which the port does not have yet (``ROADMAP.md``,
queue 1): it exits with status 2.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


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
    args = ap.parse_args(argv)
    if args.mode == "lm":
        print("--mode lm: LM decode is part of the LM substrate, which the "
              "port does not have yet (see ROADMAP.md, queue 1)",
              file=sys.stderr)
        return 2
    serve_ged(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
