#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to their twins.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --async-only    # build + the [async] phase only
    python3 chip_smoke.py --lm-only       # the [lm] phase only
    python3 chip_smoke.py --train-only    # the [train] phase only
    python3 chip_smoke.py --dryrun-only   # build + the [dryrun] phase only
    python3 chip_smoke.py --distributed-only  # build + [distributed] only
    python3 chip_smoke.py --distributed-only c  # ... group (c) alone
    python3 chip_smoke.py --distributed-only d  # ... group (d) alone

The environment variables ``REPRO_GED_SHARED_CACHE_DIR``,
``REPRO_GED_COMPILE_CACHE_DIR`` and ``REPRO_GED_FAULT_INJECT`` are cleared
at start, and every timed engine runs with ``cache=False``, so the main
and ``"auto"`` numbers time real work.  The engine stats of every phase
but ``[faults]`` must carry no robustness counter (``retries``,
``fault_*``, ``degraded_*``, ``timed_out_pairs``), so a failed kernel
cannot hide behind the degradation ladder.  Phases (each failure raises;
nothing falls back to the CPU):

1. device line: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. every kernel against its plain PyTorch twin on the card, at the main
   path's shape (256 pairs x expand 8 = 2048 states, N = 32, Le = 3), on an
   edgeless batch (Le = 0), at N = 64, at N = 16 (the slot bucket of the
   ``[store]`` phase's small graphs) and at the ``"auto"`` path's rung-0
   shapes (512 x 32, 128 x 64): ``torch.equal``, kernel and twin times
   (CUDA events, and device time from ``torch.profiler``), the
   memory/compute bound; for ``lsa_children`` and ``bma_cost_matrix`` at
   every one of those shapes, also the time of the whole
   ``bounds.lsa_children`` / ``bounds.bma_cost_matrix`` call that builds
   their operands, and ``lsa_children``'s bound on the reference's
   ``a_ju`` operand beside the one on its own;
4. the main path: 256 AIDS-like pairs through ``GedEngine("cuda")`` and
   ``GedEngine("torch")`` (``compute`` and ``verify(tau=4)``, the second
   escalation rung's pool/expand/max_iters), outcomes compared field by
   field, launch counts read around the first ``"cuda"`` run, the wall
   times of ``REPEATS`` runs of each backend (median, min, max), 16 pairs
   re-run on the CPU, launches per iteration from ``torch.profiler``;
5. ``merge_ranks`` against its twin at 256 pairs and every escalation
   rung's (pool - expand, expand x slots) shape at N = 32 and 64, on
   sorted, unsorted and tied/+inf/3e8 runs (``torch.equal``), timed at each
   shape beside its bound and the two ``torch.searchsorted`` calls it
   replaces; on a batch whose rows mix sorted runs (signed zeros, +inf/3e8
   tails), unsorted runs and NaN-tailed runs (timed at rung 1, N = 32);
   and with one run of 20,000 keys, longer than the kernel stages in
   shared memory; ``reduced_top2`` at N = 16, 32 and 64 (B = 2048) and at
   the ``"auto"`` path's rung-0 state counts (512 x 32, 128 x 64), timed
   beside ``torch.topk``, and untimed at N = 1, 2, 31, 33, 128 and 300,
   each also from a misaligned (offset) buffer;
6. ``autotune.tune()`` on the card at the shapes the ``"auto"`` path meets,
   into a temporary tuning table;
7. the ``"auto"`` path: 256 AIDS-like pairs plus 64 pairs at n 40-60 (slot
   bucket 64) through ``GedEngine("auto", use_kernel="auto")`` on that
   table (``compute`` and ``verify(tau=4)``): survivors per rung, host
   solves, loop iterations and the resolved ``KernelDispatch`` of every
   dispatch, launch counts, pairs/s over ``AUTO_REPEATS`` runs; then the
   same mix with every family fused (launch counts read around it; every
   kernel must launch), held field by field to the tuned run, to the
   unfused run and, on 16 pairs, to the CPU;
8. ``[async]``, the search loop as CUDA graph replays, off the caller's
   thread: on the main cell's 256 pairs (all four kernels fused) the
   graph loop against the eager chunked loop at chunk lengths 1, 2, 4
   and 8 in both modes (every output ``torch.equal``; the eager, first
   (capturing) and cached graph walls; host flag reads; launches per
   chunk equal, so replays are counted); host ops, launches, device us
   and busy share per step of the graph loop beside the eager loop under
   ``torch.profiler``; the wall from ``run_packed_async`` to its return
   against the wall to ``result()``; ``"auto"`` on the 320-pair mix all
   fused, with its graphs cached, with overlap on and off (outcomes
   equal, ``overlap_saved_s`` > 0, the peak memory with the graph cache
   in use); its ``compute`` wall at chunk lengths 1 and 8 (first and
   cached) and on the eager loop at chunk lengths 1 and 2 (outcomes equal
   the graph's); and the main cell's ``"cuda"`` engine on the eager loop,
   its pairs/s beside ``[main]``'s, with the planning both pay;
9. ``[cache]``, the result cache in front of the engine: the main cell's
   pairs twice on ``GedEngine("cuda", cache=True)`` (256 misses that
   launch the kernels, then 256 hits with no launch and no executor call,
   equal to the misses and to the uncached run; then ``verify`` misses
   every pair), wall seconds and pairs/s of both calls and the time spent
   digesting; in-batch duplicates (256 + 64 repeats, 256 run); the
   ``"auto"`` mix all fused (the miss launches all four kernels, the
   repeat none and no dispatch); ``submit``/``flush`` in ticket order;
   vertex-permuted copies (``digest="wl"`` hits, ``"exact"`` misses); the
   shared tier filled by a child process (``--shared-cache-child``) and
   read here with 256 hits and no launch; and ``compile_cache_dir``, two
   child processes (``--compile-cache-child``) of which the first runs
   nvcc and the second loads its library;
10. ``[faults]``, the anytime deadline contract and the degradation ladder:
   ``deadline_s=3600`` on the main cell's ``"cuda"`` run and the
   all-fused ``"auto"`` mix (outcomes and launch counts equal the runs
   without a deadline); ``deadline_s=0`` on ``"auto"`` (every answer
   timed out with bounds that bracket the certified GED, no dispatch, no
   launch); a mid-run deadline, a quarter of ``[auto]``'s median
   ``compute`` wall, at ``max_in_flight`` 4 and 1 (certified answers equal
   the clean run, the rest bracket it; the overshoot past the deadline,
   whose clock starts once the call has planned its pairs, beside the
   whole call's wall);
   a transient ``dispatch`` fault (one retry, equal answers); a permanent
   ``kernel`` fault on 32 pairs (no launch, every pair host-solved,
   certified and equal; the host solver's seconds per pair); ``result``
   and ``host`` faults (sound answers); and the caches (a ``lock`` fault
   fails open, a timed-out call caches nothing, ``flush(deadline_s=0)``
   answers every ticket timed out, in order);
11. ``[store]``, the corpus layer at the size of the AIDS antiviral
    screen database: 42,687 AIDS-like graphs (62 vertex labels, 3 edge
    labels, n in [10, 40]; seed 8), 16 of them queries with three
    ``perturb(q, k)`` near-duplicates each, k in [1, 3], in two
    ``GraphStore`` objects on the card (the reference bench's options,
    ``cache=False``): every kernel family fused, and ``use_kernel=False``.
    The ingest wall split into vocab, pack and dedup; the signature
    build's wall and device time (equal to the store's signatures and to
    ``wl_signature``); ``search_batch`` at tau 2 and 4 on both stores:
    queries/s, the funnel per stage, the share of candidates that survives
    stage -1 and the wall per stage; launch counts around the fused
    store's passes (every kernel must launch); fused hits equal to
    unfused hits field by field; every planted near-duplicate within tau
    found, every hit certified, the funnel summing to the candidates;
    ``verify_members`` on the planted ids agreeing with the range hits;
    ``save`` and a warm ``GraphStore.open`` (nothing re-packed or
    re-hashed, identical hits, ``open_wall_s`` beside ``ingest_wall_s``);
    and a 2,000-graph sub-store (n in [8, 14], four queries with seven
    near-duplicates each) whose ``range_search(tau=2)`` and ``top_k(4)``
    hits on the card equal the same store's on the CPU;
12. ``[serving]``, the GED services: ``GedVerificationService(
    use_kernel=True)`` on the main cell's 256 pairs as requests at tau 4
    (every answer certified, equal field by field to a direct
    ``GedEngine("auto")`` with the service's options and in verdict to
    ``[main]``'s ``"cuda"`` run; requests/s; ``reduced_top2``,
    ``bma_cost_matrix`` and ``lsa_children`` must launch); the same
    requests again (all result-cache hits, no launch, no dispatch);
    ``deadline_s=3600`` requests (answers unchanged); ``register_corpus``
    with the 2,000-graph sub-store (in-corpus targets counted by
    ``store_candidates``, verdicts equal the direct engine's); a held
    admission budget (``Overloaded``, ``health()``'s ``shed``);
    ``GedSimilarityService`` on the sub-store (``range_search``,
    ``top_k`` and ``search`` equal the sub-store's hits); and
    ``python -m repro_torch.launch.serve --mode ged`` in a child process
    (``certified: 100/100``);
13. ``[sharded]``, multi-device placement: ``GedEngine("sharded")`` on
    every visible card (one card: ``batch_multiple`` 1 and the fast
    path; outcomes equal ``[main]``'s ``"torch"``), ``"auto"`` on
    ``mesh=["cuda:0", "cuda:0"]`` all fused on the 320-pair mix (two
    shards a batch; all four kernels launch; outcomes equal ``[auto]``'s
    all-fused run; timed in turns with the one-device run: mesh, one
    device, one device, mesh; on a machine with several cards also one
    shard per card, timed beside it), and ``GraphStore(mesh=["cuda:0",
    "cuda:0"])`` on the sub-store (buckets and batches multiples of 2,
    signatures byte-equal, hits equal the single-device store's), each
    wall beside the single-device one;
14. ``[lm]``, the LM serving path (no TPU kernel lies on it: the
    reference's ``models/flash.py``, ``moe.py`` and ``ssm.py`` are pure
    JAX): qwen3-8b (36 layers, d 4096, about 8.19 B parameters, 32.8 GB
    in f32) and qwen2-moe-a2.7b (24 layers, d 2048, 64 experts of which
    60 route, top-4, 4 shared; 15.15 B parameters, 60.6 GB in f32) at
    full width and depth, one after the other, each from
    ``init_params(device="cuda")`` and freed before the next;
    ``generate`` on 4 prompts of 32 tokens for 16 new ones in bf16
    compute, then its loop again with each span ended by a synchronize
    (prefill ms, decode ms per token, tokens/s; the tokens equal
    ``generate``'s), launches and device-busy share per decode step from
    ``torch.profiler``, the MoE prefill's dropped assignments, the peak
    memory, and at f32 compute on the same weights (drop-free MoE
    capacity) the prefill and decode logits against the full forward's
    (``tests/test_archs.py``'s tolerance; every cache row against the
    forward's K/V, and the decode step against the forward whose
    attention reads the cache rows the step read);
    one qwen3-8b layer's prefill
    at S = 2048 with ``impl="flash"`` against ``"naive"`` (f32 and bf16);
    gemma3-1b at full size on a 600-token prompt, which wraps its 512-slot
    rings (the same consistency check, and ``generate``); rwkv6-3b,
    zamba2-7b and whisper-large-v3 at full size (whisper's 1500 frames
    from the seed): one ``generate`` each, the same consistency check
    (zamba2's shared block and whisper's self and cross caches), and the
    prefill's final SSM states against the states after the same tokens
    decoded one at a time; and reduced configs of every family (a
    ``kv_quant`` qwen3-8b, qwen2-moe-a2.7b at a capacity that drops, a
    constructed pure-mamba2 stack among them) on the card against the
    port on the CPU with the same weights at f32 (logits and caches,
    ``generate``'s tokens equal);
15. ``[train]``, LM training (no TPU kernel lies on it either: the
    reference's ``optim/``, ``models/flash.py``'s custom VJP, ``moe.py``
    and ``ssm.py`` are plain JAX): gemma3-1b at full width and depth
    (792.9 M parameters, 12.69 GB of f32 params, grads and AdamW
    moments), random weights from a seed, B = 8, S = 512, bf16 compute,
    ``impl="naive"``, ``remat="full"``: 8 steps through
    ``make_train_step`` and ``train_loop`` with the loss logged each
    step (step ms, tokens/s, peak memory), one blocking
    ``CheckpointManager.save`` of the whole state (params and moments,
    9.51 GB; the loop's last step) and one ``restore`` compared leaf by
    leaf bit for bit, and one step under ``torch.profiler`` (launches,
    device ms, busy share), then its loss-and-gradients and its
    ``adamw_update`` apart; qwen3-8b at full width with 8 of its 36
    layers (16 bytes a parameter is 131 GB at full depth; 8 layers are
    44.6 GB), 3 steps; one qwen3-8b
    layer at S = 2048, f32, every gradient through the flash backward
    against autograd through the naive attention; reduced qwen3-8b
    through ``train_loop`` clean and with faults at steps 4 and 8,
    losses and parameters bit-equal; one step of every arch's reduced
    config on the card against the CPU (``TRAIN_TOL``); and
    ``python -m repro_torch.launch.train`` (no ``--device``) at reduced
    scale in a child process;
16. ``[dryrun]``, the launch layer's placement and dry run: on a one-rank
    NCCL group (a ``file://`` store) and a ``(1, 1, 1)`` ``("pod",
    "data", "model")`` mesh on ``cuda:0``, ``launch.steps.build_train``
    for gemma3-1b at full size (``[train]``'s B = 8, S = 512, seed and
    token batches, 3 steps, ``impl="naive"``) against the unsharded
    ``make_train_step`` (losses and every parameter: bit equality, or the
    largest difference against ``TRAIN_TOL``), and ``build_prefill`` /
    ``build_decode`` for qwen3-8b at full width (bf16 weights, B = 8,
    S = 512) against ``prefill_step`` / ``decode_step``, with step ms and
    peak memory; with two or more cards, gemma3-1b's losses on a
    ``("data", "model")`` mesh of one NCCL process per card against the
    one-card run (unverified on a one-card machine); and
    ``python -m repro_torch.launch.dryrun`` in child processes (started
    after the kernel checks, so they run on the host beside phases 4-15)
    on qwen3-8b ``train_4k`` (both meshes), qwen2-moe-a2.7b
    ``decode_32k`` and rwkv6-3b ``long_500k`` (abstract, on a fake
    process group of 256 or 512 ranks; qwen2-72b ``train_4k`` takes
    longer than the script's limit and runs alone), and ``ged-verify``
    (concrete on the card, launching ``reduced_top2``): each record's status,
    per-device FLOPs, useful-FLOPs ratio, collective and DCN bytes, peak
    bytes per device against 80 GB, bottleneck and wall;
17. ``[distributed]``, ``GedEngine(mesh=)`` and ``GraphStore(mesh=)`` on
    ``torch.distributed`` meshes from ``repro_torch.launch.mesh``, each
    rank a child process (``--distributed-rank-child``, so no process
    group is made beside
    ``[dryrun]``'s): (a) two ``gloo`` ranks sharing ``cuda:0`` on a
    ``(2, 1)`` ``("data", "model")`` mesh, ``"sharded"`` on the main
    path's 256 pairs and ``"auto"`` with every kernel fused on the
    320-pair mix, each rank's outcomes equal to ``[main]``'s ``"torch"``
    and ``[auto]``'s all-fused run field by field, each rank's launch
    counts (set to 0 after a warm-up run, read after the timed one) above
    0 for all four kernels, per-rank walls, planning seconds and the
    gather's ms a batch; (b) one NCCL rank on a ``(1, 1, 1)`` ``("pod",
    "data", "model")`` mesh: ``"sharded"`` takes the fast path (no
    gather), outcomes equal ``[main]``'s, and the 2,000-graph sub-store
    of ``[store]`` ingested on the mesh (fast path, no gather; its
    ``range_search(tau=2)`` and ``top_k(4)`` hits equal ``[store]``'s);
    (c) with several cards, one NCCL rank a card, both paths (not run on
    one card); (d) ``GraphStore(mesh=)`` on two ``gloo`` ranks sharing
    ``cuda:0`` on a ``(2, 1)`` ``("data", "model")`` mesh: ``[store]``'s
    fused 42,687-graph snapshot opened on the mesh (each rank holds
    ``ceil(rows / 2)`` rows of every stage-0 bucket) and searched at tau
    2 and 4 (each rank's hits equal ``[store]``'s fused hits field by
    field; every kernel launches on each rank; per-rank queries/s, stage
    walls and the stage-0 gathers' ms), then the sub-store ingested on
    the mesh (signatures byte-equal to ``[store]``'s; hits equal), saved,
    given graphs that are then removed, saved again and reopened on both
    ranks (the first rank alone calls the writers, the directory holds
    one generation, the reopened store's hits equal ``[store]``'s), and
    ``register_corpus`` on a ``GedVerificationService`` over the mesh
    (verdicts on the planted near-duplicates equal the sub-store's
    hits); under ``--distributed-only`` the fused store and the
    sub-store are first built, searched and saved here; a failed rank
    fails the script;
18. a ``{"kernels": [...]}`` JSON line (launches of the all-fused
    ``"auto"`` run, the fused store's, the services', the mesh
    ``"auto"`` run's, the ``ged-verify`` dry-run cell's and groups (a)'s
    and (d)'s ranks' in ``[distributed]``), the card's
    name and power limit, and as the last line ``{"ok": true, "device":
    {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
PAIRS, EXPAND, POOL, MAX_ITERS, TAU = 256, 8, 1024, 512, 4.0
CPU_PAIRS = 16
REPEATS = 3          # timed runs of each backend on the main path
AUTO_REPEATS = 3     # timed runs of the "auto" path
BIG_PAIRS = 64       # pairs at n 40-60 (slot bucket 64) in the "auto" mix
# the escalation rungs' (pool, expand, max_iters), as in runtime/scheduler.py
RUNGS = ((256, 4, 128), (1024, 8, 512), (4096, 8, 2048))
# NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth and f32 (non-tensor) rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
KERNELS = {
    "reduced_top2": "src/repro/kernels/reduced_top2.py:38",
    "bma_cost_matrix": "src/repro/kernels/bma_cost_matrix.py:69",
    "lsa_children": "src/repro/kernels/lsa_children.py:102",
    "merge_ranks": "src/repro/kernels/merge_topk.py:48",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data

def aids_pairs(rng, count, n_lo, n_hi):
    """AIDS-like pairs (62 vertex labels, 3 edge labels), each graph with a
    ``perturb(., k)`` partner, k in [1, 6]; returns (pairs, ks)."""
    from repro_torch.data.graphs import aids_like_graph, perturb
    pairs, ks = [], []
    for _ in range(count):
        g = aids_like_graph(rng, int(rng.integers(n_lo, n_hi + 1)),
                            n_vlabels=62, n_elabels=3)
        k = int(rng.integers(1, 7))
        pairs.append((g, perturb(rng, g, k, n_vlabels=62, n_elabels=3)))
        ks.append(k)
    return pairs, ks


def edgeless_pairs(rng, count, n_lo, n_hi):
    """Pairs of edgeless graphs (``n_elabels == 0`` once packed) that differ
    in up to three vertex labels."""
    from repro_torch.data.graphs import random_graph
    out = []
    for _ in range(count):
        g = random_graph(rng, int(rng.integers(n_lo, n_hi + 1)), density=0.0,
                         n_vlabels=8, n_elabels=1)
        h = g.copy()
        h.vlabels[:3] = rng.integers(0, 8, size=3)
        out.append((g, h))
    return out


def engine_states(pairs, slots, rng, device, expand=EXPAND):
    """Random search states (``expand`` per pair) on packed pairs, built
    with the engine's own ``make_pair_consts`` and ``state_masks``."""
    import torch
    from repro_torch.core.engine import bounds as eb
    from repro_torch.core.engine.tensor_graphs import pack_pairs, to_device
    packed = pack_pairs(pairs, slots=slots)
    dp = to_device(packed, device)
    pc = eb.make_pair_consts(*dp).unsqueeze(1)
    img = np.full((len(pairs), expand, slots), -1, np.int32)
    level = np.zeros((len(pairs), expand), np.int32)
    for p, n in enumerate(packed.n):
        for e in range(expand):
            level[p, e] = rng.integers(0, n)
            img[p, e, : level[p, e]] = rng.permutation(n)[: level[p, e]]
    img_t = torch.as_tensor(img, device=device)
    level_t = torch.as_tensor(level, device=device)
    g_cost = torch.as_tensor(rng.integers(0, 9, level.shape) * 0.5,
                             dtype=torch.float32, device=device)
    return pc, eb.state_masks(pc, img_t, level_t), level_t, g_cost


# --------------------------------------------------------------- timing

def cuda_ms(fn, reps: int = 20, groups: int = 5) -> float:
    """Median over ``groups`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 3):
    """Device time per call: the summed durations of every CUDA kernel
    ``fn`` launches, from ``torch.profiler`` over ``reps`` calls (host
    gaps between launches excluded).  None if the profiler saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def check_kernel(name, kernel, twin, args, out_like, ops, library=None,
                 timed=True):
    """Hold one kernel to its twin; returns a row of measurements."""
    import torch
    got = kernel(*args)
    torch.cuda.synchronize()
    want = twin(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: kernel differs from its twin at "
                                 f"{bad}")
        # equal infinities count as no error (inf - inf is NaN)
        diff = torch.where(g == w, 0.0, (g.double() - w.double()).abs())
        err = max(err, float(diff.max()) if g.numel() else 0.0)
    row = {"equal": True, "max_abs_err": err,
           "out_shape": [list(g.shape) for g in got]}
    if timed:
        moved = nbytes(*args) + nbytes(*out_like)
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        for key, fn in (("kernel", lambda: kernel(*args)),
                        ("plain", lambda: twin(*args)),
                        ("library", library)):
            if fn is None:
                row[key + "_ms"] = row[key + "_device_ms"] = None
                continue
            reps = 5 if key == "plain" else 20
            # "_ms": CUDA events around back-to-back calls (host launch
            # gaps included); "_device_ms": the kernels' own durations
            row[key + "_ms"] = cuda_ms(fn, reps=reps)
            row[key + "_device_ms"] = device_ms(fn, reps=reps)
        row.update(bound_us=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=moved, ops=ops)
    return row


def engine_call_ms(fn):
    """Event and device time of one whole engine call (operand building
    and the kernel): {"engine_ms", "engine_device_ms"}."""
    return {"engine_ms": cuda_ms(fn, reps=10),
            "engine_device_ms": device_ms(fn, reps=10)}


def kernel_checks(pairs, slots, rng, device, timed, expand=EXPAND,
                  top2_timed=None):
    """All three kernels on engine states of ``pairs`` at ``slots``.  When
    ``timed``, ``lsa_children`` and ``bma_cost_matrix`` are timed alone and
    as the whole ``bounds`` call that builds their operands
    (``use_kernel=True``); ``reduced_top2`` when ``top2_timed`` (default:
    ``timed``)."""
    import torch
    from repro_torch.core.engine import auction as auc
    from repro_torch.core.engine import bounds as eb
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    pc, sm, level, g_cost = engine_states(pairs, slots, rng, device, expand)
    rows = {}

    flat, _ = eb.lsa_kernel_operands(pc, sm, level, g_cost)
    b, n = flat[0].shape
    le = flat[2].shape[-1]
    rows["lsa_children"] = check_kernel(
        "lsa_children", kops.lsa_children, ref.lsa_children_ref, flat,
        [flat[0]], ops=b * n * (6 * le + 4 * n + 5), timed=timed)
    if timed:
        # the bound on the reference's 13 operands, with a (B, N, N) int32
        # a_ju in place of the pair's ga and the state's img_cl: 6 (B, N),
        # 3 (B, N, Le) and 3 (B, Le) 4-byte operands in, (B, N) f32 out
        rows["lsa_children"]["bound_us_a_ju_operands"] = (
            4 * b * (7 * n + 3 * n * le + 3 * le + n * n)
            / PEAK_BYTES_PER_S * 1e6)
        rows["lsa_children"].update(engine_call_ms(
            lambda: eb.lsa_children(pc, sm, level, g_cost, use_kernel=True)))

    flat, _ = eb.bma_kernel_operands(pc, sm)
    lam_like = torch.empty((b, n, n), device=device)
    # per element: the histogram terms (2 Le + 6) and the anchor count from
    # label bit planes, per 32 positions one XOR/OR per plane, an AND with
    # the anchor mask and a popcount
    rows["bma_cost_matrix"] = check_kernel(
        "bma_cost_matrix", kops.bma_cost_matrix, ref.bma_cost_matrix_ref,
        flat, [lam_like],
        ops=b * n * n * (2 * le + 6 + -(-n // 32) * (int(le).bit_length() + 2)),
        timed=timed)
    if timed:
        rows["bma_cost_matrix"].update(engine_call_ms(
            lambda: eb.bma_cost_matrix(pc, sm, use_kernel=True)))

    lam = eb.bma_cost_matrix(pc, sm, use_kernel=True).reshape(-1, n, n)
    prices = auc.run_auction(lam, 8).prices.contiguous()
    red = lam + prices[:, None, :]
    vec = torch.empty((b, n), device=device)
    rows["reduced_top2"] = check_kernel(
        "reduced_top2", kops.reduced_top2, ref.reduced_top2_ref,
        [lam, prices], [vec, vec, vec], ops=3 * b * n * n,
        library=lambda: torch.topk(red, 2, dim=-1, largest=False),
        timed=timed if top2_timed is None else top2_timed)
    return rows


def merge_keys(b, na, nb, kind, device, seed):
    """Merge-rank runs: key-sorted, unsorted, or tied with +inf, the
    engine's INF = 3e8 and signed zeros mixed in."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randint(0, 4 * (na + nb), (b, na), generator=g).float()
    k = torch.randint(0, 4 * (na + nb), (b, nb), generator=g).float()
    if kind == "sorted":
        a, k = a.sort(1).values, k.sort(1).values
    elif kind == "ties":
        a[:, ::2], k[:, ::2] = 7.0, 7.0
        a[:, 1::5], k[:, 1::5] = float("inf"), float("inf")
        a[:, 3::7], k[:, 3::7] = 3.0e8, 3.0e8
        a[:, 4::9], k[:, 4::9] = -0.0, 0.0
    return a.to(device), k.to(device)


def merge_checks(device):
    """``merge_ranks`` against its twin at every rung's shape, N = 32 and
    64, 256 pairs; timed on sorted runs.  Returns {(rung, n): row}."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    rows = {}
    for rung, (pool, expand, _) in enumerate(RUNGS):
        for n in (32, 64):
            na, nb = pool - expand, expand * n
            for kind in ("unsorted", "ties", "sorted"):
                a, b = merge_keys(PAIRS, na, nb, kind, device,
                                  seed=rung * 100 + n)
                timed = kind == "sorted"
                row = check_kernel(
                    "merge_ranks", kops.merge_ranks, ref.merge_ranks_ref,
                    [a, b], [a, b], ops=PAIRS * (na + nb),
                    library=lambda a=a, b=b: (
                        torch.searchsorted(b, a, side="left"),
                        torch.searchsorted(a, b, side="right")),
                    timed=timed)
                if timed:
                    rows[(rung, n)] = row
                log(f"[kernel] merge_ranks rung={rung} N={n} B={PAIRS} "
                    f"NA={na} NB={nb} {kind}: " + json.dumps(
                        {k: v for k, v in row.items()
                         if k not in ("bytes", "ops")}))
    return rows


def mixed_merge_keys(b, na, nb, device, seed):
    """Merge-rank runs whose rows mix kinds, by row index mod 6: both
    sorted; both unsorted; sorted with signed zeros in either order and
    +inf/3e8 tails; only keys_a sorted; only keys_b sorted; sorted with a
    NaN tail (a NaN makes a run unsorted for the kernel)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    pool = torch.tensor([-1.0, -0.0, 0.0, 1.0, 2.0, 5.0, 3.0e8,
                         float("inf")])
    a = torch.randint(0, 4 * (na + nb), (b, na), generator=g).float()
    k = torch.randint(0, 4 * (na + nb), (b, nb), generator=g).float()
    a[2::6] = pool[torch.randint(0, len(pool), (len(a[2::6]), na),
                                 generator=g)]
    k[2::6] = pool[torch.randint(0, len(pool), (len(k[2::6]), nb),
                                 generator=g)]
    sa, sk = a.sort(1).values, k.sort(1).values
    kind = torch.arange(b) % 6
    a = torch.where((kind != 1)[:, None] & (kind != 4)[:, None], sa, a)
    k = torch.where((kind != 1)[:, None] & (kind != 3)[:, None], sk, k)
    if na:
        a[5::6, -1] = float("nan")
    if nb:
        k[5::6, -1] = float("nan")
    return a.to(device), k.to(device)


def merge_extra_checks(device):
    """``merge_ranks`` on mixed rows at rung 1, N = 32 (timed), and with
    one run of 20,000 keys (beyond what the kernel stages in shared
    memory), on sorted, unsorted and mixed rows.  Returns the largest
    ``max_abs_err``."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    pool, expand, _ = RUNGS[1]
    na, nb = pool - expand, expand * 32
    a, b = mixed_merge_keys(PAIRS, na, nb, device, seed=1)
    row = check_kernel(
        "merge_ranks", kops.merge_ranks, ref.merge_ranks_ref, [a, b], [a, b],
        ops=PAIRS * (na + nb), library=lambda: (
            torch.searchsorted(b, a, side="left"),
            torch.searchsorted(a, b, side="right")), timed=True)
    log(f"[kernel] merge_ranks rung=1 N=32 B={PAIRS} NA={na} NB={nb} mixed: "
        + json.dumps({k: v for k, v in row.items()
                      if k not in ("bytes", "ops")}))
    err = row["max_abs_err"]
    for na, nb in ((20000, 256), (256, 20000)):
        for kind in ("sorted", "unsorted", "mixed"):
            if kind == "mixed":
                a, b = mixed_merge_keys(12, na, nb, device, seed=2)
            else:
                a, b = merge_keys(12, na, nb, kind, device, seed=3)
            r = check_kernel("merge_ranks", kops.merge_ranks,
                             ref.merge_ranks_ref, [a, b], [a, b], ops=0,
                             timed=False)
            err = max(err, r["max_abs_err"])
            log(f"[kernel] merge_ranks B=12 NA={na} NB={nb} {kind}: "
                f"equal={r['equal']}")
    return err


# reduced_top2 shapes timed beside the main check: N = 16, 32, 64 at the
# main path's 2048 states, and the "auto" path's rung-0 state counts
TOP2_SHAPES = ((2048, 16), (2048, 32), (2048, 64), (512, 32), (128, 64))


def top2_inputs(b, n, device, seed, offset=0):
    """Auction-like reduced costs: half-integer costs full of ties, a grid
    of 1e7 entries, all-+inf rows, half-integer prices.  With ``offset``
    the cost and prices start ``offset`` floats into a buffer, so they are
    not 16-byte aligned."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    cost = torch.randint(0, 6, (b, n, n), generator=g).float() * 0.5
    cost[:, ::7, ::3] = 1.0e7
    cost[::5, 0, :] = float("inf")
    prices = torch.randint(0, 4, (b, n), generator=g).float() * 0.5
    out = []
    for x in (cost, prices):
        buf = torch.empty(x.numel() + offset, device=device)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        out.append(view)
    return out


def top2_checks(device):
    """``reduced_top2`` against its twin at ``TOP2_SHAPES`` (timed beside
    ``torch.topk``) and at odd widths, aligned and offset (untimed).
    Returns the largest ``max_abs_err``."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    err = 0.0
    for b, n in TOP2_SHAPES:
        cost, prices = top2_inputs(b, n, device, seed=b + n)
        red = cost + prices[:, None, :]
        vec = torch.empty((b, n), device=device)
        row = check_kernel(
            "reduced_top2", kops.reduced_top2, ref.reduced_top2_ref,
            [cost, prices], [vec, vec, vec], ops=3 * b * n * n,
            library=lambda red=red: torch.topk(red, 2, dim=-1,
                                               largest=False),
            timed=True)
        err = max(err, row["max_abs_err"])
        log(f"[kernel] reduced_top2 B={b} N={n}: " + json.dumps(
            {k: v for k, v in row.items() if k not in ("bytes", "ops")}))
    for n in (1, 2, 31, 33, 128, 300):
        for offset in (0, 1):
            cost, prices = top2_inputs(37, n, device, seed=n, offset=offset)
            r = check_kernel("reduced_top2", kops.reduced_top2,
                             ref.reduced_top2_ref, [cost, prices], [], ops=0,
                             timed=False)
            err = max(err, r["max_abs_err"])
            log(f"[kernel] reduced_top2 B=37 N={n} offset={offset}: "
                f"equal={r['equal']}")
    return err


def tune_phase(tune_dir, device):
    """The card's first tuning rows: lsa/bma at N = 32, 64 and B = pairs x
    expand of each rung, merge at (pool, expand x slots) of each rung."""
    from repro_torch.kernels import autotune
    autotune.enable_autotune(tune_dir)
    t0 = time.perf_counter()
    entries = autotune.tune(
        ns=(32, 64), bs=sorted({PAIRS * e for _, e, _ in RUNGS}),
        kernels=("lsa", "bma"),
        merge_shapes=[(pool, expand * n) for pool, expand, _ in RUNGS
                      for n in (32, 64)],
        device=device)
    for e in entries:
        log("[tune] " + json.dumps({k: e[k] for k in (
            "kernel", "N", "B", "impl", "fused_us", "unfused_us",
            "device_kind")}))
    log(f"[tune] {len(entries)} entries in {time.perf_counter() - t0:.1f} s "
        f"-> {tune_dir}")
    return entries


class DispatchTrace:
    """Per dispatch of one engine: rung, bucket shape, the resolved
    ``KernelDispatch`` and the loop iterations the batch ran.  Wraps the
    engine executor's ``run_packed_async`` and the module's
    ``resolve_config`` while in use."""

    def __init__(self, eng):
        from repro_torch.kernels import autotune
        self.eng, self.autotune, self.rows = eng, autotune, []

    def __enter__(self):
        ex = self.eng._backend.executor
        self._run, self._resolve = ex.run_packed_async, \
            self.autotune.resolve_config
        resolved = []

        def resolve(cfg, slots, batch, device=None):
            out = self._resolve(cfg, slots, batch, device)
            resolved.append(out.dispatch)
            return out

        def run(packed, taus, cfg, verification, real=None, **kw):
            pending = self._run(packed, taus, cfg, verification, real=real,
                                **kw)
            out = pending.result()
            d = resolved.pop() if resolved else None
            self.rows.append({
                "rung": [r[0] for r in RUNGS].index(cfg.pool),
                "slots": packed.slots, "batch": packed.batch, "real": real,
                "loop_iterations": int(out["iterations"].max()),
                "dispatch": None if d is None else {
                    k: v for k, v in vars(d).items() if k.endswith("fused")}})
            return pending

        self.autotune.resolve_config = resolve
        ex.run_packed_async = run
        return self

    def __exit__(self, *exc):
        self.autotune.resolve_config = self._resolve
        del self.eng._backend.executor.run_packed_async


def auto_run(pairs, vocab, device, trace=False, faults_on=False,
             **options):
    """One ``"auto"`` engine over the mix: (compute, verify, stats, wall
    seconds of each, dispatch rows).  Unless ``faults_on``, its stats
    must carry no robustness counter."""
    import torch
    from repro_torch.ged import GedEngine
    eng = GedEngine("auto", device=device, vocab=vocab, cache=False,
                    **options)
    with (DispatchTrace(eng) if trace else contextlib.nullcontext()) as tr:
        t0 = time.perf_counter()
        comp = eng.compute(pairs)
        if device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ver = eng.verify(pairs, tau=TAU)
        if device == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
    if not faults_on:
        no_fault_keys("auto", eng.stats)
    return comp, ver, eng.stats, t1 - t0, t2 - t1, tr.rows if tr else None


def auto_phase(pairs, ks, tune_dir):
    """The "auto" path on the card; returns (summary, launches of the
    all-fused run, the tuned run's ``compute`` outcomes)."""
    from repro_torch.core.engine.tensor_graphs import label_vocab
    from repro_torch.ged import KernelDispatch
    from repro_torch.kernels import ops as kops
    vocab = label_vocab(pairs)
    opts = dict(use_kernel="auto", autotune_dir=tune_dir)

    kops.reset_launch_counts()
    comp, ver, stats, tc, tv, rows = auto_run(pairs, vocab, "cuda",
                                              trace=True, **opts)
    tuned_launches = kops.launch_counts()
    keep = ("pairs", "escalated", "host_solved", "batches", "dispatches",
            "overlap_saved_s", "autotune_hits", "autotune_misses")
    log("[auto] tuned stats: " + json.dumps(
        {k: v for k, v in sorted(stats.items())
         if k in keep or k.startswith("survivors_rung_")}))
    for r in rows:
        log("[auto] dispatch: " + json.dumps(r))
    log(f"[auto] tuned launches: {json.dumps(tuned_launches)}")
    times_c, times_v = [tc], [tv]
    for _ in range(AUTO_REPEATS - 1):
        _, _, _, t_c, t_v, _ = auto_run(pairs, vocab, "cuda", **opts)
        times_c.append(t_c)
        times_v.append(t_v)
    per_rung = {}
    for r in rows:
        per_rung[r["rung"]] = max(per_rung.get(r["rung"], 0),
                                  r["loop_iterations"])
    summ = {
        "pairs": len(pairs), "runs": len(times_c),
        "compute_pairs_per_s": len(pairs) / statistics.median(times_c),
        "compute_s_median_min_max": [statistics.median(times_c),
                                     min(times_c), max(times_c)],
        "verify_pairs_per_s": len(pairs) / statistics.median(times_v),
        "verify_s_median_min_max": [statistics.median(times_v),
                                    min(times_v), max(times_v)],
        "loop_iterations_per_rung": per_rung,
        "host_solved": stats["host_solved"],
        "dispatches": stats["dispatches"],
        "survivors": {k: v for k, v in stats.items()
                      if k.startswith("survivors_rung_")},
    }
    log("[auto] summary: " + json.dumps(summ))

    # every family fused: the merge kernel is on the path whatever the
    # table chose; counts read around this run only
    fused = KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=True)
    kops.reset_launch_counts()
    comp_f, ver_f, _, tcf, tvf, _ = auto_run(pairs, vocab, "cuda",
                                             dispatch=fused)
    launches = kops.launch_counts()
    log(f"[auto] all-fused launches: {json.dumps(launches)} "
        f"({tcf:.3f} s compute, {tvf:.3f} s verify)")
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"kernels never launched on the auto path: {missing}"
    comp_u, ver_u, _, tcu, tvu, _ = auto_run(pairs, vocab, "cuda",
                                             use_kernel=False)
    log(f"[auto] unfused: {tcu:.3f} s compute, {tvu:.3f} s verify")
    for name, (c, v) in {"all-fused": (comp_f, ver_f),
                         "unfused": (comp_u, ver_u)}.items():
        diff = [i for i, (a, b) in enumerate(zip(comp + ver, c + v))
                if not same_outcome(a, b)]
        assert not diff, f"auto outcomes differ from {name} at {diff[:10]}"
    log("[auto] tuned == all-fused == unfused on every outcome field")
    summ["all_fused_s"] = [tcf, tvf]

    assert all(o.certified for o in comp + ver), "uncertified auto answer"
    for o, k in zip(comp, ks):
        assert o.lower_bound <= o.ged <= k, (o, k)
    for o, k in zip(ver, ks):
        if o.similar:
            assert o.lower_bound == 0.0 and o.upper_bound <= TAU, (o, k)
        else:               # a proven rejection: TAU < ged <= k
            assert o.lower_bound > TAU and k > TAU, (o, k)
    log("[auto] every answer certified; every ged <= k")

    t0 = time.perf_counter()
    comp_p, ver_p, _, _, _, _ = auto_run(pairs[:CPU_PAIRS], vocab, "cpu")
    diff = [i for i, (a, b) in enumerate(zip(
        comp_p + ver_p, comp[:CPU_PAIRS] + ver[:CPU_PAIRS]))
        if not same_outcome(a, b)]
    assert not diff, f"CPU and card auto outcomes differ at {diff}"
    log(f"[auto] {CPU_PAIRS} pairs on the CPU agree with the card "
        f"({time.perf_counter() - t0:.1f} s)")
    return summ, launches, comp, ver


# ------------------------------------------------------------ main path

# robustness counters: present only once a fault, a retry or an expired
# deadline happened, so no phase but [faults] may show one
FAULT_KEY_PREFIXES = ("retries", "fault_", "degraded_", "timed_out_pairs")


def no_fault_keys(tag, stats):
    """A broken kernel must not hide behind the degradation ladder: the
    engine ``stats`` of every phase but ``[faults]`` carry no robustness
    counter (the ``executor_`` copies included)."""
    bad = [k for k in stats
           if k.removeprefix("executor_").startswith(FAULT_KEY_PREFIXES)]
    assert not bad, f"[{tag}] engine stats carry fault counters: {bad}"

def same_outcome(a, b) -> bool:
    if (a.ged, a.similar, a.certified, a.lower_bound, a.upper_bound, a.tau,
            a.stats) != (b.ged, b.similar, b.certified, b.lower_bound,
                         b.upper_bound, b.tau, b.stats):
        return False
    if a.mapping is None or b.mapping is None:
        return a.mapping is None and b.mapping is None
    return bool(np.array_equal(a.mapping, b.mapping))


def run_engine(backend, pairs, device, vocab, faults_on=False,
               engine_out=None, **overrides):
    """``compute`` then ``verify(tau=TAU)`` on one uncached engine at the
    main cell's rung-1 config: (compute, verify, wall seconds of each).
    Unless ``faults_on``, its stats must carry no robustness counter;
    ``engine_out`` (a list) receives the engine."""
    import torch
    from repro_torch.ged import GedEngine
    cfg = dict(pool=POOL, expand=EXPAND, max_iters=MAX_ITERS)
    cfg.update(overrides)
    eng = GedEngine(backend, device=device, vocab=vocab, cache=False, **cfg)
    t0 = time.perf_counter()
    comp = eng.compute(pairs)
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    ver = eng.verify(pairs, tau=TAU)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not faults_on:
        no_fault_keys(backend, eng.stats)
    if engine_out is not None:
        engine_out.append(eng)
    return comp, ver, t1 - t0, t2 - t1


def summarize(tag, comp, ver, t_comps, t_vers):
    """The main path's row for one backend; times are the median (and
    min, max) of the timed runs."""
    its_c = max(o.stats["iterations"] for o in comp)
    its_v = max(o.stats["iterations"] for o in ver)
    t_comp, t_ver = statistics.median(t_comps), statistics.median(t_vers)
    row = {
        "runs": len(t_comps),
        "compute_s": t_comp, "verify_s": t_ver,
        "compute_s_min_max": [min(t_comps), max(t_comps)],
        "verify_s_min_max": [min(t_vers), max(t_vers)],
        "compute_pairs_per_s": len(comp) / t_comp,
        "verify_pairs_per_s": len(ver) / t_ver,
        "compute_certified": float(np.mean([o.certified for o in comp])),
        "verify_certified": float(np.mean([o.certified for o in ver])),
        "compute_mean_iterations": float(np.mean(
            [o.stats["iterations"] for o in comp])),
        "verify_mean_iterations": float(np.mean(
            [o.stats["iterations"] for o in ver])),
        "compute_loop_iterations": its_c, "verify_loop_iterations": its_v,
        "compute_iters_per_s": its_c / t_comp,
        "verify_iters_per_s": its_v / t_ver,
    }
    log(f"[main] {tag}: " + json.dumps(row))
    return row


def profile_launches(backend, pairs, vocab, iters: int = 16):
    """CUDA launches per search iteration, device busy share and the
    kernels that take the device time, from ``torch.profiler`` over a
    short run of ``backend``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.ged import GedEngine
    eng = GedEngine(backend, device="cuda", vocab=vocab, cache=False,
                    pool=POOL, expand=EXPAND, max_iters=iters)
    eng.compute(pairs)                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = eng.compute(pairs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    no_fault_keys("profile", eng.stats)
    loops = max(o.stats["iterations"] for o in outs)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"launches_per_iter": "not measured",
                "device_busy_share": "not measured"}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    host_ops = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.cpu_parent is None]
    by_name = {}
    for e in kernels:
        cnt, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"profiled_iterations": loops, "profiled_wall_s": wall,
            "launches_per_iter": len(kernels) / loops,
            "host_ops_per_iter": len(host_ops) / loops,
            "device_us_per_iter": busy_us / loops,
            "wall_us_per_iter": wall * 1e6 / loops,
            "device_busy_share": busy_us * 1e-6 / wall,
            "top_kernels_by_device_time": [
                [name[:60], cnt / loops, us / loops]
                for name, (cnt, us) in top]}


# ------------------------------------------------------- asynchronous loop

ASYNC_CHUNKS = (1, 2, 4, 8)  # chunk lengths held to the eager loop and timed
ASYNC_PROFILE_ITERS = 16      # max_iters of the profiled graph and eager runs


def graph_chunks(cfg, chunk, iterations):
    """Chunks the graph loop runs on a batch whose last pair ends after
    ``iterations`` steps: up to the first chunk whose flag reads done, and
    the one enqueued behind it, within ``max_iters``."""
    k = max(1, min(chunk, cfg.max_iters))
    return min(-(-cfg.max_iters // k), -(-max(iterations, 1) // k) + 1)


def loop_diff(before, after):
    return {k: after[k] - before[k] for k in after}


def profile_loop(run, args, steps):
    """Host ops, launches, device us and busy share per executed step of
    ``run(*args)`` (warm: a graph is already captured), from
    ``torch.profiler`` on this thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host_ops = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.cpu_parent is None]
    if not kernels:
        return {"steps": steps, "wall_us_per_step": wall * 1e6 / steps,
                "launches_per_step": "not measured",
                "device_busy_share": "not measured"}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return {"steps": steps, "wall_us_per_step": wall * 1e6 / steps,
            "host_ops_per_step": len(host_ops) / steps,
            "launches_per_step": len(kernels) / steps,
            "device_us_per_step": busy_us / steps,
            "device_busy_share": busy_us * 1e-6 / wall}


def async_phase(pairs, vocab, auto_pairs, auto_vocab, auto_comp, auto_ver,
                main_summ, auto_summ, smi):
    """``[async]``: the graph loop against the eager chunked loop, the
    asynchronous dispatch and ``"auto"``'s overlap on the card (module
    docstring, phase 8).  ``main_summ`` / ``auto_summ`` are ``[main]``'s
    ``"cuda"`` row and ``[auto]``'s summary.  Returns the phase's
    summary."""
    import functools
    import torch
    from repro_torch.core.engine import api as engine_api
    from repro_torch.core.engine import search
    from repro_torch.core.engine.search import EngineConfig
    from repro_torch.core.engine.tensor_graphs import pack_pairs, to_device
    from repro_torch.ged import KernelDispatch
    from repro_torch.ged.exec import Executor
    from repro_torch.kernels import ops as kops
    t_phase = time.perf_counter()
    summ = {"chunk": search.CHUNK, "device": smi}
    fused = KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=True)
    cfg = EngineConfig(pool=POOL, expand=EXPAND, max_iters=MAX_ITERS,
                       dispatch=fused)
    packed = pack_pairs(pairs, slots=32, vocab=vocab)
    dp = to_device(packed, "cuda")
    taus = torch.full((len(pairs),), TAU, device="cuda")

    # 1. graph == eager chunked, every output, both modes, every chunk
    # length; times of each (the graph's second run replays a cached
    # graph); launches per chunk equal
    rows = {}
    for verification in (False, True):
        mode = "verify" if verification else "compute"
        for k in ASYNC_CHUNKS:
            kops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = search.run_eager(dp, taus, cfg, verification, chunk=k)
            torch.cuda.synchronize()
            t_eager = time.perf_counter() - t0
            eager_launches = kops.launch_counts()
            t0 = time.perf_counter()
            first = search.run_graphed(dp, taus, cfg, verification, chunk=k)
            t_first = time.perf_counter() - t0
            kops.reset_launch_counts()
            before = search.loop_counts()
            t0 = time.perf_counter()
            got = search.run_graphed(dp, taus, cfg, verification, chunk=k)
            t_graph = time.perf_counter() - t0
            loops = loop_diff(before, search.loop_counts())
            graph_launches = kops.launch_counts()
            for out in (first, got):
                bad = [key for key in want
                       if not torch.equal(out[key], want[key])]
                assert not bad, f"[async] graph != eager ({mode}, k={k}): {bad}"
            iters = int(want["iterations"].max())
            eager_chunks = -(-iters // max(1, min(k, MAX_ITERS)))
            chunks = graph_chunks(cfg, k, iters)
            assert loops["replays"] == chunks and loops["captures"] == 0, \
                (loops, chunks)
            assert loops["flag_reads"] <= -(-iters // k) + 1, (loops, iters)
            for name in KERNELS:
                assert graph_launches[name] * eager_chunks == \
                    eager_launches[name] * chunks, \
                    (name, graph_launches, eager_launches, chunks)
            assert all(v > 0 for v in graph_launches.values()), graph_launches
            if not verification and k == ASYNC_CHUNKS[0]:
                main_compute = want
            rows[f"{mode}_k{k}"] = {
                "loop_iterations": iters, "graph_chunks": chunks,
                "flag_reads": loops["flag_reads"],
                "eager_s": t_eager, "graph_first_s": t_first,
                "graph_s": t_graph, "graph_launches": graph_launches}
            log(f"[async] {mode} k={k}: graph == eager chunked on every "
                f"output; " + json.dumps(rows[f"{mode}_k{k}"]) + f" ({smi})")
    summ["loops"] = rows

    # 2. host ops, launches, device us and busy share per step: graph
    # beside eager, the same batch and chunk length, on this thread
    pcfg = dataclasses.replace(cfg, max_iters=ASYNC_PROFILE_ITERS)
    k = search.CHUNK
    probe = search.run_eager(dp, taus, pcfg, False, chunk=k)
    iters = int(probe["iterations"].max())
    prof = {
        "graph": profile_loop(
            functools.partial(search.run_graphed, chunk=k),
            (dp, taus, pcfg, False), graph_chunks(pcfg, k, iters) * k),
        "eager": profile_loop(
            functools.partial(search.run_eager, chunk=k),
            (dp, taus, pcfg, False), -(-iters // k) * k)}
    summ["profile"] = prof
    for name, row in prof.items():
        log(f"[async] profile {name} loop (k={k}, max_iters="
            f"{ASYNC_PROFILE_ITERS}, {iters} loop iterations): "
            + json.dumps(row) + f" ({smi})")

    # 3. the dispatch returns before the batch ends
    ex = Executor(device="cuda")
    for attempt in range(2):             # the second replays a cached graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = ex.run_packed_async(packed, np.full(len(pairs), TAU),
                                      cfg, False)
        t_return = time.perf_counter() - t0
        ready_at_return = pending.ready()
        out = pending.result()
        t_result = time.perf_counter() - t0
    assert t_return < t_result and not ready_at_return, \
        (t_return, t_result, ready_at_return)
    for key, want_t in main_compute.items():
        assert np.array_equal(out[key], want_t.cpu().numpy()), key
    summ["dispatch"] = {"return_s": t_return, "result_s": t_result,
                        "ready_at_return": ready_at_return}
    log(f"[async] run_packed_async returned after {t_return:.6f} s "
        f"(ready: {ready_at_return}); result() after {t_result:.6f} s "
        f"({smi})")

    # 4. "auto" on the mix all fused (a first run captures the mix's
    # graphs): overlap on and off, timed with the graphs cached, and the
    # peak memory with the cache in use
    auto_on = functools.partial(auto_run, auto_pairs, auto_vocab, "cuda",
                                dispatch=fused)
    before = search.loop_counts()
    _, _, _, t_cap_c, t_cap_v, _ = auto_on()
    captured = loop_diff(before, search.loop_counts())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = search.loop_counts()
    comp_on, ver_on, st_on, tc_on, tv_on, _ = auto_on()
    loops = loop_diff(before, search.loop_counts())
    peak = torch.cuda.max_memory_allocated()
    comp_off, ver_off, st_off, tc_off, tv_off, _ = auto_on(overlap=False)
    expect_same("[async] auto overlap on vs off", comp_on + ver_on,
                comp_off + ver_off)
    expect_same("[async] auto vs [auto]'s tuned run", comp_on + ver_on,
                auto_comp + auto_ver)
    assert st_on["overlap_saved_s"] > 0, st_on
    summ["auto"] = {
        "overlap_saved_s": st_on["overlap_saved_s"],
        "overlap_off_saved_s": st_off["overlap_saved_s"],
        "capturing_run_s": [t_cap_c, t_cap_v],
        "captures": captured["captures"],
        "compute_s": tc_on, "verify_s": tv_on,
        "compute_s_overlap_off": tc_off, "verify_s_overlap_off": tv_off,
        "compute_pairs_per_s": len(auto_pairs) / tc_on,
        "verify_pairs_per_s": len(auto_pairs) / tv_on,
        "dispatches": st_on["dispatches"], "batches_run": loops["batches"],
        "captures_when_cached": loops["captures"],
        "flag_reads_per_batch": loops["flag_reads"] / max(loops["batches"], 1),
        "peak_allocated_bytes": peak, "graphs_cached": len(search.GRAPHS)}
    log("[async] auto all fused: overlap on == off on every outcome field; "
        + json.dumps(summ["auto"]) + f" ({smi})")

    # 5. "auto" at each chunk length (compute; a first run captures), and
    # on the eager loop at two chunk lengths (outcomes equal the graph's)
    real = engine_api.run_batch
    sweep = {}
    try:
        for k in (ASYNC_CHUNKS[0], ASYNC_CHUNKS[-1]):
            engine_api.run_batch = functools.partial(search.run_graphed,
                                                     chunk=k)
            _, _, _, t_first, _, _ = auto_on()
            _, _, _, t_c, _, _ = auto_on()
            sweep[f"k{k}"] = {"first_compute_s": t_first, "compute_s": t_c}
        for k in (1, 2):
            engine_api.run_batch = functools.partial(search.run_eager,
                                                     chunk=k)
            c, v, _, t_c, t_v, _ = auto_on()
            expect_same(f"[async] auto eager k={k} vs graph", c + v,
                        comp_on + ver_on)
            sweep[f"eager_k{k}"] = {"compute_s": t_c, "verify_s": t_v}
    finally:
        engine_api.run_batch = real
    summ["auto_chunks"] = sweep
    log("[async] auto compute s by chunk length (graph: first, cached; "
        "eager outcomes == graph outcomes): " + json.dumps(sweep)
        + f" ({smi})")

    # 6. the main cell's "cuda" engine on the eager loop beside [main]'s
    # graph loop, and the planning both pay
    engine_api.run_batch = search.run_eager
    try:
        _, _, t_c, t_v = run_engine("cuda", pairs, "cuda", vocab)
    finally:
        engine_api.run_batch = real
    from repro_torch.ged import build_plan
    t0 = time.perf_counter()
    build_plan(pairs, vocab=vocab)
    plan_s = time.perf_counter() - t0
    summ["main_pairs_per_s"] = {
        "graph_compute": main_summ["compute_pairs_per_s"],
        "graph_verify": main_summ["verify_pairs_per_s"],
        "eager_compute": len(pairs) / t_c, "eager_verify": len(pairs) / t_v,
        "planning_s": plan_s}
    summ["auto_pairs_per_s"] = {
        "graph_compute": auto_summ["compute_pairs_per_s"],
        "graph_verify": auto_summ["verify_pairs_per_s"]}
    log("[async] pairs/s: " + json.dumps(
        {"main": summ["main_pairs_per_s"], "auto": summ["auto_pairs_per_s"]})
        + f" ({smi})")
    summ["phase_s"] = time.perf_counter() - t_phase
    log(f"[async] phase {summ['phase_s']:.1f} s ({smi})")
    return summ


# ---------------------------------------------------------- result cache

CACHE_ENV_VARS = ("REPRO_GED_SHARED_CACHE_DIR", "REPRO_GED_COMPILE_CACHE_DIR",
                  "REPRO_GED_FAULT_INJECT")
DUPLICATES = 64      # repeats of the first pairs in the in-batch check
ISOMORPHS = 64       # pairs re-sent as vertex-permuted copies


def cached_engine(vocab, **options):
    """A ``"cuda"`` engine on the main cell's rung-1 config, cache on."""
    from repro_torch.ged import GedEngine
    return GedEngine("cuda", device="cuda", vocab=vocab, cache=True,
                     pool=POOL, expand=EXPAND, max_iters=MAX_ITERS,
                     **options)


def timed(fn):
    """(result, wall seconds) of ``fn()``, ended by a device sync."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def uncached(o):
    """``o`` with the ``"cached"`` flag its stats gained on a hit taken
    out, after checking that it is there."""
    assert o.stats.get("cached") is True, o.stats
    stats = dict(o.stats)
    del stats["cached"]
    return dataclasses.replace(o, stats=stats)


def expect_same(tag, got, want):
    diff = [i for i, (a, b) in enumerate(zip(got, want))
            if not same_outcome(a, b)]
    assert len(got) == len(want) and not diff, f"{tag}: differ at {diff[:10]}"


def permuted(rng, g):
    """An isomorphic copy of ``g``: vertex ``i`` is old vertex ``perm[i]``."""
    from repro_torch.core.exact.graph import Graph
    perm = rng.permutation(g.n)
    return Graph(g.vlabels[perm], g.adj[np.ix_(perm, perm)])


def child(args):
    """Run this script in a child process on the card; its last stdout
    line, parsed as JSON."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), *args],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, (f"child {args[0]} exited "
                                 f"{res.returncode}:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def shared_cache_child(directory) -> int:
    """Child of check 6: the main cell's pairs on ``"cuda"`` with the
    shared tier in ``directory``; prints every outcome's scalars."""
    from repro_torch.core.engine.tensor_graphs import label_vocab
    pairs, _ = aids_pairs(np.random.default_rng(SEED), PAIRS, 20, 30)
    eng = cached_engine(label_vocab(pairs), shared_cache_dir=directory)
    outs = eng.compute(pairs)
    stats = eng.stats
    assert stats["shared_cache_misses"] == PAIRS, stats
    assert stats["shared_cache_entries"] == PAIRS, stats
    no_fault_keys("cache", stats)
    print(json.dumps({"scalars": [
        [o.ged, o.lower_bound, o.upper_bound, o.certified, o.similar]
        for o in outs]}))
    return 0


def compile_cache_child(directory) -> int:
    """Child of check 7: build and load the kernel library into
    ``directory`` (``compile_cache_dir``), hold ``reduced_top2`` to its
    twin, print the ``persistent_cache_*`` counters."""
    from repro_torch.ged import GedEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    eng = GedEngine("cuda", device="cuda", compile_cache_dir=directory)
    assert _build.library_path().parent == Path(directory)
    cost, prices = top2_inputs(PAIRS * EXPAND, 32, "cuda", seed=11)
    check_kernel("reduced_top2", kops.reduced_top2, ref.reduced_top2_ref,
                 [cost, prices], [], ops=0, timed=False)
    print(json.dumps({k: v for k, v in eng.stats.items()
                      if k.startswith("persistent_cache_")}))
    return 0


def cache_phase(pairs, vocab, comp_c, ver_c, auto_pairs, auto_vocab,
                auto_comp, smi):
    """The result cache in front of the engine on the card: seven checks,
    each fatal.  ``comp_c`` / ``ver_c`` are the main path's uncached
    ``"cuda"`` outcomes on ``pairs``, ``auto_comp`` the ``"auto"`` path's
    on ``auto_pairs``.  Returns the phase's summary."""
    from repro_torch.ged import GedEngine, KernelDispatch
    from repro_torch.ged.exec import pair_key
    from repro_torch.kernels import ops as kops
    three = ("reduced_top2", "bma_cost_matrix", "lsa_children")

    # 1. repeats: 256 misses that launch the kernels, then 256 hits that
    # launch nothing, equal to the misses and to the uncached run
    eng = cached_engine(vocab)
    kops.reset_launch_counts()
    miss, t_miss = timed(lambda: eng.compute(pairs))
    miss_launches = kops.launch_counts()
    stats = eng.stats
    assert stats["result_cache_misses"] == PAIRS, stats
    assert all(miss_launches[k] > 0 for k in three), miss_launches
    calls = stats["executor_calls"]
    kops.reset_launch_counts()
    hit, t_hit = timed(lambda: eng.compute(pairs))
    hit_launches = kops.launch_counts()
    stats = eng.stats
    assert stats["result_cache_hits"] == PAIRS, stats
    assert stats["executor_calls"] == calls, stats
    assert set(hit_launches.values()) == {0}, hit_launches
    expect_same("[cache] hit vs miss", [uncached(o) for o in hit], miss)
    expect_same("[cache] miss vs cache=False", miss, comp_c)
    t0 = time.perf_counter()
    for q, g in pairs:
        pair_key(q, g, False, None, eng.config, eng.backend)
    t_digest = time.perf_counter() - t0
    ver = eng.verify(pairs, tau=TAU)
    stats = eng.stats
    assert stats["result_cache_misses"] == 2 * PAIRS, stats
    assert stats["result_cache_hits"] == PAIRS, stats
    no_fault_keys("cache", stats)
    expect_same("[cache] verify vs cache=False", ver, ver_c)
    summ = {"miss_s": t_miss, "hit_s": t_hit,
            "miss_pairs_per_s": PAIRS / t_miss,
            "hit_pairs_per_s": PAIRS / t_hit,
            "digest_s": t_digest, "digest_share_of_miss": t_digest / t_miss,
            "miss_launches": miss_launches, "hit_launches": hit_launches}
    log("[cache] repeats: " + json.dumps(summ) + f" ({smi})")

    # 2. in-batch duplicates run once and answer twice
    eng = cached_engine(vocab)
    outs = eng.compute(pairs + pairs[:DUPLICATES])
    stats = eng.stats
    assert (stats["result_cache_misses"], stats["result_cache_hits"],
            stats["executor_pairs"]) == (PAIRS, DUPLICATES, PAIRS), stats
    no_fault_keys("cache", stats)
    expect_same("[cache] duplicates", outs[:PAIRS], comp_c)
    expect_same("[cache] duplicates", [uncached(o) for o in outs[PAIRS:]],
                outs[:DUPLICATES])
    log(f"[cache] {DUPLICATES} in-batch duplicates answered, "
        f"{PAIRS} pairs ran")

    # 3. "auto", every family fused, in front of the scheduler
    fused = KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=True)
    eng = GedEngine("auto", device="cuda", vocab=auto_vocab, cache=True,
                    use_kernel=True, dispatch=fused)
    kops.reset_launch_counts()
    first, t_auto_miss = timed(lambda: eng.compute(auto_pairs))
    auto_launches = kops.launch_counts()
    assert all(v > 0 for v in auto_launches.values()), auto_launches
    dispatches = eng.stats["dispatches"]
    kops.reset_launch_counts()
    second, t_auto_hit = timed(lambda: eng.compute(auto_pairs))
    assert set(kops.launch_counts().values()) == {0}
    assert eng.stats["dispatches"] == dispatches, eng.stats
    no_fault_keys("cache", eng.stats)
    assert all(o.certified for o in first), "uncertified auto answer"
    expect_same("[cache] auto hit vs miss", [uncached(o) for o in second],
                first)
    expect_same("[cache] auto vs the tuned auto run", first, auto_comp)
    summ.update(auto_miss_s=t_auto_miss, auto_hit_s=t_auto_hit,
                auto_miss_launches=auto_launches,
                auto_hit_pairs_per_s=len(auto_pairs) / t_auto_hit)
    log(f"[cache] auto: miss {t_auto_miss:.3f} s, launches "
        f"{json.dumps(auto_launches)}; hit {t_auto_hit:.4f} s, "
        f"{len(auto_pairs) / t_auto_hit:.1f} pairs/s, 0 launches, "
        f"0 dispatches ({smi})")

    # 4. streaming: alternate computations and verifications
    eng = cached_engine(vocab)
    tickets = [eng.submit(q, g, tau=TAU if i % 2 else None)
               for i, (q, g) in enumerate(pairs)]
    assert tickets == list(range(PAIRS)), tickets[:5]
    expect_same("[cache] flush", eng.flush(),
                [(ver_c if i % 2 else comp_c)[i] for i in range(PAIRS)])
    assert eng.flush() == []
    no_fault_keys("cache", eng.stats)
    log(f"[cache] flush answered {PAIRS} submissions in ticket order")

    # 5. WL digests: isomorphic copies hit, exact digests miss
    rng = np.random.default_rng(SEED + 8)
    base = pairs[:ISOMORPHS]
    copies = [(permuted(rng, q), permuted(rng, g)) for q, g in base]
    for digest, hits in (("wl", ISOMORPHS), ("exact", 0)):
        eng = cached_engine(vocab, digest=digest)
        before = eng.compute(base)
        after = eng.compute(copies)
        stats = eng.stats
        assert (stats["result_cache_hits"],
                stats["result_cache_misses"]) == \
            (hits, 2 * ISOMORPHS - hits), (digest, stats)
        no_fault_keys("cache", stats)
        assert all(a.ged == b.ged for a, b in zip(before, after)
                   if a.certified and b.certified), digest
        if digest == "wl":
            assert all(o.mapping is None and o.stats.get("cached")
                       for o in after)
    log(f"[cache] {ISOMORPHS} permuted copies: wl digests hit, exact miss")

    # 6. the cross-process tier: a child fills it, a fresh engine here
    # answers every pair from it without a launch
    with tempfile.TemporaryDirectory() as d:
        written = child(["--shared-cache-child", d])["scalars"]
        eng = cached_engine(vocab, shared_cache_dir=d)
        kops.reset_launch_counts()
        outs, t_shared = timed(lambda: eng.compute(pairs))
        assert set(kops.launch_counts().values()) == {0}
        assert eng.stats["shared_cache_hits"] == PAIRS, eng.stats
        no_fault_keys("cache", eng.stats)
        got = [[o.ged, o.lower_bound, o.upper_bound, o.certified, o.similar]
               for o in outs]
        assert got == written, "shared-tier scalars differ from the child's"
    summ.update(shared_hit_s=t_shared, shared_hit_pairs_per_s=PAIRS / t_shared)
    log(f"[cache] shared tier: {PAIRS}/{PAIRS} hits from a child process, "
        f"{t_shared:.4f} s, {PAIRS / t_shared:.1f} pairs/s ({smi})")

    # 7. compile_cache_dir: the first child compiles, the second loads
    with tempfile.TemporaryDirectory() as d:
        cold = child(["--compile-cache-child", d])
        warm = child(["--compile-cache-child", d])
    assert (cold["persistent_cache_misses"],
            cold["persistent_cache_hits"]) == (1, 0), cold
    assert (warm["persistent_cache_misses"],
            warm["persistent_cache_hits"]) == (0, 1), warm
    log(f"[cache] compile_cache_dir: cold {json.dumps(cold)}, "
        f"warm {json.dumps(warm)}")
    return summ


# --------------------------------------------------- deadlines and faults

KERNEL_FAULT_PAIRS = 32   # main-cell pairs sent down the ladder by a fault
SITE_FAULT_PAIRS = 8      # pairs of the result- and host-site checks
MID_RUN_SHARE = 0.25      # the mid-run budget, as a share of [auto]'s wall


def brackets(o, truth) -> bool:
    """``o``'s bounds hold the certified distance ``truth``."""
    return o.lower_bound <= truth <= o.upper_bound


def sound(o, truth, tau=None) -> bool:
    """Certified with the clean answer, or uncertified with bounds that
    bracket it and a verdict (if any) that agrees with it."""
    if o.certified:
        return (o.ged == truth) if tau is None else (o.similar == (truth <= tau))
    if not brackets(o, truth):
        return False
    return tau is None or o.similar is None or o.similar == (truth <= tau)


def without(o, *keys):
    """``o`` with ``keys`` taken out of its stats."""
    return dataclasses.replace(
        o, stats={k: v for k, v in o.stats.items() if k not in keys})


def faults_phase(pairs, vocab, comp_c, ver_c, cuda_launches, auto_pairs,
                 auto_vocab, auto_comp, auto_ver, fused_launches,
                 auto_compute_s, tune_dir, smi):
    """The anytime deadline contract and the degradation ladder on the
    card: seven checks, each fatal.  ``comp_c`` / ``ver_c`` and
    ``cuda_launches`` are the main path's uncached ``"cuda"`` outcomes and
    launch counts, ``auto_comp`` / ``auto_ver`` and ``fused_launches`` the
    ``"auto"`` path's (tuned outcomes, all-fused counts), ``auto_compute_s``
    the tuned ``compute``'s median wall.  Returns the phase's summary."""
    from repro_torch.ged import (FaultInjector, GedEngine, KernelDispatch,
                                 RetryPolicy)
    from repro_torch.ged import faults
    from repro_torch.kernels import ops as kops
    from repro_torch.ged import build_plan
    assert all(o.certified for o in comp_c + auto_comp), "uncertified answer"
    truths = [o.ged for o in comp_c]
    auto_truths = [o.ged for o in auto_comp]
    summ = {}
    t_phase = time.perf_counter()

    # 1. a deadline that never bites: identical outcomes, identical launches
    kops.reset_launch_counts()
    comp, ver, _, _ = run_engine("cuda", pairs, "cuda", vocab,
                                 deadline_s=3600.0)
    assert kops.launch_counts() == cuda_launches, (kops.launch_counts(),
                                                   cuda_launches)
    expect_same("[faults] cuda deadline 3600 s", comp + ver, comp_c + ver_c)
    fused = KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=True)
    kops.reset_launch_counts()
    comp, ver, _, _, _, _ = auto_run(auto_pairs, auto_vocab, "cuda",
                                     dispatch=fused, deadline_s=3600.0)
    assert kops.launch_counts() == fused_launches, (kops.launch_counts(),
                                                    fused_launches)
    expect_same("[faults] auto deadline 3600 s", comp + ver,
                auto_comp + auto_ver)
    log("[faults] deadline 3600 s: cuda and all-fused auto outcomes and "
        f"launch counts equal the runs without a deadline ({smi})")

    # 2. an expired deadline: every pair answered, nothing dispatched
    kops.reset_launch_counts()
    comp, ver, stats, t_c, t_v, _ = auto_run(
        auto_pairs, auto_vocab, "cuda", faults_on=True, dispatch=fused,
        deadline_s=0.0)
    assert set(kops.launch_counts().values()) == {0}, kops.launch_counts()
    assert stats["dispatches"] == 0, stats
    assert stats["timed_out_pairs"] == 2 * len(auto_pairs), stats
    for o, t in zip(comp, auto_truths):
        assert o.timed_out and not o.certified and brackets(o, t), (o, t)
    for o, t in zip(ver, auto_truths):
        assert o.timed_out and not o.certified and sound(o, t, TAU), (o, t)
    # the facade plans (packs, orders) every pair before the backend sees
    # the deadline: time that planning alone
    t0 = time.perf_counter()
    build_plan(auto_pairs, vocab=auto_vocab)
    t_plan = time.perf_counter() - t0
    summ.update(expired_s=[t_c, t_v], plan_s=t_plan)
    log(f"[faults] deadline 0 s: {len(comp) + len(ver)} answers timed out, "
        f"bounds bracket the certified GED, 0 dispatches, 0 launches "
        f"({t_c:.4f} s compute, {t_v:.4f} s verify; planning the "
        f"{len(auto_pairs)} pairs alone {t_plan:.4f} s) ({smi})")

    # 3. a deadline that expires mid-run (tuned auto, compute): with the
    # default max_in_flight the loop dispatches up to 4 buckets before its
    # first expiry check; with max_in_flight=1 it checks after each one
    # the deadline's clock starts after planning (the reference's
    # semantics), so the overshoot is the wall less planning, timed alone
    # on the same pairs just before, less the budget
    budget = MID_RUN_SHARE * auto_compute_s
    for in_flight in (4, 1):
        eng = GedEngine("auto", device="cuda", vocab=auto_vocab,
                        cache=False, use_kernel="auto",
                        autotune_dir=tune_dir, max_in_flight=in_flight,
                        deadline_s=budget)
        t0 = time.perf_counter()
        build_plan(auto_pairs, slots=eng.slots, vocab=auto_vocab,
                   batch_multiple=eng.batch_multiple)
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = eng.compute(auto_pairs)
        wall = time.perf_counter() - t0
        overshoot = wall - plan_s - budget
        certified = sum(o.certified for o in outs)
        for o, clean, t in zip(outs, auto_comp, auto_truths):
            if o.certified:
                assert same_outcome(o, clean), (o, clean)
            else:
                assert o.timed_out and brackets(o, t), (o, t)
        row = {"budget_s": budget, "wall_s": wall, "plan_s": plan_s,
               "overshoot_s": overshoot, "wall_past_budget_s": wall - budget,
               "certified": certified, "timed_out": len(outs) - certified,
               "dispatches": eng.stats["dispatches"]}
        summ[f"mid_run_max_in_flight_{in_flight}"] = row
        log(f"[faults] mid-run deadline, max_in_flight={in_flight}: "
            f"{budget:.4f} s ({MID_RUN_SHARE:g} of [auto]'s "
            f"{auto_compute_s:.4f} s); returned after {wall:.4f} s, of "
            f"which planning {plan_s:.4f} s; overshoot after planning "
            f"{overshoot:.4f} s (whole call {wall - budget:.4f} s past the "
            f"budget); {certified} certified, {len(outs) - certified} "
            f"timed out, {row['dispatches']} dispatches ({smi})")

    # 4. a transient dispatch fault: one retry, the same answers
    engines = []
    comp, ver, _, _ = run_engine(
        "cuda", pairs, "cuda", vocab, faults_on=True, engine_out=engines,
        fault_inject="dispatch@times=1,kind=transient",
        retry=RetryPolicy(base_s=0.0))
    stats = engines[0].stats
    assert stats["retries"] == 1 and "fault_dispatch" not in stats, stats
    expect_same("[faults] transient retry",
                [without(o, "retries") for o in comp + ver], comp_c + ver_c)
    log("[faults] transient dispatch fault: retries == 1, outcomes equal "
        "the clean run")

    # 5. a permanent kernel fault: the buckets go to the host solver
    head = pairs[:KERNEL_FAULT_PAIRS]
    eng = GedEngine("cuda", device="cuda", vocab=vocab, cache=False,
                    pool=POOL, expand=EXPAND, max_iters=MAX_ITERS,
                    fault_inject="kernel@times=inf")
    kops.reset_launch_counts()
    outs, t_host = timed(lambda: eng.compute(head))
    assert set(kops.launch_counts().values()) == {0}, kops.launch_counts()
    assert eng.stats["degraded_host"] == KERNEL_FAULT_PAIRS, eng.stats
    assert "degraded_kernel" not in eng.stats, eng.stats
    for o, t in zip(outs, truths):
        assert o.degraded and o.certified and o.ged == t, (o, t)
    per_pair = [o.wall_s for o in outs]
    summ.update(host_s_per_pair_median=statistics.median(per_pair),
                host_s_per_pair_max=max(per_pair),
                host_s_per_pair_min=min(per_pair), host_call_s=t_host)
    log(f"[faults] kernel@times=inf: 0 launches, degraded_host == "
        f"{KERNEL_FAULT_PAIRS}, every answer certified and equal; host "
        f"solver s/pair median {statistics.median(per_pair):.4f}, min "
        f"{min(per_pair):.4f}, max {max(per_pair):.4f} (call "
        f"{t_host:.3f} s) ({smi})")

    # 6. the result and host sites: sound, certified or degraded
    few = pairs[:SITE_FAULT_PAIRS]
    eng = GedEngine("cuda", device="cuda", vocab=vocab, cache=False,
                    pool=POOL, expand=EXPAND, max_iters=MAX_ITERS,
                    fault_inject="result@times=1")
    outs = eng.compute(few) + eng.verify(few, tau=TAU)
    assert eng.stats["degraded_host"] >= 1, eng.stats
    eng = GedEngine("exact", device="cuda", cache=False,
                    fault_inject="host@times=inf")
    host_outs = eng.compute(few) + eng.verify(few, tau=TAU)
    assert eng.stats["fault_host"] == 2 * SITE_FAULT_PAIRS, eng.stats
    assert not any(o.certified for o in host_outs)
    for o, t, tau in zip(outs + host_outs, 4 * truths[:SITE_FAULT_PAIRS],
                         ([None] * SITE_FAULT_PAIRS + [TAU] * SITE_FAULT_PAIRS)
                         * 2):
        assert sound(o, t, tau) and (o.certified or o.degraded), (o, t)
    log(f"[faults] result@times=1 on cuda, host@times=inf on exact "
        f"({SITE_FAULT_PAIRS} pairs): every answer sound")

    # 7. caches are never poisoned
    with tempfile.TemporaryDirectory() as d:
        faults.install_injector(FaultInjector("lock@times=1"))
        try:
            eng = cached_engine(vocab, shared_cache_dir=d)
            outs = eng.compute(pairs)
        finally:
            faults.install_injector(None)
        assert eng.stats["shared_cache_lock_timeouts"] >= 1, eng.stats
        expect_same("[faults] lock timeout", outs, comp_c)
    eng = cached_engine(vocab)
    kops.reset_launch_counts()
    bad = eng.compute(pairs, deadline_s=0.0)
    assert set(kops.launch_counts().values()) == {0}
    assert all(o.timed_out for o in bad)
    assert eng.stats["result_cache_entries"] == 0, eng.stats
    good = eng.compute(pairs)
    launches = kops.launch_counts()
    assert all(launches[k] > 0 for k in
               ("reduced_top2", "bma_cost_matrix", "lsa_children")), launches
    assert all(o.certified for o in good)
    expect_same("[faults] after a timed-out call", good, comp_c)
    eng = cached_engine(vocab)
    for i, (q, g) in enumerate(pairs):
        eng.submit(q, g, tau=TAU if i % 2 else None)
    flushed = eng.flush(deadline_s=0.0)
    assert len(flushed) == PAIRS and all(o.timed_out for o in flushed)
    assert [o.tau for o in flushed] == [TAU if i % 2 else None
                                        for i in range(PAIRS)]
    log("[faults] caches: lock@times=1 fails open with equal answers; a "
        "timed-out call caches nothing and the next one launches and "
        "certifies; flush(deadline_s=0) answers every ticket timed out, in "
        "order")
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[faults] summary: " + json.dumps(summ) + f" ({smi})")
    return summ


# ---------------------------------------------------------------- store

STORE_GRAPHS = 42687     # graphs in the AIDS antiviral screen database
STORE_QUERIES = 16       # queries drawn from the corpus
STORE_PLANTED = 3        # perturb(query, k), k in [1, 3], per query
STORE_TAUS = (2.0, 4.0)
# the reference bench's store options (benchmarks/eval_engine.py)
STORE_OPTS = dict(backend="auto", batch_size=32, pool=512, expand=8,
                  max_iters=512, cache=False)
# the top-k sub-store: its eight sketch-nearest seeds per query are the
# query and its seven near-duplicates, so top_k(4) computes no exact GED
# between unrelated graphs
SUB_GRAPHS, SUB_QUERIES, SUB_PLANTED = 2000, 4, 7
FUNNEL = ("candidates", "index_pruned", "stage0_pruned", "stage1_decided",
          "stage1_accepted", "stage2_verified", "hits")
STAGE_WALLS = ("index_wall_s", "scan_wall_s", "bound_wall_s",
               "verify_wall_s")


def store_corpus(rng, count, n_lo, n_hi, queries, planted):
    """``count`` AIDS-like graphs (62 vertex labels, 3 edge labels, n in
    [n_lo, n_hi]), the last ``queries * planted`` of them ``perturb(q,
    k)``, k in [1, 3], of ``queries`` graphs drawn from the rest.  Returns
    (graphs, query ids, {planted id: (query position, k)})."""
    from repro_torch.data.graphs import aids_like_graph, perturb
    base = count - queries * planted
    graphs = [aids_like_graph(rng, int(rng.integers(n_lo, n_hi + 1)),
                              n_vlabels=62, n_elabels=3)
              for _ in range(base)]
    qids = [int(i) for i in rng.choice(base, queries, replace=False)]
    planted_of = {}
    for qi, q in enumerate(qids):
        for _ in range(planted):
            k = int(rng.integers(1, 4))
            planted_of[len(graphs)] = (qi, k)
            graphs.append(perturb(rng, graphs[q], k, n_vlabels=62,
                                  n_elabels=3))
    return graphs, qids, planted_of


def expect_same_hits(tag, got, want):
    """Hit lists equal field by field: id, stage, query id, outcome."""
    for qi, (a, b) in enumerate(zip(got, want)):
        ka = [(h.graph_id, h.stage, h.query_id) for h in a]
        kb = [(h.graph_id, h.stage, h.query_id) for h in b]
        assert ka == kb, f"{tag}: query {qi} hits {ka} != {kb}"
        bad = [h.graph_id for h, i in zip(a, b)
               if not same_outcome(h.outcome, i.outcome)]
        assert not bad, f"{tag}: query {qi} outcomes differ at {bad}"
    assert len(got) == len(want), tag


def store_pass(store, queries, tau):
    """``search_batch(queries, tau)`` on the card: (hits, row of the
    funnel, the stage walls, queries/s and the share that survives stage
    -1).  The funnel must sum to the candidates."""
    import torch
    before = store.stats
    t0 = time.perf_counter()
    hits = store.search_batch(queries, tau)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = store.stats
    row = {k: after[k] - before[k] for k in FUNNEL + STAGE_WALLS}
    assert row["index_pruned"] + row["stage0_pruned"] + \
        row["stage1_decided"] + row["stage2_verified"] == \
        row["candidates"], row
    row.update(tau=tau, wall_s=wall, queries_per_s=len(queries) / wall,
               examined_frac=(row["candidates"] - row["index_pruned"])
               / row["candidates"])
    return hits, row


def store_phase(smi):
    """The corpus layer on the card; returns (summary, the fused store's
    launches over its two search passes, the card's 2,000-graph sub-store:
    graphs, query ids and queries, its range and top-k hits, signatures
    and wall seconds; the fused store's saved snapshot, a directory the
    caller removes, with its query ids and hits at each tau)."""
    import torch
    from repro_torch import ged
    from repro_torch.kernels import ops as kops
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    graphs, qids, planted_of = store_corpus(
        np.random.default_rng(SEED + 8), STORE_GRAPHS, 10, 40,
        STORE_QUERIES, STORE_PLANTED)
    queries = [graphs[q] for q in qids]
    summ = {"graphs": len(graphs), "queries": len(queries),
            "mean_n": float(np.mean([g.n for g in graphs])),
            "mean_m": float(np.mean([g.m for g in graphs])),
            "corpus_s": time.perf_counter() - t0}
    fused = ged.KernelDispatch(lsa_fused=True, bma_fused=True,
                               merge_fused=True)
    variants = {"fused": dict(use_kernel=True, dispatch=fused),
                "unfused": dict(use_kernel=False)}
    stores = {}
    for tag, opts in variants.items():
        t0 = time.perf_counter()
        store = ged.GraphStore(graphs, device="cuda", **STORE_OPTS, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = store.stats
        row = {"wall_s": wall, "ingest_wall_s": s["ingest_wall_s"],
               "vocab_wall_s": s["vocab_wall_s"],
               "pack_wall_s": s["pack_wall_s"],
               "dedup_wall_s": s["ingest_wall_s"] - s["vocab_wall_s"]
               - s["pack_wall_s"],
               "dedup_groups": s["dedup_groups"],
               "dedup_checks": s["dedup_checks"],
               "slot_buckets": {b.slots: len(b.ids)
                                for b in store._index.buckets}}
        log(f"[store] ingest {tag}: " + json.dumps(row))
        summ[f"ingest_{tag}"] = row
        stores[tag] = store

    store = stores["fused"]
    cindex = store._cindex
    reps = [graphs[i] for i in cindex.ids]
    t0 = time.perf_counter()
    sigs = ged.batch_signatures(reps, cindex.spec, store.executor)
    sig_wall = time.perf_counter() - t0
    assert np.array_equal(sigs, cindex.sigs)
    sample = range(0, len(reps), 97)
    assert all(np.array_equal(sigs[i], ged.wl_signature(reps[i],
                                                        cindex.spec))
               for i in sample)
    sig_dev = device_ms(lambda: ged.batch_signatures(reps, cindex.spec,
                                                     store.executor),
                        reps=1, warmup=0)
    summ["signatures"] = {"rows": len(reps), "wall_s": sig_wall,
                          "device_ms": sig_dev}
    log(f"[store] signature build: {len(reps)} rows x {cindex.spec.dims}, "
        f"{sig_wall:.3f} s wall, device {sig_dev} ms; equal to the "
        f"store's and, on {len(sample)} rows, to wl_signature on the host")

    launches = dict.fromkeys(kops.launch_counts(), 0)
    hits = {}
    for tau in STORE_TAUS:
        for tag in variants:
            kops.reset_launch_counts()
            hits[tag, tau], row = store_pass(stores[tag], queries, tau)
            torch.cuda.synchronize()
            if tag == "fused":      # reduced_top2 runs unfused too
                for k, v in kops.launch_counts().items():
                    launches[k] += v
            log(f"[store] search {tag}: " + json.dumps(row))
            summ[f"search_{tag}_tau{tau:g}"] = row
        expect_same_hits(f"[store] fused vs unfused at tau {tau}",
                         hits["fused", tau], hits["unfused", tau])
        for qi, hs in enumerate(hits["fused", tau]):
            found = {h.graph_id for h in hs}
            assert qids[qi] in found, (tau, qi)
            missed = [p for p, (q, k) in planted_of.items()
                      if q == qi and k <= tau and p not in found]
            assert not missed, f"tau {tau}: planted {missed} not found"
            assert all(h.certified and h.similar for h in hs)
    log(f"[store] fused store launches (both taus): {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"kernels never launched on the store path: {missing}"
    for tag in variants:
        no_fault_keys(f"store {tag}", stores[tag].engine.stats)
    log("[store] fused == unfused on every hit; every planted "
        "near-duplicate within tau found; every hit certified; the funnel "
        "sums to the candidates")

    tau = STORE_TAUS[0]
    n_checked = 0
    for qi, hs in enumerate(hits["fused", tau]):
        ids = [p for p, (q, _) in planted_of.items() if q == qi]
        found = {h.graph_id for h in hs}
        for p, o in zip(ids, store.verify_members(queries[qi], ids, tau)):
            assert o.certified and o.similar == (p in found), (qi, p, o)
            n_checked += 1
    log(f"[store] verify_members on {n_checked} planted ids agrees with "
        f"the range hits at tau {tau:g}")

    # the snapshot outlives the phase: [distributed] (d) opens it on a mesh
    d = tempfile.mkdtemp(prefix="repro_torch_store_")
    t0 = time.perf_counter()
    store.save(d)
    save_wall = time.perf_counter() - t0
    warm = ged.GraphStore.open(d, device="cuda", **STORE_OPTS,
                               **variants["fused"])
    ws = warm.stats
    assert ws["filter_packed_rows"] == 0, ws["filter_packed_rows"]
    assert ws["index_signatures_built"] == 0
    for tau in STORE_TAUS:
        expect_same_hits(f"[store] warm open at tau {tau}",
                         warm.search_batch(queries, tau),
                         hits["fused", tau])
    del warm
    summ["persist"] = {"save_wall_s": save_wall,
                       "open_wall_s": ws["open_wall_s"],
                       "ingest_wall_s": store.stats["ingest_wall_s"]}
    log("[store] save/open: " + json.dumps(summ["persist"]) +
        "; the warm open re-packed and re-hashed nothing and answers "
        "like the store it was saved from")

    sub, sub_qids, _ = store_corpus(np.random.default_rng(SEED + 9),
                                    SUB_GRAPHS, 8, 14, SUB_QUERIES,
                                    SUB_PLANTED)
    sub_queries = [sub[q] for q in sub_qids]
    answers, sub_sigs = {}, None
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        st = ged.GraphStore(sub, device=device, **STORE_OPTS,
                            **variants["fused"])
        ranged = st.search_batch(sub_queries, STORE_TAUS[0])
        top = [st.top_k(q, 4) for q in sub_queries]
        answers[device] = (ranged, top, time.perf_counter() - t0)
        if device == "cuda":
            sub_sigs = st._cindex.sigs
    expect_same_hits("[store] sub-store range, card vs CPU",
                     answers["cuda"][0], answers["cpu"][0])
    expect_same_hits("[store] sub-store top-k, card vs CPU",
                     answers["cuda"][1], answers["cpu"][1])
    for q, hs in zip(sub_qids, answers["cuda"][1]):
        assert hs[0].graph_id == q and hs[0].ged == 0.0, (q, hs[0])
    summ["sub_store"] = {"graphs": len(sub), "card_s": answers["cuda"][2],
                         "cpu_s": answers["cpu"][2]}
    log(f"[store] sub-store of {len(sub)} graphs: range_search(tau "
        f"{STORE_TAUS[0]:g}) and top_k(4) on {len(sub_queries)} queries "
        "equal on the card and the CPU")
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[store] summary: " + json.dumps(summ) + f" ({smi})")
    sub_store = {"graphs": sub, "qids": sub_qids, "queries": sub_queries,
                 "ranged": answers["cuda"][0], "top": answers["cuda"][1],
                 "sigs": sub_sigs, "wall_s": answers["cuda"][2]}
    big_store = {"snapshot": d, "qids": qids,
                 "hits": {tau: hits["fused", tau] for tau in STORE_TAUS}}
    return summ, launches, sub_store, big_store


# -------------------------------------------------------------- serving

LAUNCHER_PAIRS = 100     # the launcher's default request count


def serving_phase(pairs, ver_c, sub_store, smi):
    """The GED services on the card: the main cell's pairs as requests,
    the result cache, corpus routing through the sub-store, deadlines,
    shedding, the similarity service and the launcher; returns (summary,
    launches of the service calls)."""
    import torch
    from repro_torch import ged
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import (GedRequest, GedSimilarityService,
                                     GedVerificationService, SearchRequest)
    t_phase = time.perf_counter()
    summ = {}
    reqs = [GedRequest(q, g, tau=TAU) for q, g in pairs]
    svc = GedVerificationService(use_kernel=True, device="cuda")
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = svc.verify(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()
    missing = [k for k in ("reduced_top2", "bma_cost_matrix",
                           "lsa_children") if launches[k] <= 0]
    assert not missing, f"[serving] kernels never launched: {missing}"
    assert all(o.certified for o in outs), "[serving] uncertified answer"
    # the same engine, called directly: every field equal
    direct = ged.GedEngine("auto", device="cuda", slots=32, batch_size=256,
                           use_kernel=True, cache=False).verify(
        pairs, tau=TAU)
    expect_same("[serving] service vs the direct engine", outs, direct)
    # the main cell's "cuda" engine (another search budget): the verdicts
    diff = [i for i, (a, b) in enumerate(zip(outs, ver_c))
            if b.certified and a.similar != b.similar]
    assert not diff, f"[serving] verdicts differ from [main] at {diff[:10]}"
    summ["verify"] = {"requests": len(reqs), "wall_s": wall,
                      "requests_per_s": len(reqs) / wall,
                      "launches": launches}
    log("[serving] verify: " + json.dumps(summ["verify"]) + "; every "
        "answer certified, equal field by field to GedEngine(\"auto\") "
        "with the service's options and in verdict to [main]'s \"cuda\"")

    calls = svc.engine.stats["executor_calls"]
    kops.reset_launch_counts()
    again, t_hit = timed(lambda: svc.verify(reqs))
    assert set(kops.launch_counts().values()) == {0}, "[serving] hit launched"
    assert svc.engine.stats["executor_calls"] == calls
    expect_same("[serving] repeat", [uncached(o) for o in again], outs)
    summ["repeat"] = {"wall_s": t_hit, "requests_per_s": len(reqs) / t_hit}
    log(f"[serving] repeat: {len(reqs)} result-cache hits in {t_hit:.4f} s, "
        "no launch, no dispatch")

    dl = [GedRequest(q, g, tau=TAU, deadline_s=3600.0) for q, g in pairs]
    fresh = GedVerificationService(use_kernel=True, device="cuda")
    expect_same("[serving] deadline_s=3600", fresh.verify(dl), outs)
    assert fresh.health()["timed_out_pairs"] == 0
    log("[serving] requests with deadline_s=3600 answer like those without")

    graphs, queries = sub_store["graphs"], sub_store["queries"]
    store = svc.register_corpus(graphs)
    rng = np.random.default_rng(SEED + 11)
    members = [int(i) for i in rng.choice(len(graphs), 24, replace=False)]
    routed = [GedRequest(queries[i % len(queries)], graphs[m], tau=2.0)
              for i, m in enumerate(members)]
    routed += [GedRequest(q, graphs[sub_store["qids"][i]], tau=2.0)
               for i, q in enumerate(queries)]
    routed += reqs[:8]                                 # not in the corpus
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    got = svc.verify(routed)
    torch.cuda.synchronize()
    t_routed = time.perf_counter() - t0
    routed_launches = kops.launch_counts()
    s = svc.stats
    n_store = len(routed) - 8
    assert s["store_candidates"] == n_store, s["store_candidates"]
    assert s["store_index_pruned"] + s["store_stage0_pruned"] + \
        s["store_stage1_decided"] + s["store_stage2_verified"] == n_store
    want = ged.GedEngine("auto", device="cuda", cache=False).verify(
        [(r.q, r.g) for r in routed], [r.tau for r in routed])
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if (a.similar, a.certified) != (b.similar, b.certified)]
    assert not bad, f"[serving] routed verdicts differ at {bad}"
    assert all(o.certified for o in got)
    summ["routed"] = {"requests": len(routed), "in_store": n_store,
                      "wall_s": t_routed, "launches": routed_launches,
                      "funnel": {k: s[f"store_{k}"] for k in FUNNEL}}
    log("[serving] routed through the store: " + json.dumps(summ["routed"])
        + "; verdicts equal the direct engine's")

    held = GedVerificationService(capacity=4, device="cuda", use_kernel=True)
    with held.admission.admit(3):
        try:
            held.verify(reqs[:2])
        except ged.Overloaded as err:
            retry = err.retry_after_s
        else:
            raise AssertionError("[serving] a held budget did not shed")
    h = held.health()
    assert h["shed"] == 1 and h["queue_depth"] == 0, h
    log(f"[serving] a held budget sheds with Overloaded (retry after "
        f"{retry:.4f} s); health shed={h['shed']:g}")

    sim = GedSimilarityService(graphs, device="cuda", **STORE_OPTS,
                               use_kernel=True, dispatch=ged.KernelDispatch(
                                   lsa_fused=True, bma_fused=True,
                                   merge_fused=True))
    ranged = [sim.range_search(q, STORE_TAUS[0]) for q in queries]
    want_ranged = [[dataclasses.replace(h_, query_id=None) for h_ in hs]
                   for hs in sub_store["ranged"]]
    expect_same_hits("[serving] similarity range_search", ranged,
                     want_ranged)
    expect_same_hits("[serving] similarity top_k",
                     [sim.top_k(q, 4) for q in queries], sub_store["top"])
    answers = sim.search([SearchRequest(q, tau=STORE_TAUS[0])
                          for q in queries])
    expect_same_hits("[serving] similarity search", answers,
                     sub_store["ranged"])
    hs = sim.health()
    summ["similarity"] = {"queries": 3 * len(queries),
                          "p50_wall_s": hs["p50_wall_s"],
                          "p99_wall_s": hs["p99_wall_s"]}
    log("[serving] similarity service: range_search, top_k and search "
        "equal the sub-store's own hits; " + json.dumps(summ["similarity"]))

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--mode", "ged"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    t_launch = time.perf_counter() - t0
    assert res.returncode == 0, res.stdout + res.stderr
    want_line = f"certified: {LAUNCHER_PAIRS}/{LAUNCHER_PAIRS}"
    assert want_line in res.stdout, res.stdout
    log(f"[serving] launcher: {res.stdout.splitlines()[0]}; "
        f"{res.stdout.splitlines()[1]} ({t_launch:.1f} s with start-up)")
    summ["launcher_s"] = t_launch

    health = svc.health()
    summ["health"] = {k: health[k] for k in ("admitted", "shed",
                                             "p50_wall_s", "p99_wall_s")}
    for tag, eng in (("service", svc.engine), ("direct", fresh.engine)):
        no_fault_keys(f"serving {tag}", eng.stats)
    total = {k: summ["verify"]["launches"][k] + summ["routed"]["launches"][k]
             for k in launches}
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[serving] summary: " + json.dumps(summ) + f" ({smi})")
    return summ, total


# -------------------------------------------------------------- sharded

def sharded_phase(pairs, vocab, comp_t, ver_t, auto_pairs, auto_vocab,
                  auto_comp, auto_ver, auto_s, sub_store, smi):
    """Multi-device placement on the card: ``"sharded"`` on every visible
    card, ``"auto"`` on a two-shard mesh of card 0 all fused, and a
    two-shard ``GraphStore``; returns (summary, launches of the mesh
    ``"auto"`` run)."""
    import torch
    from repro_torch import ged
    from repro_torch.kernels import ops as kops
    t_phase = time.perf_counter()
    summ = {}
    cards = torch.cuda.device_count()
    out = []
    comp, ver, tc, tv = run_engine("sharded", pairs, "cuda", vocab,
                                   engine_out=out)
    eng = out[0]
    assert eng.batch_multiple == cards, eng.batch_multiple
    fast = eng.stats["executor_single_device_fastpath"]
    assert (fast > 0) == (cards == 1), fast
    expect_same("[sharded] \"sharded\" vs [main] \"torch\"", comp + ver,
                comp_t + ver_t)
    summ["sharded_backend"] = {"cards": cards, "fastpath_dispatches": fast,
                               "compute_s": tc, "verify_s": tv}
    log("[sharded] \"sharded\" backend: " + json.dumps(
        summ["sharded_backend"]) + "; outcomes equal [main]'s \"torch\"")

    mesh = ["cuda:0", "cuda:0"]
    fused = ged.KernelDispatch(lsa_fused=True, bma_fused=True,
                               merge_fused=True)
    kops.reset_launch_counts()
    comp_m, ver_m, stats, tcm, tvm, _ = auto_run(
        auto_pairs, auto_vocab, "cuda", mesh=mesh, dispatch=fused)
    launches = kops.launch_counts()
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"[sharded] kernels never launched: {missing}"
    assert stats["executor_single_device_fastpath"] == 0
    expect_same("[sharded] auto on a 2-shard mesh vs [auto] all fused",
                comp_m + ver_m, auto_comp + auto_ver)
    meshes = {"mesh": mesh}
    walls = {"mesh": [(tcm, tvm)], "one_device": []}
    if cards > 1:
        # one shard on each card: the split the executor exists for
        meshes["every_card"] = [f"cuda:{i}" for i in range(cards)]
        comp_e, ver_e, _, tce, tve, _ = auto_run(
            auto_pairs, auto_vocab, "cuda", mesh=meshes["every_card"],
            dispatch=fused)
        expect_same("[sharded] auto on every card vs [auto] all fused",
                    comp_e + ver_e, auto_comp + auto_ver)
        walls["every_card"] = [(tce, tve)]
    # walls in turns (the meshes, one device twice, the meshes again):
    # the host sets the pace and drifts between runs
    for tag in ("one_device", "one_device", *meshes):
        walls[tag].append(auto_run(auto_pairs, auto_vocab, "cuda",
                                   dispatch=fused,
                                   mesh=meshes.get(tag))[3:5])
    summ["auto_mesh"] = {"meshes": meshes,
                         "compute_verify_s": walls,
                         "auto_phase_all_fused_s": auto_s,
                         "dispatches": stats["dispatches"],
                         "launches": launches}
    log("[sharded] auto, meshes " + json.dumps(summ["auto_mesh"]) +
        "; outcomes equal [auto]'s all-fused run field by field")

    graphs, queries = sub_store["graphs"], sub_store["queries"]
    t0 = time.perf_counter()
    st = ged.GraphStore(graphs, mesh=mesh, **STORE_OPTS, use_kernel=True,
                        dispatch=fused)
    assert st.executor.batch_multiple == 2
    assert all(len(b.shards) == 2 and
               {sh[0].shape[0] for sh in b.shards} == {-(-len(b.ids) // 2)}
               for b in st._index.buckets)
    assert st._cindex.sigs.tobytes() == sub_store["sigs"].tobytes()
    batches = []
    dispatch = st.executor._dispatch

    def spy(packed, taus, cfg, verification):
        batches.append(packed.batch)
        return dispatch(packed, taus, cfg, verification)

    st.executor._dispatch = spy
    ranged = st.search_batch(queries, STORE_TAUS[0])
    top = [st.top_k(q, 4) for q in queries]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del st.executor._dispatch
    assert batches and all(b % 2 == 0 for b in batches), batches
    expect_same_hits("[sharded] mesh store range", ranged,
                     sub_store["ranged"])
    expect_same_hits("[sharded] mesh store top-k", top, sub_store["top"])
    no_fault_keys("sharded store", st.engine.stats)
    summ["store_mesh"] = {"graphs": len(graphs), "wall_s": wall,
                          "single_device_wall_s": sub_store["wall_s"],
                          "dispatches": len(batches)}
    log("[sharded] store, mesh " + json.dumps(summ["store_mesh"]) +
        "; buckets and batches are multiples of 2, signatures byte-equal, "
        "hits equal the single-device store's")
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[sharded] summary: " + json.dumps(summ) + f" ({smi})")
    return summ, launches

# ------------------------------------------------------------------- LM

LM_BATCH, LM_PROMPT, LM_NEW = 4, 32, 16   # the qwen3-8b generate cell
LM_TOL = dict(atol=2e-3, rtol=2e-2)       # tests/test_archs.py's oracle
GEMMA_PROMPT = 600                        # wraps gemma3's 512-slot rings
LONG_PREFILL = 2048                       # one layer, impl flash vs naive


def max_diff(got, want, tol, tag=""):
    """Largest |got - want|; raises past ``atol + rtol * |want|``.  A bf16
    tensor (a KV cache) may also be one bf16 step (2**-7 of the value)
    away: an f32-level difference upstream can flip its one rounding."""
    import torch
    if want.dtype == torch.bfloat16:
        tol = dict(tol, rtol=max(tol["rtol"], 2.0 ** -7))
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > tol["atol"] + tol["rtol"] * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{tag}: {int(bad.sum())} of {bad.numel()} "
                             f"values differ; max |diff| {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


@contextlib.contextmanager
def pinned_routes(cfg, b, s):
    """Pin the MoE routing of full forwards over ``s + 1`` positions to
    the routing that a prefill over ``s`` and a decode step at ``s`` chose
    (their ``router_topk`` calls come first inside the context, one per
    layer each).

    Routing is discrete: f32 noise between two matmul shapes can flip a
    near-tied top-k choice, and a flipped token takes another expert's
    path.  A forward's layer ``i`` gets the recorded ids, with weights
    re-read from its own probabilities; ``flips`` counts the tokens whose
    own top-k differed, ``least_margin`` is the smallest gap between the
    k-th and the (k+1)-th probability among them."""
    import torch
    from repro_torch.models import moe as moe_lib
    route, n, k = moe_lib.router_topk, cfg.n_layers, cfg.moe.top_k
    rec, info = [], {"flips": 0, "least_margin": None}

    def pinned(x, wr, c):
        w, ids, probs = route(x, wr, c)
        if len(rec) < 2 * n:
            rec.append(ids)
            return w, ids, probs
        i = (len(rec) - 2 * n) % n
        rec.append(None)
        want = torch.cat([rec[i].reshape(b, s, k),
                          rec[n + i].reshape(b, 1, k)], 1).reshape(-1, k)
        flipped = (ids.sort(-1).values != want.sort(-1).values).any(-1)
        if bool(flipped.any()):
            top = probs[flipped].sort(-1, descending=True).values
            gap = float((top[:, k - 1] - top[:, k]).min())
            info["flips"] += int(flipped.sum())
            info["least_margin"] = min(gap, info["least_margin"] or gap)
        w = torch.gather(probs, -1, want)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), want, \
            probs

    moe_lib.router_topk = pinned
    try:
        yield info
    finally:
        moe_lib.router_topk = route


def abs_max(got, want, tol=None, tag=""):
    """``max_diff`` without the check: for numbers kept unchecked."""
    return float((got.float() - want.float()).abs().max())


def consistency(params, cfg, prompt, patches=None, frames=None,
                checked=True):
    """``tests/test_archs.py``'s oracle at full size: the prompt's last
    token decoded against the caches of a prefill over the others, held
    to the full forward over the whole prompt.

    The caches hold K/V in bf16 (in the reference too).  At full width
    that rounding alone moves the decode logits past ``test_archs``'s
    tolerance from the plain forward's (returned, unchecked), and any
    f32-level difference between two paths can flip single roundings.
    So the check is in
    two parts, both within ``test_archs``'s tolerance: every cache row
    equals the full forward's roped K/V at its position (a ring slot
    ``p % T`` holding position ``p``); and the decode logits equal the
    full forward's whose last position attends to the very K/V rows the
    decode step read.  The prefill logits are held to the plain
    forward's.  The forward's attention calls map to caches in order:
    a layer's ``k``/``v`` (or its ring or global cache), zamba2's shared
    block's ``attn_k``/``attn_v`` once per group, and whisper's decoder
    layer's ``self_k``/``self_v`` then its ``cross_k``/``cross_v`` (all
    ``enc_seq`` rows; the encoder's calls read no cache).  An rwkv6 or
    mamba2 stack makes no attention call, so there the decode logits are
    held to the plain forward's.  An MoE's routing is pinned
    (``pinned_routes``; its flips are returned).  ``checked=False``
    returns every number without holding it to the tolerance.
    """
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.lm_decode import _grow_caches
    b, s = prompt.shape[0], prompt.shape[1] - 1
    stream = s + (0 if patches is None else patches.shape[1])
    plain = T.reference_attention

    def cache_table():
        """(k cache, v cache, cross?) per attention call, None: no cache."""
        if cfg.family == "audio":
            out = [None] * cfg.encdec.enc_layers
            for i in range(cfg.n_layers):
                out += [(caches["self_k"][i], caches["self_v"][i], False),
                        (caches["cross_k"][i], caches["cross_v"][i], True)]
            return out
        if cfg.family == "hybrid":
            return [(k, v, False) for k, v in zip(caches["attn_k"],
                                                  caches["attn_v"])]
        if cfg.family == "ssm":
            return []
        windows = cfg.windows()
        if not any(w > 0 for w in windows):
            return [(caches["k"][i], caches["v"][i], False)
                    for i in range(cfg.n_layers)]
        out = []
        for i, w in enumerate(windows):
            kind = "local" if w > 0 else "global"
            j = sum(1 for x in windows[:i] if (x > 0) == (w > 0))
            out.append((caches[kind + "_k"][j], caches[kind + "_v"][j],
                        False))
        return out

    seen = []

    def last_row_on_cache(q, k, v, causal=True, window=0,
                          kv_valid=10 ** 9, q_offset=0):
        out = plain(q, k, v, causal, window, kv_valid, q_offset)
        ent = table[len(seen)]
        seen.append((k, v, ent))
        if ent is not None:
            ck, cv, cross = ent
            # valid slots after decode; a cross cache is valid throughout
            rows = ck.shape[1] if cross else min(stream + 1, ck.shape[1])
            out[:, -1:] = plain(q[:, -1:], ck[:, :rows], cv[:, :rows], False)
        return out

    def full_logits():
        h = T.forward_hidden(params, prompt, cfg, patches=patches,
                             frames=frames, impl="naive")
        return L.lm_logits(L.norm(h[:, -2:], params["final_norm"], cfg),
                           params, cfg)

    pin = (pinned_routes(cfg, b, stream) if cfg.moe is not None
           else contextlib.nullcontext())
    with torch.no_grad(), pin as routes:
        logits_p, caches = T.prefill_step(params, prompt[:, :s], cfg,
                                          patches=patches, frames=frames,
                                          impl="naive")
        caches = _grow_caches(caches, cfg, b, stream, stream + 4)
        logits_d, caches = T.decode_step(params, caches, prompt[:, s:],
                                         stream, cfg)
        full = full_logits()
        table = cache_table()
        T.reference_attention = last_row_on_cache
        try:
            on_cache = full_logits()
        finally:
            T.reference_attention = plain
    assert len(seen) == len(table), (len(seen), len(table))
    diff = max_diff if checked else abs_max
    cache_diff = 0.0
    for i, (k, v, ent) in enumerate(seen):
        if ent is None:
            continue
        ck, cv, cross = ent
        if cross:
            es = ck.shape[1]
            rows = ((ck, k[:, :es]), (cv, v[:, :es]))
        else:
            t = ck.shape[1]
            pos = torch.arange(max(0, stream + 1 - t), stream + 1,
                               device=k.device)
            rows = ((ck[:, pos % t], k[:, pos]), (cv[:, pos % t], v[:, pos]))
        for got, want in rows:
            cache_diff = max(cache_diff, diff(
                got, want.to(torch.bfloat16), LM_TOL,
                f"attention call {i} cache"))
    torch.cuda.synchronize()
    out = {"prefill": diff(logits_p, full[:, 0], LM_TOL, "prefill"),
           "caches_vs_forward_kv": cache_diff,
           "decode_vs_forward_on_cached_kv": diff(
               logits_d, on_cache[:, 1], LM_TOL, "decode"),
           "decode_vs_forward_unchecked": abs_max(logits_d, full[:, 1])}
    if cfg.moe is not None:
        out["route_flips_pinned"] = routes["flips"]
        out["least_top_k_margin_of_a_flip"] = routes["least_margin"]
    return out


MIXERS = {"rwkv6_time_mix": "time_mix", "rwkv6_channel_mix": "channel_mix",
          "mamba2_train": "mamba2", "mamba2_decode": "mamba2"}
STATE_KEYS = ("wkv", "att_x", "ffn_x", "ssd", "conv")


@contextlib.contextmanager
def forced_mixers():
    """Teacher-force the recurrent mixers (RWKV6's time and channel mix,
    Mamba2's chunked and recurrent forms) onto a recorded forward.

    In ``ctl["mode"] == "record"`` every mixer call (a full forward's)
    keeps its input and output.  In any other mode a call's input is
    replaced by the recorded input of the same layer at the same
    positions (all of them up to its length, or the one position
    ``ctl["pos"]``), and its output is held to the recorded output there
    (``LM_TOL``; the largest difference per mode in ``ctl["diff"]``).
    The state a mixer carries goes on through the caches as usual, so a
    prefill and the decode steps after it are checked mixer by mixer, on
    the forward's inputs, without the drift that differences between two
    runs' matmul shapes gather over many layers."""
    from repro_torch.models import ssm as ssm_lib
    orig = {n: getattr(ssm_lib, n) for n in MIXERS}
    ctl = {"mode": "record", "pos": None, "diff": {},
           "rec": {k: [] for k in MIXERS.values()},
           "calls": dict.fromkeys(MIXERS.values(), 0)}

    def wrap(name):
        key = MIXERS[name]

        def spy(x, *args, **kw):
            if ctl["mode"] == "record":
                res = orig[name](x, *args, **kw)
                ctl["rec"][key].append((x, res[0] if isinstance(res, tuple)
                                        else res))
                return res
            rec = ctl["rec"][key]
            xs, outs = rec[ctl["calls"][key] % len(rec)]
            ctl["calls"][key] += 1
            pos = ctl["pos"]
            part = slice(0, x.shape[1]) if pos is None else \
                slice(pos, pos + 1)
            res = orig[name](xs[:, part], *args, **kw)
            out = res[0] if isinstance(res, tuple) else res
            mode = ctl["mode"]
            ctl["diff"][mode] = max(ctl["diff"].get(mode, 0.0), max_diff(
                out, outs[:, part], LM_TOL, f"{name} {mode}"))
            return res
        return spy

    for name in MIXERS:
        setattr(ssm_lib, name, wrap(name))
    try:
        yield ctl
    finally:
        for name, fn in orig.items():
            setattr(ssm_lib, name, fn)


def mixer_check(params, cfg, prompt):
    """The SSM mixers of an rwkv6 or zamba2 stack at full size, forced
    onto a forward over the whole prompt (``forced_mixers``): a prefill
    over the prompt less its last token (``prefill``), the decode step
    of that token on the prefill's state (``decode``), and the prompt
    less its last token decoded one token at a time from zero states
    (``steps``); and the states after those steps against the prefill's
    (``state_*``), all within ``test_archs``'s tolerance."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.lm_decode import _grow_caches
    b, s = prompt.shape[0], prompt.shape[1] - 1
    with torch.no_grad(), forced_mixers() as ctl:
        T.forward_hidden(params, prompt, cfg, impl="naive")
        ctl["mode"] = "prefill"
        _, pre = T.prefill_step(params, prompt[:, :s], cfg, impl="naive")
        ctl["mode"], ctl["pos"] = "decode", s
        T.decode_step(params, _grow_caches(pre, cfg, b, s, s + 1),
                      prompt[:, s:], s, cfg)
        ctl["mode"] = "steps"
        caches = T.init_caches(cfg, b, s, device=prompt.device)
        for t in range(s):
            ctl["pos"] = t
            _, caches = T.decode_step(params, caches, prompt[:, t:t + 1], t,
                                      cfg)
    torch.cuda.synchronize()
    out = {"mixer_" + k: v for k, v in ctl["diff"].items()}
    out.update({"state_" + k: max_diff(caches[k], pre[k], LM_TOL,
                                       f"state {k}")
                for k in STATE_KEYS if k in pre})
    return out


def layer_drift(params, cfg, prompt):
    """How a stack amplifies f32 noise: run layer by layer over the prompt
    less its last token and over the whole prompt (the runs differ only
    in their matmuls' shapes), the largest |difference| of the hidden
    state at the shorter run's last position after the first and the
    last layer, and the geometric-mean growth per layer."""
    import torch
    from repro_torch.models import transformer as T
    s = prompt.shape[1] - 1

    def block(x, i):
        lp = T._layer(params["layers"], i)
        if cfg.ssm.kind == "rwkv6":
            return T.rwkv_block(x, lp, cfg)[0]
        return T.mamba_block(x, lp, cfg)

    with torch.no_grad():
        xa = T._embed_stream(params, prompt[:, :s], cfg, None)
        xb = T._embed_stream(params, prompt, cfg, None)
        drift = []
        for i in range(cfg.n_layers):
            xa, xb = block(xa, i), block(xb, i)
            drift.append(float((xa[:, -1] - xb[:, s - 1]).abs().max()))
    growth = (drift[-1] / drift[0]) ** (1 / (len(drift) - 1)) \
        if drift[0] > 0 and len(drift) > 1 else None
    return {"first_layer": drift[0], "last_layer": drift[-1],
            "growth_per_layer": growth}


def prefill_drops(params, cfg, prompt):
    """Dropped MoE assignments in one prefill, counted around
    ``moe._dispatch_group`` (a dropped assignment goes to the spare row,
    ``ROADMAP.md`` R5)."""
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T
    counts = []
    dispatch = moe_lib._dispatch_group

    def counting(*args):
        out = dispatch(*args)
        counts.append(int((~out[2]).sum()))
        return out

    moe_lib._dispatch_group = counting
    try:
        with torch.no_grad():
            T.prefill_step(params, prompt, cfg, impl="naive")
    finally:
        moe_lib._dispatch_group = dispatch
    tokens = prompt.shape[0] * prompt.shape[1]
    return {"dropped": sum(counts),
            "assignments": tokens * cfg.moe.top_k * len(counts),
            "capacity": moe_lib.capacity(tokens, cfg),
            "per_layer": counts}


def profile_decode(params, cfg, prompt, steps: int = 3):
    """CUDA launches, device time and device-busy share per decode step,
    from ``torch.profiler`` over ``steps`` steps after a fresh prefill."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    from repro_torch.serving.lm_decode import _grow_caches, greedy_sample
    b, s = prompt.shape
    with torch.no_grad():
        logits, caches = T.prefill_step(params, prompt, cfg, impl="naive")
        caches = _grow_caches(caches, cfg, b, s, s + steps + 1)
        token = greedy_sample(logits, cfg.vocab)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pos in range(s, s + steps):
                logits, caches = T.decode_step(params, caches, token, pos,
                                               cfg)
                token = greedy_sample(logits, cfg.vocab)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"launches_per_step": "not measured",
                "device_busy_share": "not measured"}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        cnt, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"profiled_steps": steps,
            "launches_per_step": len(kernels) / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_share": busy_us * 1e-6 / wall,
            "top_kernels_by_device_time": [
                [name[:60], cnt / steps, us / 1e3 / steps]
                for name, (cnt, us) in top]}


def timed_generate(params, cfg, prompt, max_new):
    """``generate``'s own loop with each span ended by a synchronize:
    (tokens, prefill seconds, decode seconds per step)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.lm_decode import _grow_caches, greedy_sample
    b, s = prompt.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = T.prefill_step(params, prompt, cfg, impl="naive")
        caches = _grow_caches(caches, cfg, b, s, s + max_new)
        token = greedy_sample(logits, cfg.vocab)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
        toks, steps = [token], []
        for pos in range(s, s + max_new - 1):
            t0 = time.perf_counter()
            logits, caches = T.decode_step(params, caches, token, pos, cfg)
            token = greedy_sample(logits, cfg.vocab)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            toks.append(token)
    return torch.cat(toks, 1).cpu().numpy(), prefill, steps


def free_card():
    import gc
    import torch
    from repro_torch.core.engine import search
    search.clear_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def timed_model(name, seed, rng, f32_over=None):
    """One arch at full width and depth from ``init_params(device=
    "cuda")``: ``generate`` on LM_BATCH prompts of LM_PROMPT tokens for
    LM_NEW new ones in bf16 compute, then its loop twice with each span
    ended by a synchronize, launches per decode step from the profiler,
    the MoE prefill's dropped assignments, the f32 consistency check on
    the same weights (``f32_over`` replaces config fields for it), and
    the peak memory.  The weights are freed before it returns."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.params import init_params, param_count, \
        tree_leaves
    from repro_torch.serving import generate
    cfg = dataclasses.replace(get_arch(name), remat="none")
    free_card()
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "allocated_before_bytes": torch.cuda.memory_allocated()}
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    leaves = [t for _, t in tree_leaves(params)]
    n_params = param_count(cfg)
    assert n_params == sum(t.numel() for t in leaves)
    row.update(params=n_params,
               param_bytes=sum(t.numel() * t.element_size() for t in leaves),
               init_s=time.perf_counter() - t0)
    del leaves
    prompt = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT + 1)).astype(
        np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, prompt[:, :LM_PROMPT], cfg, max_new=LM_NEW,
                   impl="naive")
    row["first_generate_s"] = time.perf_counter() - t0
    assert out.shape == (LM_BATCH, LM_NEW), out.shape
    assert ((out >= 0) & (out < cfg.vocab)).all()
    on_card = torch.as_tensor(prompt[:, :LM_PROMPT], device="cuda")
    runs = []
    for _ in range(2):
        toks, prefill, steps = timed_generate(params, cfg, on_card, LM_NEW)
        assert np.array_equal(toks, out), "timed loop != generate"
        runs.append({"prefill_ms": prefill * 1e3,
                     "decode_ms_per_token_median":
                         statistics.median(steps) * 1e3,
                     "decode_ms_min_max": [min(steps) * 1e3,
                                           max(steps) * 1e3],
                     "tokens_per_s": LM_BATCH * LM_NEW
                     / (prefill + sum(steps)),
                     "decode_tokens_per_s": LM_BATCH
                     / statistics.median(steps)})
    row["bf16_generate"] = {"batch": LM_BATCH, "prompt": LM_PROMPT,
                            "new": LM_NEW, "runs": runs}
    row["profile"] = profile_decode(params, cfg, on_card)
    if "device_ms_per_step" in row["profile"]:
        # the profiler slows the host; the unprofiled step's wall is
        # the decode median of the last timed run
        row["profile"]["device_share_of_unprofiled_step"] = (
            row["profile"]["device_ms_per_step"]
            / runs[-1]["decode_ms_per_token_median"])
    if cfg.moe is not None:
        row["prefill_moe_drops"] = prefill_drops(params, cfg, on_card)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                **(f32_over(cfg) if f32_over else {}))
    row["f32_consistency_max_diff"] = consistency(
        params, cfg32, torch.as_tensor(prompt, device="cuda"))
    row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del params
    free_card()
    return row


def drop_free(cfg):
    """``tests/test_archs.py``'s drop-free MoE capacity for the oracle:
    prefill and forward route different token counts, so only drop-free
    dispatch makes them comparable."""
    return {"moe": dataclasses.replace(cfg.moe, capacity_factor=16.0)}


def family_check(name, seed, rng):
    """An SSM, hybrid or audio arch at full size: one ``generate`` in
    bf16 compute (whisper's frames from the seed, normal x 0.02), and at
    f32 compute the consistency check and, for SSM states, the
    prefill's final states against token-by-token decoding."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.params import init_params, param_count
    from repro_torch.serving import generate
    cfg = dataclasses.replace(get_arch(name), remat="none")
    free_card()
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": param_count(cfg),
           "allocated_before_bytes": torch.cuda.memory_allocated()}
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    row["init_s"] = time.perf_counter() - t0
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (LM_BATCH, LM_PROMPT + 1)),
                             dtype=torch.int32, device="cuda")
    frames = None
    if cfg.family == "audio":
        frames = torch.as_tensor(
            rng.normal(size=(LM_BATCH, cfg.encdec.enc_seq, cfg.d_model))
            * 0.02, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, prompt[:, :LM_PROMPT], cfg, max_new=LM_NEW,
                   frames=frames, impl="naive")
    row["bf16_generate_s"] = time.perf_counter() - t0
    assert out.shape == (LM_BATCH, LM_NEW), out.shape
    assert ((out >= 0) & (out < cfg.vocab)).all()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    # rwkv6-3b's random weights amplify f32 noise at every layer
    # (``layer_drift``), so its whole-stack numbers are kept unchecked
    # and its mixers are checked one by one on the forward's inputs
    row["f32_consistency_max_diff"] = consistency(
        params, cfg32, prompt, frames=frames, checked=cfg.family != "ssm")
    if cfg.family in ("ssm", "hybrid"):
        row["f32_mixers_and_states_max_diff"] = mixer_check(params, cfg32,
                                                            prompt)
    if cfg.family == "ssm":
        row["f32_layer_drift_unchecked"] = layer_drift(params, cfg32, prompt)
    row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del params, frames
    free_card()
    return row


def reduced_configs():
    """(tag, config, prompt length) of the card-vs-CPU checks, f32."""
    from repro_torch.configs import get_arch
    from repro_torch.models.config import reduced

    def small(name, **over):
        return dataclasses.replace(reduced(get_arch(name)), remat="none",
                                   compute_dtype="float32", **over)
    moe = small("qwen2-moe-a2.7b")
    return [
        ("nemotron-4-15b", small("nemotron-4-15b"), 12),
        ("qwen2-72b", small("qwen2-72b"), 12),
        ("qwen2-vl-2b", small("qwen2-vl-2b"), 12),
        ("qwen3-8b kv_quant", small("qwen3-8b", kv_quant=True), 12),
        ("moonshot-v1-16b-a3b", small("moonshot-v1-16b-a3b"), 12),
        # 64 tokens x top-2 over 8 experts at capacity 8: drops certain
        ("qwen2-moe-a2.7b dropping", dataclasses.replace(
            moe, moe=dataclasses.replace(moe.moe, capacity_factor=0.25)), 32),
        ("rwkv6-3b", small("rwkv6-3b"), 12),
        ("zamba2-7b 4 layers", small("zamba2-7b", n_layers=4), 12),
        ("whisper-large-v3", small("whisper-large-v3"), 12),
        ("mamba2 (constructed)", small("zamba2-7b", family="ssm",
                                       hybrid_attn_every=0), 12),
    ]


def lm_phase(smi):
    """The LM serving path on the card: qwen3-8b and qwen2-moe-a2.7b at
    full width and depth (``generate`` timed, launches per decode step,
    f32 consistency), gemma3-1b at full size on a prompt that wraps its
    rings, one full-width layer's prefill with ``impl="flash"`` against
    ``"naive"``, rwkv6-3b, zamba2-7b and whisper-large-v3 at full size,
    and reduced configs of every family on the card against the port on
    the CPU."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count, \
        params_from_numpy
    from repro_torch.serving import generate
    t_phase = time.perf_counter()
    summ = {}
    rng = np.random.default_rng(SEED + 20)

    # ---- qwen3-8b, full width and depth, random weights from a seed ----
    row = timed_model("qwen3-8b", SEED, rng)
    summ["qwen3_8b"] = row
    log("[lm] qwen3-8b: " + json.dumps(row) + f" ({smi})")

    # ---- one full-width layer's prefill at S = 2048, flash vs naive ----
    cfg = dataclasses.replace(get_arch("qwen3-8b"), remat="none")
    one = dataclasses.replace(cfg, n_layers=1)
    params = init_params(one, seed=SEED + 1, device="cuda")
    long = torch.as_tensor(rng.integers(0, cfg.vocab, (1, LONG_PREFILL)),
                           dtype=torch.int32, device="cuda")
    row = {}
    # f32: the blocked and the naive softmax sum in other orders; logits
    # of scale ~1.3 over d = 4096 carry f32 noise of about 2e-5
    for dtype, tol in (("float32", dict(atol=1e-4, rtol=1e-4)),
                       ("bfloat16", dict(atol=3e-2, rtol=3e-2))):
        c = dataclasses.replace(one, compute_dtype=dtype)
        res = {}
        for impl in ("naive", "flash"):
            with torch.no_grad():
                T.prefill_step(params, long, c, impl=impl)      # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[impl] = T.prefill_step(params, long, c, impl=impl)
                torch.cuda.synchronize()
                res[impl + "_ms"] = (time.perf_counter() - t0) * 1e3
        (ln, cn), (lf, cf) = res["naive"], res["flash"]
        row[dtype] = {"naive_ms": res["naive_ms"],
                      "flash_ms": res["flash_ms"],
                      "logits_max_diff": max_diff(lf, ln, tol, dtype),
                      "cache_max_diff": max(max_diff(cf[k], cn[k], tol, k)
                                            for k in cn)}
    summ["flash_layer_s2048"] = row
    log("[lm] qwen3-8b one layer, S=2048, flash vs naive: "
        + json.dumps(row))
    del params, res, ln, cn, lf, cf

    # ---- gemma3-1b, full size, a prompt that wraps the 512-slot rings --
    cfg = dataclasses.replace(get_arch("gemma3-1b"), remat="none")
    free_card()
    params = init_params(cfg, seed=SEED + 2, device="cuda")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (2, GEMMA_PROMPT + 1)),
                             dtype=torch.int32, device="cuda")
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": param_count(cfg), "prompt": GEMMA_PROMPT}
    row["f32_consistency_max_diff"] = consistency(
        params, dataclasses.replace(cfg, compute_dtype="float32"), prompt)
    t0 = time.perf_counter()
    out = generate(params, prompt[:, :GEMMA_PROMPT], cfg, max_new=8,
                   impl="naive")
    row["bf16_generate_s"] = time.perf_counter() - t0
    assert out.shape == (2, 8) and ((out >= 0) & (out < cfg.vocab)).all()
    summ["gemma3_1b"] = row
    log("[lm] gemma3-1b: " + json.dumps(row))
    del params, prompt

    # ---- qwen2-moe-a2.7b, full width and depth (60.6 GB of f32) --------
    row = timed_model("qwen2-moe-a2.7b", SEED + 3, rng, f32_over=drop_free)
    summ["qwen2_moe_a2_7b"] = row
    log("[lm] qwen2-moe-a2.7b: " + json.dumps(row) + f" ({smi})")

    # ---- the SSM, hybrid and audio archs at full size -------------------
    for i, name in enumerate(("rwkv6-3b", "zamba2-7b", "whisper-large-v3")):
        row = family_check(name, SEED + 4 + i, rng)
        summ[name] = row
        log(f"[lm] {name}: " + json.dumps(row) + f" ({smi})")

    # ---- reduced configs: the card against the port on the CPU --------
    tol = dict(atol=1e-5, rtol=1e-4)
    cards = {}
    for tag, c, s in reduced_configs():
        cpu = init_params(c, seed=SEED, device="cpu")
        card = params_from_numpy(cpu, device="cuda")
        toks = rng.integers(0, c.vocab, (2, s + 1)).astype(np.int32)
        patches = frames = None
        if c.vlm is not None:
            patches = (rng.normal(size=(2, c.vlm.num_patches, c.d_model))
                       * 0.02).astype(np.float32)
        if c.family == "audio":
            frames = (rng.normal(size=(2, c.encdec.enc_seq, c.d_model))
                      * 0.02).astype(np.float32)
        got = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            with torch.no_grad():
                lp, caches = T.prefill_step(p, toks[:, :s], c,
                                            patches=patches, frames=frames,
                                            impl="naive")
            got[dev] = (lp, caches, generate(p, toks[:, :s], c, max_new=4,
                                             patches=patches, frames=frames,
                                             impl="naive", device=dev))
        (lg, cg, og), (lc, cc, oc) = got["cuda"], got["cpu"]
        d = {"logits": max_diff(lg.cpu(), lc, tol, tag),
             "caches": max(max_diff(cg[k].cpu(), cc[k], tol, f"{tag} {k}")
                           for k in cc)}
        assert np.array_equal(og, oc), (tag, og, oc)
        if c.moe is not None:
            d["prefill_drops"] = prefill_drops(
                card, c, torch.as_tensor(toks[:, :s], device="cuda"))["dropped"]
            assert d["prefill_drops"] > 0 or "dropping" not in tag, (tag, d)
        cards[tag] = d
    summ["reduced_card_vs_cpu_max_diff"] = cards
    log("[lm] reduced configs, card vs CPU: " + json.dumps(cards)
        + "; generate tokens equal")
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[lm] summary: " + json.dumps(summ) + f" ({smi})")
    return summ



# -------------------------------------------------------------- [train]

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8   # gemma3-1b, full size
QWEN_TRAIN_LAYERS, QWEN_TRAIN_STEPS = 8, 3        # qwen3-8b, full width
# the card-vs-CPU step: loss, and the first moments (linear in the
# gradient) relative to each leaf's largest; a parameter whose moment is
# above 1e-4 of its leaf's largest moves by about lr * sign(g) and must
# agree within 1e-6, the rest (gradients within float noise of 0) may
# move either way and are counted, at most 0.1% of all
TRAIN_TOL = dict(loss=1e-5, moment=1e-4, sure=1e-4, param=1e-6,
                 flipped=1e-3)


def token_batch(cfg, b, s, rng, device):
    """A training batch: tokens and labels, a VLM's patches and whisper's
    frames as normal x 0.02 (f32), all on ``device``."""
    import torch
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
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def profile_device(fn):
    """Launches, device ms and device-busy share of one call of ``fn``
    from ``torch.profiler``; returns (row, what ``fn`` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"launches": "not measured",
                "device_busy_share": "not measured"}, out
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        cnt, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"launches": len(kernels), "device_ms": busy_us / 1e3,
            "profiled_wall_ms": wall * 1e3,
            "device_busy_share_profiled": busy_us * 1e-6 / wall,
            "top_kernels_by_device_time": [
                [name[:60], cnt, us / 1e3] for name, (cnt, us) in top]}, out


def profile_train(cfg, step, opt_cfg, state, batch):
    """One whole train step under the profiler, then its two parts on
    the state it left: the loss with its gradients
    (``_value_and_grad``), and ``adamw_update``.  Returns (rows, state
    after the whole step and the second update)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_update, cosine_schedule
    rows = {}
    rows["step"], (params, opt, _) = profile_device(
        lambda: step(*state, batch))
    rows["loss_and_grads"], (_, grads) = profile_device(
        lambda: T._value_and_grad(params, batch, cfg, "naive", "dense"))
    sched = cosine_schedule(opt_cfg.warmup, opt_cfg.total_steps,
                            opt_cfg.min_lr_frac)
    rows["adamw_update"], (params, opt, _) = profile_device(
        lambda: adamw_update(params, grads, opt, opt_cfg, sched))
    return rows, (params, opt)


def gemma_train(rng):
    """gemma3-1b at full width and depth: TRAIN_STEPS steps through
    ``make_train_step`` and ``train_loop`` (the loss logged each step),
    one blocking ``save`` of the whole state (the loop's last step) and
    one ``restore``, every leaf bit-equal, then one step and its two
    parts under the profiler."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count, \
        tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import train_loop
    cfg = get_arch("gemma3-1b")
    free_card()
    row = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": param_count(cfg), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": cfg.remat,
           "compute_dtype": cfg.compute_dtype, "impl": "naive"}
    params = init_params(cfg, seed=SEED + 30, device="cuda")
    state = (params, adamw_init(params))
    row["state_bytes"] = sum(t.numel() * t.element_size()
                             for part in (state[0], state[1])
                             for _, t in tree_leaves(part))
    opt_cfg = AdamWConfig(lr=1e-3, warmup=2, total_steps=TRAIN_STEPS)
    step = T.make_train_step(cfg, opt_cfg, impl="naive")

    def step_fn(st, batch):
        p, o, m = step(*st, {"tokens": torch.as_tensor(batch[0],
                                                       device="cuda"),
                             "labels": torch.as_tensor(batch[1],
                                                       device="cuda")})
        return (p, o), m

    marks, losses = [], []

    def on_metrics(s, m):
        marks.append(time.perf_counter())     # float(loss) synchronized
        losses.append(m["loss"])
        log(f"[train] gemma3-1b step {s}  loss {m['loss']:.4f}  gnorm "
            f"{m['grad_norm']:.3f}")

    ckdir = Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
    row["disk_free_gb_before_save"] = shutil.disk_usage(ckdir).free / 1e9
    try:
        ckpt = CheckpointManager(ckdir, keep_last_k=1, async_save=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist = train_loop(
            step_fn, state,
            lambda s: TokenPipeline(SEED, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab,
                                    start_step=s),
            ckpt, total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
            log_every=1, on_metrics=on_metrics)
        t_end = time.perf_counter()
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        assert len(losses) == TRAIN_STEPS and all(
            np.isfinite(x) for x in losses), losses
        steps_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
        row["losses"] = losses
        row["first_step_ms"] = steps_ms[0]
        row["step_ms_median"] = statistics.median(steps_ms[1:])
        row["step_ms_min_max"] = [min(steps_ms[1:]), max(steps_ms[1:])]
        row["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (
            row["step_ms_median"] / 1e3)
        # the loop's last act is one blocking save of the whole state
        row["checkpoint_save_s"] = t_end - marks[-1]
        row["checkpoint_bytes"] = sum(f.stat().st_size
                                      for f in ckdir.rglob("*.npz"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_step, back, _ = ckpt.restore(state)
        torch.cuda.synchronize()
        row["checkpoint_restore_s"] = time.perf_counter() - t0
        assert got_step == TRAIN_STEPS
        for (path, a), (_, b) in zip(
                tree_leaves({"p": state[0], "o": state[1]}),
                tree_leaves({"p": back[0], "o": back[1]})):
            assert a.dtype == b.dtype and a.device == b.device, path
            assert torch.equal(a, b), f"restored leaf {path} differs"
        row["restored_leaves_bit_equal"] = True
        del back
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    batch = token_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, rng, "cuda")
    prof, state = profile_train(cfg, step, opt_cfg, state, batch)
    if "device_ms" in prof["step"]:
        prof["step"]["device_share_of_unprofiled_step"] = (
            prof["step"]["device_ms"] / row["step_ms_median"])
    row["profile"] = prof
    del state, params, batch
    free_card()
    return row


def qwen_train(rng):
    """qwen3-8b at full width with QWEN_TRAIN_LAYERS of its 36 layers
    (16 bytes a parameter is 131 GB at full depth): QWEN_TRAIN_STEPS
    steps, each ended by a synchronize."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = dataclasses.replace(get_arch("qwen3-8b"),
                              n_layers=QWEN_TRAIN_LAYERS)
    free_card()
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "full_depth_layers": get_arch("qwen3-8b").n_layers,
           "params": param_count(cfg), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": cfg.remat}
    params = init_params(cfg, seed=SEED + 31, device="cuda")
    state = (params, adamw_init(params))
    step = T.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup=1,
                                              total_steps=10),
                             impl="naive")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(QWEN_TRAIN_STEPS):
        batch = token_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, rng, "cuda")
        t0 = time.perf_counter()
        p, o, m = step(*state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        state = (p, o)
    assert all(np.isfinite(x) for x in losses), losses
    row.update(losses=losses, step_ms=times,
               step_ms_after_first_median=statistics.median(times[1:]),
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
               / (statistics.median(times[1:]) / 1e3),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del state, params, p, o
    free_card()
    return row


def flash_backward_check(rng):
    """One qwen3-8b layer (and the embedding and head) at S = 2048, f32
    compute: every parameter's gradient through ``impl="flash"`` (the
    blocked backward) against autograd through ``impl="naive"``, within
    2e-4 of each leaf's largest gradient; the ms of each."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_leaves
    cfg = dataclasses.replace(get_arch("qwen3-8b"), n_layers=1,
                              compute_dtype="float32", remat="none")
    free_card()
    params = init_params(cfg, seed=SEED + 32, device="cuda")
    batch = token_batch(cfg, 1, LONG_PREFILL, rng, "cuda")
    res = {}
    for impl in ("naive", "flash", "naive", "flash"):    # warm, then timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[impl] = T._value_and_grad(params, batch, cfg, impl, "dense")
        torch.cuda.synchronize()
        res[impl + "_ms"] = (time.perf_counter() - t0) * 1e3
    (ln, gn), (lf, gf) = res["naive"], res["flash"]
    worst = 0.0
    for (path, a), (_, b) in zip(tree_leaves(gf), tree_leaves(gn)):
        scale = float(b.abs().max())
        rel = float((a - b).abs().max()) / scale if scale else 0.0
        assert rel <= 2e-4, (path, rel)
        worst = max(worst, rel)
    row = {"seq": LONG_PREFILL, "naive_ms": res["naive_ms"],
           "flash_ms": res["flash_ms"],
           "loss_diff": abs(float(lf) - float(ln)),
           "grad_max_rel_diff": worst}
    assert row["loss_diff"] <= 1e-4, row
    del params, res, gn, gf
    free_card()
    return row


def replay_check():
    """Reduced qwen3-8b through ``train_loop`` on the card, clean and with
    faults at steps 4 and 8 (checkpoints every 3): losses and final
    parameters bit-equal."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import FaultInjector, train_loop
    cfg = reduced(get_arch("qwen3-8b"))
    step = T.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup=2,
                                              total_steps=10), impl="naive")

    def step_fn(st, batch):
        p, o, m = step(*st, {"tokens": torch.as_tensor(batch[0],
                                                       device="cuda"),
                             "labels": torch.as_tensor(batch[1],
                                                       device="cuda")})
        return (p, o), m

    runs = {}
    for tag, faults in (("clean", []), ("faulted", [4, 8])):
        params = init_params(cfg, seed=SEED, device="cuda")
        with tempfile.TemporaryDirectory() as d:
            (p, _), hist = train_loop(
                step_fn, (params, adamw_init(params)),
                lambda s: TokenPipeline(SEED, 4, 64, cfg.vocab,
                                        start_step=s),
                CheckpointManager(d, keep_last_k=2), total_steps=10,
                ckpt_every=3, injector=FaultInjector(faults), log_every=1)
        runs[tag] = (p, [h["loss"] for h in hist])
    (pc, lc), (pf, lf) = runs["clean"], runs["faulted"]
    assert lc == lf, ("losses differ after replay", lc, lf)
    for (path, a), (_, b) in zip(tree_leaves(pc), tree_leaves(pf)):
        assert torch.equal(a, b), f"replayed parameter {path} differs"
    return {"steps": 10, "faults_at": [4, 8], "losses": lc,
            "losses_bit_equal": True, "params_bit_equal": True}


def reduced_train_configs():
    """(tag, config) of the card-vs-CPU train step: every arch's reduced
    config at f32 (zamba2 with 7 layers at ``hybrid_attn_every`` 6 so
    its shared block trains; MoE at drop-free capacity)."""
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.models.config import reduced
    out = []
    for name in list_archs():
        base = get_arch(name)
        layers = 3 if base.window_pattern else \
            7 if base.hybrid_attn_every else 2
        over = {"hybrid_attn_every": 6} if base.hybrid_attn_every else {}
        cfg = reduced(base, layers=layers)
        if cfg.moe is not None:
            over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=16.0)
        out.append((name, dataclasses.replace(
            cfg, remat="none", compute_dtype="float32", **over)))
    return out


def reduced_train_check(rng):
    """One train step of every arch's reduced config on the card and on
    the CPU from the same weights and batch (TRAIN_TOL)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, params_from_numpy, \
        tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    rows = {}
    for tag, cfg in reduced_train_configs():
        cpu = init_params(cfg, seed=SEED, device="cpu")
        card = params_from_numpy(cpu, device="cuda")
        batch = token_batch(cfg, 2, 16, rng, "cpu")
        out = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            step = T.make_train_step(cfg, AdamWConfig(lr=1e-3),
                                     impl="naive")
            out[dev] = step(p, adamw_init(p),
                            {k: v.to(dev) for k, v in batch.items()})
        (pg, og, mg), (pc, oc, mc) = out["cuda"], out["cpu"]
        d = {"loss": abs(float(mg["loss"]) - float(mc["loss"]))}
        assert d["loss"] <= TRAIN_TOL["loss"], (tag, d)
        worst_m = 0.0
        flipped = total = 0
        params_g = dict(tree_leaves(pg))
        params_c = dict(tree_leaves(pc))
        for path, m_g in tree_leaves(og["m"]):
            m_c = dict(tree_leaves(oc["m"]))[path]
            scale = float(m_c.abs().max())
            if not scale:
                continue
            diff = (m_g.cpu() - m_c).abs()
            worst_m = max(worst_m, float(diff.max()) / scale)
            sure = m_c.abs() > TRAIN_TOL["sure"] * scale
            pdiff = (params_g[path].cpu() - params_c[path]).abs()
            if bool(sure.any()):
                assert float(pdiff[sure].max()) <= TRAIN_TOL["param"], \
                    (tag, path)
            flipped += int((pdiff > TRAIN_TOL["param"]).sum())
            total += pdiff.numel()
        assert worst_m <= TRAIN_TOL["moment"], (tag, worst_m)
        assert flipped <= TRAIN_TOL["flipped"] * total, (tag, flipped)
        d.update(moment_max_rel_diff=worst_m, params_flipped=flipped)
        rows[tag] = d
    return rows


def train_launcher_child():
    """``python -m repro_torch.launch.train`` without ``--device`` (so on
    the card) at reduced scale, in a child process."""
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen3-8b", "--scale", "reduced", "--steps", "20",
             "--ckpt-dir", d], env=env, capture_output=True, text=True,
            timeout=300, cwd=str(ROOT))
        wall = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-3000:]
    assert "done: 20 steps" in res.stdout, res.stdout
    return {"wall_s": wall, "last_lines": res.stdout.strip().splitlines()[-3:]}


def train_phase(smi):
    """LM training on the card (no TPU kernel lies on this path):
    gemma3-1b at full size (steps, tokens/s, launches, busy share, peak
    memory, checkpoint save and restore; one step and its two parts
    under the profiler), qwen3-8b at full width with 8
    layers, the flash backward against naive autograd on one layer at
    S = 2048, exact replay after faults, every arch's reduced config card
    against CPU, and the launcher in a child process."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 40)
    summ = {}
    summ["gemma3_1b"] = gemma_train(rng)
    log("[train] gemma3-1b: " + json.dumps(summ["gemma3_1b"]) + f" ({smi})")
    summ["qwen3_8b_8_layers"] = qwen_train(rng)
    log("[train] qwen3-8b, 8 of 36 layers: "
        + json.dumps(summ["qwen3_8b_8_layers"]) + f" ({smi})")
    summ["flash_backward_s2048"] = flash_backward_check(rng)
    log("[train] qwen3-8b one layer, S=2048, flash vs naive backward: "
        + json.dumps(summ["flash_backward_s2048"]) + f" ({smi})")
    summ["exact_replay"] = replay_check()
    log("[train] exact replay after faults: "
        + json.dumps(summ["exact_replay"]))
    summ["reduced_card_vs_cpu"] = reduced_train_check(rng)
    log("[train] reduced configs, one step card vs CPU: "
        + json.dumps(summ["reduced_card_vs_cpu"]))
    summ["launcher"] = train_launcher_child()
    log("[train] launcher: " + json.dumps(summ["launcher"]))
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[train] summary: " + json.dumps(summ) + f" ({smi})")
    return summ


# ------------------------------------------------------------ [dryrun]

# qwen2-72b train_4k (80 layers x 16 microbatches, ~4.4x qwen3-8b's
# eager step) does not fit the script's time limit: it runs alone
# through the same CLI (PERF.md, PR 25)
DRYRUN_CELLS = [("qwen3-8b", "train_4k", "single"),
                ("qwen3-8b", "train_4k", "multi"),
                ("qwen2-moe-a2.7b", "decode_32k", "single"),
                ("rwkv6-3b", "long_500k", "single")]
DRYRUN_TIMEOUT = 900
SHARDED_TRAIN_STEPS = 3


def start_dryrun_children(out_dir):
    """One ``python -m repro_torch.launch.dryrun`` process per LM cell of
    DRYRUN_CELLS (CPU only: ``meta`` tensors on a fake process group),
    started together; returns the processes and their log files."""
    import atexit
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env["CUDA_VISIBLE_DEVICES"] = ""      # the abstract cells use no card
    procs = []

    def stop():                           # whatever way the script ends
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
    atexit.register(stop)
    for arch, shape, mesh in DRYRUN_CELLS:
        logf = open(Path(out_dir) / f"{arch}__{shape}__{mesh}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out_dir),
             "--force"], cwd=ROOT, env=env, stdout=logf,
            stderr=subprocess.STDOUT), logf, (arch, shape, mesh)))
    return procs


def dryrun_row(rec):
    mem, hlo, roof = rec["memory"], rec["hlo"], rec["roofline"]
    return {"status": rec["status"], "chips": rec["chips"],
            "flops_per_device": hlo["flops"],
            "useful_flops_ratio": roof.get("useful_flops_ratio"),
            "bytes_per_device_eager": hlo["bytes_accessed"],
            "collective_bytes": hlo["collective_bytes"],
            "dcn_bytes": hlo["dcn_bytes"],
            "collective_by_op": hlo["collective_by_op"],
            "peak_bytes_per_device": mem["peak_bytes_per_device"],
            "peak_over_80GB": mem["peak_bytes_per_device"] / 80e9,
            "argument_bytes": mem["argument_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "bottleneck": roof["bottleneck"],
            "step_time_lower_bound_s": roof["step_time_lower_bound_s"],
            "wall_s": rec["timing"]["build_s"] + rec["timing"]["run_s"],
            "timing": rec["timing"]}


def one_rank_mesh():
    """A one-rank NCCL group over a ``file://`` store and a (1, 1, 1)
    ("pod", "data", "model") mesh on cuda:0."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = tempfile.mktemp(prefix="repro_torch_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    return init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))


def full_local(t):
    from repro_torch.parallel.sharding import is_distributed
    return t.full_tensor() if is_distributed(t) else t


def gemma_batches(cfg, steps):
    from repro_torch.data.tokens import TokenPipeline
    pipe = TokenPipeline(SEED, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
    it = iter(pipe)
    return [next(it) for _ in range(steps)]


def sharded_gemma_train(mesh):
    """gemma3-1b at full size: SHARDED_TRAIN_STEPS steps of
    ``build_train`` on the mesh against the unsharded ``make_train_step``
    from the same weights and batches ([train]'s)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_train, shard_like
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import set_rules
    cfg = get_arch("gemma3-1b")
    batches = [{"tokens": torch.as_tensor(b[0], device="cuda"),
                "labels": torch.as_tensor(b[1], device="cuda")}
               for b in gemma_batches(cfg, SHARDED_TRAIN_STEPS)]
    row = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": SHARDED_TRAIN_STEPS, "impl": "naive", "accum": 1,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    # unsharded: the step [train] runs, with build_train's optimizer
    free_card()
    params = init_params(cfg, seed=SEED + 30, device="cuda")
    step = T.make_train_step(cfg, AdamWConfig(), accum=1, impl="naive")
    state, want_losses = (params, adamw_init(params)), []
    for b in batches:
        p, o, m = step(*state, b)
        state = (p, o)
        want_losses.append(float(m["loss"]))
    want = {k: v.cpu() for k, v in tree_leaves(state[0])}
    del state, params, p, o
    free_card()
    # sharded: the same weights placed on the mesh
    params = init_params(cfg, seed=SEED + 30, device="cuda")
    plan = build_train(cfg, ShapeSpec("t", "train", TRAIN_SEQ, TRAIN_BATCH),
                       mesh, impl="naive", accum=1)
    p, o = shard_like((params, adamw_init(params)), plan.in_shardings[:2])
    del params
    losses, marks = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        p, o, m = plan.fn(p, o, shard_like(b, plan.in_shardings[2]))
        losses.append(float(full_local(m["loss"])))
        marks.append(time.perf_counter())
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    row["step_ms"] = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
    set_rules(None)
    row["losses"] = losses
    row["unsharded_losses"] = want_losses
    row["loss_max_abs_diff"] = max(abs(a - b)
                                   for a, b in zip(losses, want_losses))
    worst, bit_equal = 0.0, True
    for path, leaf in tree_leaves(p):
        got = full_local(leaf).cpu()
        bit_equal &= bool(torch.equal(got, want[path]))
        worst = max(worst, float((got.float() - want[path].float())
                                 .abs().max()))
    row["params_bit_equal"] = bit_equal
    row["param_max_abs_diff"] = worst
    row["losses_bit_equal"] = losses == want_losses
    assert row["loss_max_abs_diff"] <= TRAIN_TOL["loss"], row
    assert bit_equal or worst <= TRAIN_TOL["param"], row
    del p, o, m, want
    free_card()
    return row


def sharded_qwen_serve(mesh):
    """qwen3-8b at full width, bf16 weights: ``build_prefill`` then
    ``build_decode`` on the mesh against ``prefill_step`` /
    ``decode_step`` (B = 8, S = 512)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import (build_decode, build_prefill,
                                          shard_like)
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.parallel.sharding import set_rules
    cfg = get_arch("qwen3-8b")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    free_card()
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      init_params(cfg, seed=SEED + 32, device="cuda"))
    rng = np.random.default_rng(SEED + 33)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                             dtype=torch.int32, device="cuda")
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (b, 1)),
                          dtype=torch.int32, device="cuda")
    row = {"arch": cfg.name, "batch": b, "seq": s, "params": "bf16"}
    with torch.no_grad():
        want_pl, want_pc = T.prefill_step(params, tokens, cfg)
        want_dl, want_dc = T.decode_step(
            params, {k: v.clone() for k, v in want_pc.items()}, nxt, s - 1,
            cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plan = build_prefill(cfg, ShapeSpec("p", "prefill", s, b), mesh)
    args = shard_like((params, {"tokens": tokens}), plan.in_shardings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = plan.fn(*args)
    torch.cuda.synchronize()
    row["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    set_rules(None)
    caches = {k: full_local(v) for k, v in caches.items()}
    row["prefill_logits_max_abs_diff"] = float(
        (full_local(logits) - want_pl).abs().max())
    row["prefill_caches_bit_equal"] = all(
        torch.equal(caches[k], want_pc[k]) for k in want_pc)
    plan = build_decode(cfg, ShapeSpec("d", "decode", s, b), mesh)
    args = shard_like((params, caches, nxt, plan.args[3]),
                      plan.in_shardings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = plan.fn(*args)
    torch.cuda.synchronize()
    row["decode_ms"] = (time.perf_counter() - t0) * 1e3
    set_rules(None)
    row["decode_logits_max_abs_diff"] = float(
        (full_local(logits) - want_dl).abs().max())
    row["decode_caches_bit_equal"] = all(
        torch.equal(full_local(caches[k]), want_dc[k]) for k in want_dc)
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    scale = float(want_pl.abs().max())
    row["logits_scale"] = scale
    # f32 logits of bf16 weights: the same local GEMMs, so equal or within
    # one bf16 rounding of the logits' scale
    for k in ("prefill_logits_max_abs_diff", "decode_logits_max_abs_diff"):
        assert row[k] <= 2 ** -7 * scale, row
    del params, args, caches, logits, want_pc, want_dc
    free_card()
    return row


def multi_card_child(rank, world, store, out):
    """One NCCL rank of the several-card check (``--dryrun-rank-child``):
    gemma3-1b's sharded steps on a (world, 1) ("data", "model") mesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import build_train, shard_like
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw_init
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (world, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_arch("gemma3-1b")
        params = init_params(cfg, seed=SEED + 30, device=f"cuda:{rank}")
        plan = build_train(cfg, ShapeSpec("t", "train", TRAIN_SEQ,
                                          TRAIN_BATCH), mesh, impl="naive",
                           accum=1)
        p, o = shard_like((params, adamw_init(params)),
                          plan.in_shardings[:2])
        del params
        losses = []
        for b in gemma_batches(cfg, SHARDED_TRAIN_STEPS):
            bb = {"tokens": torch.as_tensor(b[0], device=f"cuda:{rank}"),
                  "labels": torch.as_tensor(b[1], device=f"cuda:{rank}")}
            p, o, m = plan.fn(p, o, shard_like(bb, plan.in_shardings[2]))
            losses.append(float(full_local(m["loss"])))
        if rank == 0:
            Path(out).write_text(json.dumps(losses))
    finally:
        dist.destroy_process_group()
    return 0


def multi_card_check(one_card_losses):
    import torch
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        store, out = Path(tmp) / "store", Path(tmp) / "losses.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--dryrun-rank-child", str(r), str(world), str(store),
             str(out)], cwd=ROOT, env=env) for r in range(world)]
        for proc in procs:
            assert proc.wait(timeout=DRYRUN_TIMEOUT) == 0, "rank failed"
        losses = json.loads(out.read_text())
    diff = max(abs(a - b) for a, b in zip(losses, one_card_losses))
    assert diff <= TRAIN_TOL["loss"] * 10, (losses, one_card_losses)
    return {"cards": world, "losses": losses, "loss_max_abs_diff": diff}


def dryrun_phase(smi, children, out_dir):
    """The launch layer's placement on the card and its dry run (see the
    module docstring, phase 16).  Returns (summary, reduced_top2
    launches of the ged-verify cell)."""
    import torch
    import torch.distributed as dist
    t_phase = time.perf_counter()
    summ = {}
    mesh = one_rank_mesh()
    try:
        summ["gemma3_1b_train"] = sharded_gemma_train(mesh)
        log("[dryrun] gemma3-1b build_train on a one-rank NCCL (1, 1, 1) "
            "mesh vs the unsharded step: "
            + json.dumps(summ["gemma3_1b_train"]) + f" ({smi})")
        summ["qwen3_8b_serve"] = sharded_qwen_serve(mesh)
        log("[dryrun] qwen3-8b build_prefill / build_decode on the same "
            "mesh vs prefill_step / decode_step: "
            + json.dumps(summ["qwen3_8b_serve"]) + f" ({smi})")
    finally:
        dist.destroy_process_group()
    if torch.cuda.device_count() >= 2:
        summ["multi_card"] = multi_card_check(
            summ["gemma3_1b_train"]["losses"])
        log("[dryrun] several cards: " + json.dumps(summ["multi_card"]))
    else:
        summ["multi_card"] = "not run: one card (unverified branch)"
    # ged-verify: concrete on the card, in a child process
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "ged-verify", "--mesh", "single", "--out", str(out_dir), "--force"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT)
    log(f"[dryrun] ged-verify child: rc={res.returncode} "
        f"{time.perf_counter() - t0:.1f} s: {res.stdout.strip()[-400:]}")
    cells = [(a, s, m) for a, s, m in DRYRUN_CELLS] + \
        [("ged-verify", "verify_db", "single")]
    for proc, logf, cell in children:
        try:
            rc = proc.wait(timeout=max(
                1, DRYRUN_TIMEOUT - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        logf.close()
        log(f"[dryrun] child {'/'.join(cell)}: rc={rc}")
    failed, ged_launches = [], 0
    for arch, shape, mesh_kind in cells:
        path = Path(out_dir) / f"{arch}__{shape}__{mesh_kind}.json"
        if not path.exists():
            failed.append((arch, shape, mesh_kind, "no record"))
            continue
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            failed.append((arch, shape, mesh_kind, rec.get("error")))
            log(f"[dryrun] {arch} {shape} {mesh_kind}: FAILED "
                + json.dumps({k: rec.get(k) for k in ("error", "traceback")}))
            continue
        row = dryrun_row(rec)
        if arch == "ged-verify":
            row["launches"] = rec["launches"]
            row["pairs_run_on_the_card"] = rec["n_pairs_run"]
            ged_launches = rec["launches"]["reduced_top2"]
        summ[f"{arch}__{shape}__{mesh_kind}"] = row
        log(f"[dryrun] {arch} {shape} {mesh_kind}: " + json.dumps(row)
            + f" (roofline at the H100 SXM5 data sheet; {smi})")
    assert not failed, f"dry-run cells failed: {failed}"
    assert ged_launches > 0, "the ged-verify cell launched no reduced_top2"
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[dryrun] summary: " + json.dumps(summ) + f" ({smi})")
    return summ, ged_launches


# ---------------------------------------------------- distributed meshes

DISTRIBUTED_TIMEOUT = 420    # seconds for one group of rank processes
# (ranks, process-group backend, mesh shape, mesh axes, "auto" too):
# (a) two gloo ranks sharing cuda:0, (b) one NCCL rank on the fast path,
# (c) one NCCL rank per card
DISTRIBUTED_GROUPS = {
    "a": (2, "gloo", (2, 1), ("data", "model"), True),
    "b": (1, "nccl", (1, 1, 1), ("pod", "data", "model"), False),
    "d": (2, "gloo", (2, 1), ("data", "model"), False),
}
# group (d)'s input (the [store] snapshot, its queries, the sub-store),
# written beside the rank records; group (b) reads its sub-store too
STORE_INPUT = "store_input.pkl"


def distributed_child(kind, rank, store, out):
    """One rank of a ``[distributed]`` group (``--distributed-rank-child``):
    ``"sharded"`` on ``[main]``'s pairs and, for groups that run it,
    ``"auto"`` all fused on ``[auto]``'s mix, through ``GedEngine(mesh=)``
    on a ``torch.distributed`` mesh from ``repro_torch.launch.mesh``; each
    path once to warm up, then once with the launch counts set to 0
    just before and read just after.  Pickles outcomes, walls, planning
    seconds, executor counters and launches to ``out``."""
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    from repro_torch import ged
    from repro_torch.core.engine.tensor_graphs import label_vocab
    from repro_torch.ged import api as ged_api
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_test_mesh
    if kind == "c":
        world, backend, shape, axes, with_auto = (
            torch.cuda.device_count(), "nccl",
            (torch.cuda.device_count(), 1), ("data", "model"), True)
    else:
        world, backend, shape, axes, with_auto = DISTRIBUTED_GROUPS[kind]
    torch.cuda.set_device(rank if kind == "c" else 0)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DISTRIBUTED_TIMEOUT))
    try:
        mesh = make_test_mesh(shape, axes, device_type="cuda")
        rec = {"rank": rank, "world": world, "backend": backend,
               "shape": shape, "axes": axes, "device": str(
                   torch.device("cuda", torch.cuda.current_device()))}
        inp = Path(out).parent / STORE_INPUT
        if kind == "d":
            rec.update(store_rank(mesh, pickle.loads(inp.read_bytes())))
            Path(out).write_bytes(pickle.dumps(rec))
            dist.barrier()
            return 0
        pairs, _ = aids_pairs(np.random.default_rng(SEED), PAIRS, 20, 30)
        big, _ = aids_pairs(np.random.default_rng(SEED + 5), BIG_PAIRS,
                            40, 60)
        vocab, mix_vocab = label_vocab(pairs), label_vocab(pairs + big)
        fused = ged.KernelDispatch(lsa_fused=True, bma_fused=True,
                                   merge_fused=True)
        planning = [0.0]
        build_plan = ged_api.build_plan

        def timed_plan(*args, **kwargs):
            t0 = time.perf_counter()
            plan = build_plan(*args, **kwargs)
            planning[0] += time.perf_counter() - t0
            return plan

        ged_api.build_plan = timed_plan

        def sharded():
            eng = []
            comp, ver, tc, tv = run_engine("sharded", pairs, "cuda", vocab,
                                           engine_out=eng, mesh=mesh)
            rec["batch_multiple"] = eng[0].batch_multiple
            return comp, ver, tc, tv, eng[0].stats

        def auto():
            comp, ver, stats, tc, tv, _ = auto_run(
                pairs + big, mix_vocab, "cuda", mesh=mesh, dispatch=fused)
            return comp, ver, tc, tv, stats

        paths = {"sharded": sharded, **({"auto": auto} if with_auto
                                        else {})}
        for fn in paths.values():           # warm-up: captures, first shapes
            fn()
        kops.reset_launch_counts()
        for name, fn in paths.items():
            planning[0] = 0.0
            comp, ver, tc, tv, stats = fn()
            rec[name] = {
                "outcomes": comp + ver, "compute_s": tc, "verify_s": tv,
                "planning_s": planning[0],
                "stats": {k: v for k, v in stats.items()
                          if k.startswith("executor_") or k in (
                              "dispatches", "host_solved")}}
        rec["launches"] = kops.launch_counts()
        if kind == "b" and inp.exists():
            rec["sub"] = sub_store_pass(mesh,
                                        pickle.loads(inp.read_bytes()))[1]
        Path(out).write_bytes(pickle.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def fused_store_opts():
    """``[store]``'s options with every kernel family fused."""
    from repro_torch import ged
    return dict(STORE_OPTS, use_kernel=True, dispatch=ged.KernelDispatch(
        lsa_fused=True, bma_fused=True, merge_fused=True))


def sub_store_pass(mesh, cfg):
    """The 2,000-graph sub-store ingested on ``mesh``: (the store, its
    ``range_search(tau=2)`` and ``top_k(4)`` hits, signatures, resident
    rows, executor counters and seconds)."""
    import torch
    from repro_torch import ged
    sub = cfg["graphs"]
    queries = [sub[q] for q in cfg["sub_qids"]]
    t0 = time.perf_counter()
    st = ged.GraphStore(sub, mesh=mesh, **fused_store_opts())
    torch.cuda.synchronize()
    ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = (st.search_batch(queries, STORE_TAUS[0]),
            [st.top_k(q, 4) for q in queries])
    torch.cuda.synchronize()
    return st, {"hits": hits, "sigs": st._cindex.sigs,
                "resident": resident_rows(st), "ingest_s": ingest,
                "search_s": time.perf_counter() - t0,
                "executor": dict(st.executor.stats)}


def resident_rows(store):
    """Per stage-0 bucket: (rows, resident rows of each local slice)."""
    return [(len(b.ids), [sh[0].shape[0] for sh in b.shards])
            for b in store._index.buckets]


def store_rank(mesh, cfg):
    """One rank of group (d): the ``[store]`` snapshot of 42,687 graphs
    opened on ``mesh`` and searched at each tau (launch counts set to 0
    just before the passes and read just after), then the sub-store
    ingested on ``mesh``, saved, mutated (graphs added and removed),
    saved again and reopened, with every call of the store's writers
    counted and the directory listed after each write, and
    ``register_corpus`` on a ``GedVerificationService`` over ``mesh``."""
    import torch
    import torch.distributed as dist
    from repro_torch import ged
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.ged_service import (GedRequest,
                                                 GedVerificationService)
    from repro_torch.store_io import graphstore_io
    writes = dict.fromkeys(("save_store", "append_journal"), 0)

    def counted(name, real):
        def call(*args, **kwargs):
            writes[name] += 1
            return real(*args, **kwargs)
        return call

    for name in writes:
        setattr(graphstore_io, name,
                counted(name, getattr(graphstore_io, name)))
    rec = {}
    t0 = time.perf_counter()
    big = ged.GraphStore.open(cfg["snapshot"], mesh=mesh,
                              **fused_store_opts())
    torch.cuda.synchronize()
    rec["open_s"] = time.perf_counter() - t0
    rec["resident"] = resident_rows(big)
    queries = [big.graphs[q] for q in cfg["qids"]]
    kops.reset_launch_counts()
    for tau in STORE_TAUS:
        before, ex = big.stats, dict(big.executor.stats)
        t0 = time.perf_counter()
        hits = big.search_batch(queries, tau)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after, ex2 = big.stats, big.executor.stats
        gathers = ex2["shard_gathers"] - ex["shard_gathers"]
        rec["big", tau] = {
            "hits": hits, "wall_s": wall,
            "queries_per_s": len(queries) / wall,
            **{k: after[k] - before[k] for k in STAGE_WALLS},
            "shard_gathers": gathers,
            "shard_gather_ms": 1e3 * (ex2["shard_gather_wall_s"]
                                      - ex["shard_gather_wall_s"])
            / max(gathers, 1),
            "batch_gathers": ex2["gathers"] - ex["gathers"]}
    rec["launches"] = kops.launch_counts()
    del big

    st, rec["sub"] = sub_store_pass(mesh, cfg)

    def listing(d):
        j = os.path.join(d, "journal")
        return (sorted(os.listdir(d)),
                sorted(os.listdir(j)) if os.path.isdir(j) else [])

    d, steps = cfg["sub_dir"], {}
    st.save(d)
    steps["save"] = (listing(d), dict(writes))
    dist.barrier()              # listed before the next write
    ids = st.add(cfg["added"])
    st.remove(ids)
    steps["mutate"] = (listing(d), dict(writes))
    dist.barrier()
    st.save(d)
    steps["save_again"] = (listing(d), dict(writes))
    dist.barrier()
    rec["sub_steps"] = steps
    again = ged.GraphStore.open(d, mesh=mesh, **fused_store_opts())
    queries = [cfg["graphs"][q] for q in cfg["sub_qids"]]
    rec["sub_reopened"] = (again.search_batch(queries, STORE_TAUS[0]),
                           [again.top_k(q, 4) for q in queries])
    svc = GedVerificationService(mesh=mesh, use_kernel=True,
                                 batch_size=STORE_OPTS["batch_size"])
    svc.register_corpus(cfg["graphs"])
    rec["service"] = svc.verify([
        GedRequest(queries[qi], cfg["graphs"][p], tau=STORE_TAUS[0])
        for qi, p in cfg["requests"]])
    rec["service_in_store"] = svc.stats["store_candidates"]
    return rec


def distributed_store_input(big_store, sub_store, tmp):
    """Group (d)'s input, written to ``tmp``: the ``[store]`` snapshot
    and its query ids, the sub-store's graphs and query ids, where to
    save it, graphs to add (perturbed queries whose labels the sub-store
    already has, so its vocabulary stays) and the service's requests
    (each query against its planted near-duplicates)."""
    import pickle
    from repro_torch.data.graphs import perturb
    sub, sub_qids = sub_store["graphs"], sub_store["qids"]
    vl = {int(v) for g in sub for v in g.vlabels}
    el = {int(a) for g in sub for a in g.adj.reshape(-1)}
    rng = np.random.default_rng(SEED + 11)
    added = [g for g in (perturb(rng, sub[q], 1, n_vlabels=62, n_elabels=3)
                         for q in sub_qids)
             if {int(v) for v in g.vlabels} <= vl
             and {int(a) for a in g.adj.reshape(-1)} <= el]
    assert added, "no perturbed query keeps the sub-store's labels"
    base = SUB_GRAPHS - SUB_QUERIES * SUB_PLANTED
    requests = [(qi, base + qi * SUB_PLANTED + j)
                for qi in range(len(sub_qids)) for j in range(SUB_PLANTED)]
    (Path(tmp) / STORE_INPUT).write_bytes(pickle.dumps({
        "snapshot": big_store["snapshot"], "qids": big_store["qids"],
        "graphs": sub, "sub_qids": sub_qids, "added": added,
        "sub_dir": str(Path(tmp) / "sub_saved"), "requests": requests}))


def store_reference():
    """What ``[store]`` hands group (d), made here when that phase did not
    run (``--distributed-only``): the fused store of 42,687 graphs
    ingested on the card, its ``search_batch`` hits at each tau and its
    saved snapshot; the sub-store's hits and signatures on the card."""
    import torch
    from repro_torch import ged
    graphs, qids, _ = store_corpus(
        np.random.default_rng(SEED + 8), STORE_GRAPHS, 10, 40,
        STORE_QUERIES, STORE_PLANTED)
    store = ged.GraphStore(graphs, device="cuda", **fused_store_opts())
    hits = {tau: store.search_batch([graphs[q] for q in qids], tau)
            for tau in STORE_TAUS}
    snapshot = tempfile.mkdtemp(prefix="repro_torch_store_")
    store.save(snapshot)
    del store
    sub, sub_qids, _ = store_corpus(np.random.default_rng(SEED + 9),
                                    SUB_GRAPHS, 8, 14, SUB_QUERIES,
                                    SUB_PLANTED)
    sub_queries = [sub[q] for q in sub_qids]
    t0 = time.perf_counter()
    st = ged.GraphStore(sub, device="cuda", **fused_store_opts())
    ranged = st.search_batch(sub_queries, STORE_TAUS[0])
    top = [st.top_k(q, 4) for q in sub_queries]
    torch.cuda.synchronize()
    sub_store = {"graphs": sub, "qids": sub_qids, "queries": sub_queries,
                 "ranged": ranged, "top": top, "sigs": st._cindex.sigs,
                 "wall_s": time.perf_counter() - t0}
    return ({"snapshot": snapshot, "qids": qids, "hits": hits}, sub_store)


def distributed_group(kind, world, tmp):
    """Start one group of rank processes and wait for it; each rank's
    record, or an ``AssertionError`` naming the failed ranks (every
    process is stopped either way)."""
    import pickle
    store = Path(tmp) / f"store_{kind}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(Path(tmp) / f"{kind}{r}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--distributed-rank-child", kind, str(r), str(store),
                 str(Path(tmp) / f"{kind}{r}.pkl")], cwd=ROOT, env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        failed = []
        for r, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(
                    1, DISTRIBUTED_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                logs[r].seek(0)
                failed.append((r, rc, logs[r].read()[-3000:]))
        assert not failed, f"[distributed] ({kind}) ranks failed: {failed}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    return [pickle.loads((Path(tmp) / f"{kind}{r}.pkl").read_bytes())
            for r in range(world)]


def distributed_phase(comp_t, ver_t, main_s, auto_comp, auto_ver, auto_s,
                      smi, kinds="abcd", big_store=None, sub_store=None):
    """``GedEngine(mesh=)`` and ``GraphStore(mesh=)`` on
    ``torch.distributed`` meshes (see the module docstring, phase 17):
    each group's ranks in child processes, outcomes held to ``[main]``'s
    ``"torch"`` and ``[auto]``'s all-fused run, hits to ``[store]``'s
    (``big_store`` / ``sub_store``, as ``store_phase`` returns them;
    group (d) needs both, group (b) runs the sub-store when it is given).
    ``kinds`` picks the groups.  Returns (summary, launches summed over
    the ranks of groups (a) and (d), or of the first group run)."""
    import torch
    t_phase = time.perf_counter()
    groups = {k: v[0] for k, v in DISTRIBUTED_GROUPS.items() if k in kinds}
    cards = torch.cuda.device_count()
    if cards > 1 and "c" in kinds:
        groups["c"] = cards
    per_group = {}
    summ = {"one_device_s": {"torch_compute_verify": main_s,
                             "auto_all_fused_compute_verify": auto_s}}
    with tempfile.TemporaryDirectory() as tmp:
        if "d" in groups:
            distributed_store_input(big_store, sub_store, tmp)
        for kind, world in groups.items():
            t0 = time.perf_counter()
            recs = distributed_group(kind, world, tmp)
            if kind == "d":
                summ[kind] = store_group_rows(recs, big_store, sub_store)
                summ[kind]["wall_s"] = time.perf_counter() - t0
                log("[distributed] (d) " + json.dumps(summ[kind]) +
                    "; every rank's hits equal [store]'s fused hits on the "
                    "snapshot and on the sub-store, each rank holds half of "
                    "each stage-0 bucket, the first rank alone wrote "
                    f"({smi})")
                per_group[kind] = {k: sum(r["launches"][k] for r in recs)
                                   for k in KERNELS}
                continue
            rows = []
            for rec in recs:
                row = {"rank": rec["rank"], "device": rec["device"]}
                for name, want in (("sharded", comp_t + ver_t),
                                   ("auto", auto_comp + auto_ver)):
                    if name not in rec:
                        continue
                    got = rec[name]
                    expect_same(f"[distributed] ({kind}) rank "
                                f"{rec['rank']} {name}", got["outcomes"],
                                want)
                    no_fault_keys(f"distributed {name}", got["stats"])
                    st = got["stats"]
                    fast = st["executor_single_device_fastpath"]
                    shards = rec["batch_multiple"]
                    # the model axis has size 1: one pair shard a rank
                    assert shards == world, (kind, shards)
                    assert (fast > 0) == (shards == 1), (kind, name, st)
                    assert (st.get("executor_gathers", 0) > 0) == \
                        (shards > 1), (kind, name, st)
                    gathers = st.get("executor_gathers", 0)
                    row[name] = {
                        "compute_s": got["compute_s"],
                        "verify_s": got["verify_s"],
                        "planning_s": got["planning_s"],
                        "batch_multiple": shards,
                        "executor_pairs": st["executor_pairs"],
                        "dispatches": st.get("dispatches",
                                             st["executor_calls"]),
                        "fastpath_dispatches": fast, "gathers": gathers,
                        "gather_ms_per_batch": (
                            1e3 * st["executor_gather_wall_s"] / gathers
                            if gathers else None)}
                if "auto" in rec:
                    missing = [k for k, v in rec["launches"].items()
                               if v <= 0]
                    assert not missing, (f"[distributed] ({kind}) rank "
                                         f"{rec['rank']} never launched "
                                         f"{missing}")
                if "sub" in rec:        # (b): the sub-store, fast path
                    sub = rec["sub"]
                    tag = f"[distributed] ({kind}) sub-store"
                    expect_same_hits(tag + " range", sub["hits"][0],
                                     sub_store["ranged"])
                    expect_same_hits(tag + " top-k", sub["hits"][1],
                                     sub_store["top"])
                    ex = sub["executor"]
                    assert ex["single_device_fastpath"] > 0, ex
                    assert "shard_gathers" not in ex, ex
                    row["sub_store"] = {
                        "ingest_s": sub["ingest_s"],
                        "search_s": sub["search_s"],
                        "fastpath_dispatches": ex["single_device_fastpath"]}
                row["launches"] = rec["launches"]
                rows.append(row)
            summ[kind] = {"ranks": world, "backend": recs[0]["backend"],
                          "mesh": [list(recs[0]["shape"]),
                                   list(recs[0]["axes"])],
                          "wall_s": time.perf_counter() - t0, "per_rank": rows}
            log(f"[distributed] ({kind}) " + json.dumps(summ[kind])
                + "; every rank's outcomes equal [main]'s \"torch\""
                + (" and [auto]'s all-fused run" if "auto" in recs[0]
                   else "")
                + (" and [store]'s sub-store hits" if "sub" in recs[0]
                   else "") + f" ({smi})")
            per_group[kind] = {k: sum(r["launches"][k] for r in recs)
                               for k in KERNELS}
    picked = [k for k in ("a", "d") if k in per_group] or list(per_group)[:1]
    launches = {k: sum(per_group[g][k] for g in picked) for k in KERNELS}
    if cards == 1 and "c" in kinds:
        summ["c"] = "not run: one card"
        log("[distributed] (c) one NCCL rank per card: not run, one card")
    summ["phase_s"] = time.perf_counter() - t_phase
    log("[distributed] summary: " + json.dumps(
        {"one_device_s": summ["one_device_s"], "phase_s": summ["phase_s"],
         **{f"{k}_wall_s": summ[k]["wall_s"] for k in groups}})
        + f" ({smi})")
    return summ, launches


def store_group_rows(recs, big_store, sub_store):
    """Group (d)'s records held to ``[store]``'s hits and to the write
    contract; its summary (per rank: open seconds, queries/s, stage walls
    and the shard gathers' ms at each tau, resident rows, launches, the
    sub-store's seconds)."""
    rows = []
    for rec in recs:
        r = rec["rank"]
        tag = f"[distributed] (d) rank {r}"
        for tau in STORE_TAUS:
            expect_same_hits(f"{tag} snapshot at tau {tau}",
                             rec["big", tau]["hits"],
                             big_store["hits"][tau])
        for rows_, slices in rec["resident"] + rec["sub"]["resident"]:
            assert slices == [-(-rows_ // 2)], (tag, rows_, slices)
        missing = [k for k, v in rec["launches"].items() if v <= 0]
        assert not missing, f"{tag} never launched {missing}"
        sub = rec["sub"]
        assert sub["sigs"].dtype == sub_store["sigs"].dtype
        assert sub["sigs"].tobytes() == sub_store["sigs"].tobytes(), tag
        for key, (ranged, top) in (("live", sub["hits"]),
                                   ("reopened", rec["sub_reopened"])):
            expect_same_hits(f"{tag} sub-store {key} range", ranged,
                             sub_store["ranged"])
            expect_same_hits(f"{tag} sub-store {key} top-k", top,
                             sub_store["top"])
        steps = rec["sub_steps"]
        assert steps["save"][0] == (["graphstore.json", "seg-00000000"],
                                    []), steps
        assert steps["mutate"][0] == (
            ["graphstore.json", "journal", "seg-00000000"],
            ["j-00000001.json", "j-00000001.seg", "j-00000002.json"]), steps
        assert steps["save_again"][0] == (
            ["graphstore.json", "journal", "seg-00000001"], []), steps
        calls = [steps[k][1] for k in ("save", "mutate", "save_again")]
        want = [{"save_store": 1, "append_journal": 0},
                {"save_store": 1, "append_journal": 2},
                {"save_store": 2, "append_journal": 2}]
        assert calls == (want if r == 0 else [dict.fromkeys(c, 0)
                                              for c in want]), (tag, calls)
        found = [{h.graph_id for h in hs} for hs in sub_store["ranged"]]
        base = SUB_GRAPHS - SUB_QUERIES * SUB_PLANTED
        for i, o in enumerate(rec["service"]):
            qi, p = divmod(i, SUB_PLANTED)
            assert o.certified and o.similar == (
                base + qi * SUB_PLANTED + p in found[qi]), (tag, i, o)
        assert 0 < rec["service_in_store"] <= len(rec["service"]), tag
        rows.append({
            "rank": r, "device": rec["device"], "open_s": rec["open_s"],
            **{f"tau{tau:g}": {k: v for k, v in rec["big", tau].items()
                               if k != "hits"} for tau in STORE_TAUS},
            "resident_rows": [s[0] for _, s in rec["resident"]],
            "bucket_rows": [n for n, _ in rec["resident"]],
            "launches": rec["launches"],
            "sub_store": {k: sub[k] for k in ("ingest_s", "search_s")}})
    return {"ranks": len(recs), "backend": recs[0]["backend"],
            "mesh": [list(recs[0]["shape"]), list(recs[0]["axes"])],
            "per_rank": rows}


# ----------------------------------------------------------------- main

def main(argv) -> int:
    import torch
    for var in CACHE_ENV_VARS:        # runs here set their own
        os.environ.pop(var, None)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if argv[:1] == ["--shared-cache-child"]:
        return shared_cache_child(argv[1])
    if argv[:1] == ["--compile-cache-child"]:
        return compile_cache_child(argv[1])
    if argv[:1] == ["--dryrun-rank-child"]:
        return multi_card_child(int(argv[1]), int(argv[2]), argv[3],
                                argv[4])
    if argv[:1] == ["--distributed-rank-child"]:
        return distributed_child(argv[1], int(argv[2]), argv[3], argv[4])
    from repro_torch.core.engine.tensor_graphs import label_vocab
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = resolve_device("cuda")
    if "--lm-only" in argv:           # iterate on the LM phase alone
        lm_phase(smi)
        log(f"[device] {smi}")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--train-only" in argv:        # iterate on the training phase alone
        train_phase(smi)
        log(f"[device] {smi}")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {_build.library_path()}")
    dry_dir = tempfile.mkdtemp(prefix="repro_torch_dryrun_")
    if "--dryrun-only" in argv:       # iterate on the dry-run phase alone
        dryrun_phase(smi, start_dryrun_children(dry_dir), dry_dir)
        log(f"[device] {smi}")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    rng = np.random.default_rng(SEED)
    pairs, ks = aids_pairs(rng, PAIRS, 20, 30)
    if "--distributed-only" in argv:  # iterate on [distributed] alone
        from repro_torch.ged import KernelDispatch
        big, _ = aids_pairs(np.random.default_rng(SEED + 5), BIG_PAIRS,
                            40, 60)
        vocab, mix = label_vocab(pairs), pairs + big
        run_engine("torch", pairs[:8], "cuda", vocab, max_iters=4)
        comp_t, ver_t, tc, tv = run_engine("torch", pairs, "cuda", vocab)
        fused = KernelDispatch(lsa_fused=True, bma_fused=True,
                               merge_fused=True)
        auto_c, auto_v, _, tac, tav, _ = auto_run(mix, label_vocab(mix),
                                                  "cuda", dispatch=fused)
        groups = argv[argv.index("--distributed-only") + 1:]
        kinds = groups[0] if groups else "abcd"
        big_store, sub_store = (store_reference() if "d" in kinds
                                else (None, None))
        try:
            distributed_phase(comp_t, ver_t, [tc, tv], auto_c, auto_v,
                              [tac, tav], smi, kinds=kinds,
                              big_store=big_store, sub_store=sub_store)
        finally:
            if big_store is not None:
                shutil.rmtree(big_store["snapshot"], ignore_errors=True)
        log(f"[device] {smi}")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--async-only" in argv:        # iterate on the [async] phase alone
        big, _ = aids_pairs(np.random.default_rng(SEED + 5), BIG_PAIRS,
                            40, 60)
        vocab, mix = label_vocab(pairs), pairs + big
        run_engine("cuda", pairs[:8], "cuda", vocab, max_iters=4)
        comp, ver, t_c, t_v = run_engine("cuda", pairs, "cuda", vocab)
        main_row = summarize("cuda", comp, ver, [t_c], [t_v])
        auto_c, auto_v, _, t_c, t_v, _ = auto_run(mix, label_vocab(mix),
                                                  "cuda")
        async_phase(pairs, vocab, mix, label_vocab(mix), auto_c, auto_v,
                    main_row, {"compute_pairs_per_s": len(mix) / t_c,
                               "verify_pairs_per_s": len(mix) / t_v}, smi)
        log(f"[device] {smi}")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    checks = kernel_checks(pairs, 32, np.random.default_rng(SEED + 1), dev,
                           timed=True)
    for name, row in checks.items():
        log(f"[kernel] {name} N=32 Le=3 B={PAIRS * EXPAND}: "
            + json.dumps({k: v for k, v in row.items()
                          if k not in ("bytes", "ops")}))
    errs = {k: v["max_abs_err"] for k, v in checks.items()}
    # lsa_children and bma_cost_matrix timed at the other shapes the main,
    # "auto" and store paths give them: N = 64 and N = 16 (the slot bucket
    # of the store's small graphs) at the main path's 2048 states,
    # the "auto" path's rung-0 buckets (128 pairs x 4 at slot 32, 32 pairs
    # x 4 at slot 64), and an edgeless batch (Le = 0)
    extra = [("N=64", aids_pairs(np.random.default_rng(SEED + 3), PAIRS, 40, 60)[0], 64, EXPAND),
             ("N=16", aids_pairs(np.random.default_rng(SEED + 10), PAIRS, 9, 16)[0], 16, EXPAND),
             ("rung0 N=32", aids_pairs(np.random.default_rng(SEED + 6), 128, 20, 30)[0], 32, 4),
             ("rung0 N=64", aids_pairs(np.random.default_rng(SEED + 7), 32, 40, 60)[0], 64, 4),
             ("Le=0", edgeless_pairs(np.random.default_rng(SEED + 2), 64, 6, 30), 32, EXPAND)]
    for tag, ps, slots, expand in extra:
        rows = kernel_checks(ps, slots, np.random.default_rng(SEED + 4), dev,
                             timed=True, expand=expand, top2_timed=False)
        for name, row in rows.items():
            errs[name] = max(errs[name], row["max_abs_err"])
            shown = ({k: v for k, v in row.items() if k not in ("bytes", "ops")}
                     if "kernel_ms" in row else
                     {k: row[k] for k in ("equal", "out_shape")})
            log(f"[kernel] {name} {tag} B={len(ps) * expand}: "
                + json.dumps(shown))
    merge_rows = merge_checks(dev)
    checks["merge_ranks"] = merge_rows[(1, 32)]      # rung 1, N = 32
    errs["merge_ranks"] = max([merge_extra_checks(dev)] + [
        r["max_abs_err"] for r in merge_rows.values()])
    errs["reduced_top2"] = max(errs["reduced_top2"], top2_checks(dev))
    if "--kernels-only" in argv:
        log(f"[device] {smi}")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- the abstract dry-run cells run on the host from here on -------
    dry_children = start_dryrun_children(dry_dir)

    # ---- the main path: counts read around the "cuda" run only ----------
    vocab = label_vocab(pairs)
    run_engine("cuda", pairs[:8], "cuda", vocab, max_iters=4)   # warm-up
    kops.reset_launch_counts()
    comp_c, ver_c, tc, tv = run_engine("cuda", pairs, "cuda", vocab)
    cuda_launches = kops.launch_counts()
    log(f"[main] cuda launches: {json.dumps(cuda_launches)}")
    missing = [k for k, v in cuda_launches.items()
               if v <= 0 and k != "merge_ranks"]      # the merge is unfused
    assert not missing, f"kernels never launched on the main path: {missing}"

    comp_t, ver_t, tc_t, tv_t = run_engine("torch", pairs, "cuda", vocab)
    times = {"cuda": ([tc], [tv]), "torch": ([tc_t], [tv_t])}
    for _ in range(REPEATS - 1):      # alternate the backends
        for b in ("cuda", "torch"):
            _, _, t_c, t_v = run_engine(b, pairs, "cuda", vocab)
            times[b][0].append(t_c)
            times[b][1].append(t_v)
    summ = {"cuda": summarize("cuda", comp_c, ver_c, *times["cuda"]),
            "torch": summarize("torch", comp_t, ver_t, *times["torch"])}
    diff = [i for i, (a, b) in enumerate(zip(comp_c + ver_c, comp_t + ver_t))
            if not same_outcome(a, b)]
    assert not diff, f"cuda and torch outcomes differ at {diff[:10]}"
    log("[main] cuda == torch on every outcome field "
        f"({len(comp_c)} computations, {len(ver_c)} verifications)")

    for o, k in zip(comp_c, ks):
        if o.certified:
            assert o.lower_bound <= o.ged <= k, (o, k)
    for o, k in zip(ver_c, ks):
        if o.certified and o.similar:
            assert o.lower_bound == 0.0 and o.upper_bound <= TAU, (o, k)
        elif o.certified:           # a proven rejection: TAU < ged <= k
            assert o.lower_bound > TAU and k > TAU, (o, k)
    log("[main] certified answers respect lower_bound <= ged <= k")

    t0 = time.perf_counter()
    comp_p, ver_p, _, _ = run_engine("torch", pairs[:CPU_PAIRS], "cpu", vocab)
    for a, b in zip(comp_p + ver_p, comp_c[:CPU_PAIRS] + ver_c[:CPU_PAIRS]):
        assert (a.ged, a.certified, a.similar, a.upper_bound) == \
            (b.ged, b.certified, b.similar, b.upper_bound), (a, b)
    log(f"[main] {CPU_PAIRS} pairs on the CPU agree with the card "
        f"({time.perf_counter() - t0:.1f} s)")

    prof = {b: profile_launches(b, pairs, vocab) for b in ("cuda", "torch")}
    for b, row in prof.items():
        log(f"[profile] {b}: " + json.dumps(row))

    # ---- the "auto" path on a tuning table measured here --------------
    big, big_ks = aids_pairs(np.random.default_rng(SEED + 5), BIG_PAIRS,
                             40, 60)
    with tempfile.TemporaryDirectory() as tune_dir:
        tune_phase(tune_dir, dev)
        auto_summ, launches, auto_comp, auto_ver = auto_phase(
            pairs + big, ks + big_ks, tune_dir)

        # ---- the search loop as graph replays, off the caller's thread --
        async_summ = async_phase(pairs, vocab, pairs + big,
                                 label_vocab(pairs + big), auto_comp,
                                 auto_ver, summ["cuda"], auto_summ, smi)

        # ---- the result cache in front of the engine -------------------
        cache_summ = cache_phase(pairs, vocab, comp_c, ver_c, pairs + big,
                                 label_vocab(pairs + big), auto_comp, smi)

        # ---- deadlines, faults and the degradation ladder --------------
        faults_summ = faults_phase(
            pairs, vocab, comp_c, ver_c, cuda_launches, pairs + big,
            label_vocab(pairs + big), auto_comp, auto_ver, launches,
            auto_summ["compute_s_median_min_max"][0], tune_dir, smi)

    # ---- the corpus layer: GraphStore at the AIDS database's size -------
    store_summ, store_launches, sub_store, big_store = store_phase(smi)

    # ---- the GED services and their launcher ---------------------------
    serving_summ, serving_launches = serving_phase(pairs, ver_c, sub_store,
                                                   smi)

    # ---- multi-device placement -----------------------------------------
    sharded_summ, sharded_launches = sharded_phase(
        pairs, vocab, comp_t, ver_t, pairs + big, label_vocab(pairs + big),
        auto_comp, auto_ver, auto_summ["all_fused_s"], sub_store, smi)

    # ---- the LM serving path: every family, two archs at full width ----
    lm_summ = lm_phase(smi)

    # ---- LM training: gemma3-1b at full size, qwen3-8b at full width ---
    train_summ = train_phase(smi)

    # ---- the launch layer: placement on the card and the dry run -------
    dry_summ, dry_launches = dryrun_phase(smi, dry_children, dry_dir)

    # ---- GedEngine and GraphStore on torch.distributed meshes ----------
    try:
        dist_summ, dist_launches = distributed_phase(
            comp_t, ver_t, [statistics.median(times["torch"][0]),
                            statistics.median(times["torch"][1])],
            auto_comp, auto_ver, auto_summ["all_fused_s"], smi,
            big_store=big_store, sub_store=sub_store)
    finally:
        shutil.rmtree(big_store["snapshot"], ignore_errors=True)

    phase_launches = {"auto": launches, "store": store_launches,
                      "serving": serving_launches,
                      "sharded": sharded_launches,
                      "dryrun": {k: (dry_launches if k == "reduced_top2"
                                     else 0) for k in KERNELS},
                      "distributed": dist_launches}
    total = {k: sum(p[k] for p in phase_launches.values()) for k in KERNELS}
    log("[kernels] " + ", ".join(
        f"{k}: launches={total[k]} (" + ", ".join(
            f"{tag} {p[k]}" for tag, p in phase_launches.items())
        + ") equal=True" for k in KERNELS))
    log(json.dumps({"main_path": summ, "auto_path": auto_summ,
                    "async_path": async_summ, "cache_path": cache_summ, "faults_path": faults_summ,
                    "store_path": store_summ, "serving_path": serving_summ,
                    "sharded_path": sharded_summ, "lm_path": lm_summ,
                    "train_path": train_summ, "dryrun_path": dry_summ,
                    "distributed_path": dist_summ,
                    "profile": {
        b: {k: v for k, v in row.items() if not k.startswith("top_")}
        for b, row in prof.items()}}))
    def device_or_call(row, key):
        # device time where the profiler saw the kernels, else event time
        dev = row[key + "_device_ms"]
        return row[key + "_ms"] if dev is None else dev

    log(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{k}.cu",
        "replaces": KERNELS[k],
        "launches": total[k],
        "max_abs_err": errs[k], "ms": device_or_call(checks[k], "kernel"),
        "plain_ms": device_or_call(checks[k], "plain"),
        "bound_ms": checks[k]["bound_us"] / 1e3,
        "bound_by": checks[k]["bound_by"],
        "library_ms": (device_or_call(checks[k], "library")
                       if checks[k]["library_ms"] is not None else None)}
        for k in KERNELS]}))
    log(f"[device] {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
