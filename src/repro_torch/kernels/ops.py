"""Wrappers around the engine's CUDA kernels, with launch counters.

Each wrapper takes the operands of its counterpart in
``repro/kernels/ops.py`` (batched, or unbatched for one state).  For CPU
tensors it calls the plain PyTorch twin in :mod:`repro_torch.kernels.ref`;
for CUDA tensors it launches the hand-written kernel on PyTorch's current
stream, or raises — there is no fallback from a failed kernel to its twin.
``LAUNCHES`` counts kernel launches (never twin calls), so a run can show
that its main path went through the kernels.  A launch recorded into a
CUDA graph under capture (:func:`capture_tally`) is not one: the capture
tallies it, and each replay of the graph adds the tally
(:func:`add_launches`).  Batches run on worker threads, so the counts
change under a lock.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

import torch

from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"reduced_top2": 0, "bma_cost_matrix": 0,
                            "lsa_children": 0, "merge_ranks": 0}
_LAUNCHES_LOCK = threading.Lock()
# the tally of the graph this thread is capturing, if any
_CAPTURE = threading.local()


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    with _LAUNCHES_LOCK:
        return dict(LAUNCHES)


def _count(kernel: str) -> None:
    """One launch of ``kernel``, counted under the lock, or into the tally
    of the graph this thread is capturing."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[kernel] += 1
        return
    with _LAUNCHES_LOCK:
        LAUNCHES[kernel] += 1


@contextlib.contextmanager
def capture_tally() -> Iterator[Dict[str, int]]:
    """While a CUDA graph is captured on this thread: the kernels it
    records, by name, instead of launches."""
    prev = getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = tally = {k: 0 for k in LAUNCHES}
    try:
        yield tally
    finally:
        _CAPTURE.tally = prev


def add_launches(tally: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    with _LAUNCHES_LOCK:
        for k, v in tally.items():
            LAUNCHES[k] += v


def _on_card(*xs: torch.Tensor) -> bool:
    """True when the operands live on a CUDA device; raises on a mix."""
    kinds = {x.device for x in xs}
    if len(kinds) != 1:
        raise ValueError(f"kernel operands on several devices: {kinds}")
    return next(iter(kinds)).type == "cuda"


def _prep(x: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    return x.contiguous()


def _checked(kernel: str, args, names, shapes, int_names):
    """Validate each operand's shape and dtype; return contiguous copies."""
    ops = []
    for name, x, shape in zip(names, args, shapes):
        if tuple(x.shape) != shape:
            raise ValueError(f"{kernel} {name} has shape {tuple(x.shape)}, "
                             f"want {shape}")
        ops.append(_prep(x, torch.int32 if name in int_names
                         else torch.float32, name))
    return ops


def _launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Launch on PyTorch's current stream.  The operands may be temporary
    contiguous copies that are freed when the wrapper returns, before the
    kernel has run: the caching allocator only hands their memory to later
    work on the same stream, which runs after this kernel."""
    from repro_torch.kernels import _build
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(getattr(lib, fn_name)(*args, device.index, stream), kernel)
    _count(kernel)


def reduced_top2(cost: torch.Tensor, prices: torch.Tensor):
    """(min, argmin, 2nd-min) per row of ``cost + prices``; argmin int32."""
    unbatched = cost.ndim == 2
    if unbatched:
        cost, prices = cost[None], prices[None]
    if not _on_card(cost, prices):
        m1, a1, m2 = ref.reduced_top2_ref(cost, prices)
    else:
        b, n, n2 = cost.shape
        if n2 != n or prices.shape != (b, n):
            raise ValueError(f"reduced_top2 shapes {tuple(cost.shape)} / "
                             f"{tuple(prices.shape)}; want (B,N,N) / (B,N)")
        cost = _prep(cost, torch.float32, "cost")
        prices = _prep(prices, torch.float32, "prices")
        m1 = torch.empty((b, n), dtype=torch.float32, device=cost.device)
        a1 = torch.empty((b, n), dtype=torch.int32, device=cost.device)
        m2 = torch.empty((b, n), dtype=torch.float32, device=cost.device)
        if b * n:
            _launch("reduced_top2", "repro_reduced_top2", cost.device,
                    *(x.data_ptr() for x in (cost, prices, m1, a1, m2)), b, n)
    if unbatched:
        return m1[0], a1[0], m2[0]
    return m1, a1, m2


_BMA_NAMES = ("qv", "gv", "inner_q", "inner_g", "qa_ord", "ga", "img_cl",
              "pos_anch")
_BMA_INT = {"qv", "gv", "qa_ord", "ga", "img_cl"}


def bma_cost_matrix(qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch):
    """lambda^BMa free-pair cost matrix ``(B, N, N)``; batched or not.

    Takes ``ga`` and ``img_cl`` like the reference wrapper: the gather
    ``gcross[b, u, j] = ga[b, u, img_cl[b, j]]`` happens inside the kernel
    (and inside the plain twin).  The per-pair operands ``qv``, ``gv``,
    ``qa_ord`` and ``ga`` may carry ``P`` rows for the ``B`` rows of the
    per-state ones, ``B`` a multiple of ``P``: state ``s`` then reads pair
    row ``s // (B // P)``, so they are passed once per pair, not copied
    to every state.  The kernel reads the ``(N, Le)`` histograms
    label-major: a ``transpose(-1, -2)`` view of a contiguous ``(Le, N)``
    tensor, as ``bounds.py`` builds them, reaches it uncopied.
    """
    args = [qv, gv, inner_q, inner_g, qa_ord, ga, img_cl, pos_anch]
    unbatched = qv.ndim == 1
    if unbatched:
        args = [x[None] for x in args]
    if not _on_card(*args):
        out = ref.bma_cost_matrix_ref(*args)
    else:
        p, n = args[0].shape
        b, le = args[2].shape[0], args[2].shape[-1]
        expand = ref.states_per_pair(p, b)
        args[2], args[3] = args[2].transpose(1, 2), args[3].transpose(1, 2)
        ops = _checked("bma_cost_matrix", args, _BMA_NAMES,
                       [(p, n), (p, n), (b, le, n), (b, le, n), (p, n, n),
                        (p, n, n), (b, n), (b, n)], _BMA_INT)
        out = torch.empty((b, n, n), dtype=torch.float32, device=qv.device)
        if b * n:
            _launch("bma_cost_matrix", "repro_bma_cost_matrix", qv.device,
                    *(x.data_ptr() for x in ops), out.data_ptr(), b, expand,
                    n, le)
    return out[0] if unbatched else out


_LSA_NAMES = ("base", "free_g", "rowhist_g", "ga", "img_cl", "qrow",
              "pos_anch", "cq", "cg", "base_j", "adjb_j", "hq_i", "hg_i",
              "cq_vi")
_LSA_INT = {"ga", "img_cl", "qrow"}


def lsa_children(base, free_g, rowhist_g, ga, img_cl, qrow, pos_anch, cq, cg,
                 base_j, adjb_j, hq_i, hg_i, cq_vi):
    """Fused delta^LSa child-bound vector ``(B, N)``; batched or not.

    Operands are the pre-reduced histograms ``bounds.lsa_children``
    extracts with (N, Le)-sized contractions and gathers, and the pair's
    ``ga`` with the state's ``img_cl`` in place of the reference's
    ``a_ju[b, j, u] = ga[b, img_cl[b, j], u]``: that gather happens inside
    the kernel (and inside the plain twin).  ``ga`` may carry ``P`` rows
    for the ``B`` state rows, ``B`` a multiple of ``P``: state ``s`` reads
    pair row ``s // (B // P)``, and ``rowhist_g`` is read label-major,
    both as in :func:`bma_cost_matrix`.
    """
    args = [base, free_g, rowhist_g, ga, img_cl, qrow, pos_anch, cq, cg,
            base_j, adjb_j, hq_i, hg_i, cq_vi]
    unbatched = base.ndim == 1
    if unbatched:
        args = [x[None] for x in args]
    if not _on_card(*args):
        out = ref.lsa_children_ref(*args)
    else:
        b, n = args[0].shape
        p, le = args[3].shape[0], args[2].shape[-1]
        expand = ref.states_per_pair(p, b)
        args[2] = args[2].transpose(1, 2)
        ops = _checked("lsa_children", args, _LSA_NAMES,
                       [(b, n), (b, n), (b, le, n), (p, n, n), (b, n), (b, n),
                        (b, n), (b, n, le), (b, n, le), (b, n), (b, n),
                        (b, le), (b, le), (b, le)], _LSA_INT)
        out = torch.empty((b, n), dtype=torch.float32, device=base.device)
        if b * n:
            _launch("lsa_children", "repro_lsa_children", base.device,
                    *(x.data_ptr() for x in ops), out.data_ptr(), b, expand,
                    n, le)
    return out[0] if unbatched else out


def merge_ranks(keys_a: torch.Tensor, keys_b: torch.Tensor):
    """Rank counts of a two-run merge, ``(count_a, count_b)`` int32.

    ``count_a[b, i] = #{j : keys_b[b, j] < keys_a[b, i]}`` and
    ``count_b[b, j] = #{i : keys_a[b, i] <= keys_b[b, j]}``: plain
    comparison counts, which equal the searchsorted left/right ranks when
    the runs are sorted.  Batched ``(B, NA)`` / ``(B, NB)`` or unbatched.

    The card kernel decides per pair, on the device, whether each run is
    sorted: it binary-searches a sorted run and counts over an unsorted
    one, in the same launch, so it equals the twin on any input.  Nothing
    here tests sortedness on the host (that would sync every iteration).
    """
    unbatched = keys_a.ndim == 1
    if unbatched:
        keys_a, keys_b = keys_a[None], keys_b[None]
    if not _on_card(keys_a, keys_b):
        count_a, count_b = ref.merge_ranks_ref(keys_a, keys_b)
    else:
        b, na = keys_a.shape
        if keys_b.ndim != 2 or keys_b.shape[0] != b:
            raise ValueError(f"merge_ranks shapes {tuple(keys_a.shape)} / "
                             f"{tuple(keys_b.shape)}; want (B,NA) / (B,NB)")
        nb = keys_b.shape[1]
        keys_a = _prep(keys_a, torch.float32, "keys_a")
        keys_b = _prep(keys_b, torch.float32, "keys_b")
        count_a = torch.empty((b, na), dtype=torch.int32, device=keys_a.device)
        count_b = torch.empty((b, nb), dtype=torch.int32, device=keys_a.device)
        if b * (na + nb):
            _launch("merge_ranks", "repro_merge_ranks", keys_a.device,
                    *(x.data_ptr() for x in (keys_a, keys_b, count_a,
                                             count_b)), b, na, nb)
    if unbatched:
        return count_a[0], count_b[0]
    return count_a, count_b
