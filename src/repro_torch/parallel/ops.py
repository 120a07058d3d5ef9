"""Frontier primitives of the sorted-pool search.

The PyTorch counterparts of ``sort_by_key``, ``top_k_sorted`` (the MoE
router's top-k) and ``merge_sorted_topk`` in ``repro/parallel/ops.py``, batched over leading axes: keys are
``(*lead, n)`` and every payload leaf is ``(*lead, n, *rest)``.  The
search loop keeps its pool key-sorted; pop is a slice, and the merge folds
the freshly sorted children in with two rank passes (binary searches, or
the merge-ranks kernel).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over tensors, (named) tuples, lists and dicts."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"unsupported payload node {type(first).__name__}")


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[...], ...]`` along the run axis (``idx.ndim - 1``)."""
    axis = idx.ndim - 1
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - idx.ndim))
    return torch.take_along_dim(x, idx.long(), axis)


def sort_by_key(keys: torch.Tensor, payload: Any) -> Tuple[torch.Tensor, Any]:
    """Stable ascending sort of ``keys`` along the last axis, carrying a
    payload pytree whose leaves share the keys' leading axes."""
    keys_sorted, order = torch.sort(keys, dim=-1, stable=True)
    return keys_sorted, tree_map(lambda x: _gather_rows(x, order), payload)


def top_k_sorted(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k along the last axis from a stable descending sort, so a
    tie goes to the lower index, as the reference's one variadic sort
    does (``torch.topk`` leaves the order of ties unspecified)."""
    neg, order = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], order[..., :k]


def merge_sorted_topk(
    keys_a: torch.Tensor,
    keys_b: torch.Tensor,
    payload_a: Any,
    payload_b: Any,
    keep: int,
    drop_a: Optional[torch.Tensor] = None,
    drop_b: Optional[torch.Tensor] = None,
    perm_b: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Merge two key-sorted runs, keep the smallest ``keep``, no argsort.

    Each element's merged rank is its own index plus its binary-search
    position in the *other* run:

        rank_a[i] = i + |{j : keys_b[j] <  keys_a[i]}|   (ties: A first)
        rank_b[j] = j + |{i : keys_a[i] <= keys_b[j]}|

    — a stable merge, identical to a stable sort of ``concat(A, B)``.
    Elements with rank >= ``keep`` are dropped; the third result is the
    minimum of their ``drop_*`` values (``+inf`` when nothing was dropped),
    which feeds the engine's exactness certificate.  ``perm_b`` composes a
    preceding key sort: pass ``payload_b`` and ``drop_b`` in pre-sort row
    order with the sort permutation (sorted position ``j`` came from row
    ``perm_b[j]``).

    ``use_kernel=True`` counts the two rank passes with the merge-ranks
    kernel (``kernels/ops.py::merge_ranks``) instead of binary searches:
    the same integer ranks, so the output is bit-identical, and everything
    downstream (scatters, payload gather, floor) is shared.
    """
    lead = keys_a.shape[:-1]
    na, nb = keys_a.shape[-1], keys_b.shape[-1]
    dev = keys_a.device
    if use_kernel:
        from repro_torch.kernels import ops as kops
        rows = lead.numel()
        count_a, count_b = kops.merge_ranks(keys_a.reshape(rows, na),
                                            keys_b.reshape(rows, nb))
        rank_a = torch.arange(na, device=dev) + count_a.reshape(*lead, na)
        rank_b = torch.arange(nb, device=dev) + count_b.reshape(*lead, nb)
    else:
        rank_a = torch.arange(na, device=dev) + torch.searchsorted(
            keys_b.contiguous(), keys_a.contiguous(), side="left")
        rank_b = torch.arange(nb, device=dev) + torch.searchsorted(
            keys_a.contiguous(), keys_b.contiguous(), side="right")

    # JAX drops out-of-range scatter writes (mode="drop"); torch would
    # raise, and on the card fire a device-side assert.  Ranks >= keep go
    # to one spare slot at index ``keep`` instead, sliced off afterwards.
    # The in-range ranks are a permutation, so no two writes collide there.
    dst_a = rank_a.clamp_max(keep)
    dst_b = rank_b.clamp_max(keep)
    keys_out = torch.zeros(*lead, keep + 1, dtype=keys_a.dtype, device=dev)
    keys_out.scatter_(-1, dst_a, keys_a)
    keys_out.scatter_(-1, dst_b, keys_b)

    row_b = (torch.arange(nb, device=dev).expand(*lead, nb) if perm_b is None
             else perm_b.long())
    src = torch.zeros(*lead, keep + 1, dtype=torch.long, device=dev)
    src.scatter_(-1, dst_a, torch.arange(na, device=dev).expand(*lead, na))
    src.scatter_(-1, dst_b, na + row_b)
    src = src[..., :keep]
    payload_out = tree_map(
        lambda xa, xb: _gather_rows(torch.cat([xa, xb], dim=len(lead)), src),
        payload_a, payload_b)

    if drop_a is None:
        drop_a = keys_a
    if drop_b is None:
        drop_b = keys_b
    elif perm_b is not None:
        drop_b = torch.take_along_dim(drop_b, row_b, -1)  # re-align with keys
    inf = torch.full((*lead, 1), float("inf"), dtype=drop_a.dtype, device=dev)
    dropped_min = torch.cat([
        torch.where(rank_a >= keep, drop_a, inf),
        torch.where(rank_b >= keep, drop_b, inf), inf], dim=-1).amin(-1)
    return keys_out[..., :keep], payload_out, dropped_min
