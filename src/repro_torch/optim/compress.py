"""Int8 error-feedback gradient compression for cross-pod reductions.

The reference's ``repro/optim/compress.py``.  Each gradient leaf is
quantised to int8 with a per-leaf scale before the reduction over the pod
axis, and the quantisation error is kept as residual state that is added
back next step (error feedback: unbiased in the long run).

The reference's :func:`psum_compressed` runs inside ``shard_map`` with
``pmax`` / ``psum`` over a named axis.  The port's takes one gradient tree
and one residual tree per shard of that axis, as lists, and applies the
same rules: every shard quantises with the axis-max scale, the int8
payloads are summed in int32 (exact for up to 2^23 shards), and the sum is
rescaled and divided by the shard count, so every shard decodes the same
gradient.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.models.params import tree_map


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-30) / 127.0
    return _quantise(xf, scale), scale


def _quantise(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_update(grad: torch.Tensor, residual: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Quantise ``grad + residual``; return (q, scale, new_residual)."""
    target = grad.float() + residual
    q, scale = compress_int8(target)
    return q, scale, target - decompress_int8(q, scale)


def psum_compressed(grads: Sequence[Any], residuals: Sequence[Any]
                    ) -> Tuple[List[Any], List[Any]]:
    """Error-feedback int8 all-reduce over the shards of one axis.

    ``grads[i]`` / ``residuals[i]`` are shard ``i``'s trees (the same
    structure).  Returns (each shard's reduced gradient tree, each shard's
    new residual tree).
    """
    n = len(grads)
    if n == 0 or len(residuals) != n:
        raise ValueError(f"need one residual tree per gradient tree, got "
                         f"{len(grads)} and {len(residuals)}")

    def one(gs, rs):
        # all shards must agree on a scale: the axis max, then re-quantise
        gscale = torch.stack([error_feedback_update(g, r)[1]
                              for g, r in zip(gs, rs)]).amax()
        qs = [_quantise(g.float() + r, gscale) for g, r in zip(gs, rs)]
        total = torch.stack([q.to(torch.int32) for q in qs]).sum(0)
        return ([(total.float() * gscale / float(n)).to(g.dtype)
                 for g in gs],
                [g.float() + r - q.float() * gscale
                 for g, r, q in zip(gs, rs, qs)])

    both = _zip_map(one, list(grads), list(residuals))
    return ([tree_map(lambda t: t[0][i], both) for i in range(n)],
            [tree_map(lambda t: t[1][i], both) for i in range(n)])


def _zip_map(fn, gs: List[Any], rs: List[Any]) -> Any:
    """``fn(shards' leaves, shards' residuals)`` at every leaf of the
    shards' (equally structured) trees."""
    if isinstance(gs[0], dict):
        return {k: _zip_map(fn, [g[k] for g in gs], [r[k] for r in rs])
                for k in gs[0]}
    return fn(gs, rs)
