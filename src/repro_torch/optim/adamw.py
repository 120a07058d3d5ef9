"""AdamW with decoupled weight decay, global-norm clipping, f32 state.

The reference's ``repro/optim/adamw.py`` over the port's nested-dict
parameter trees.  The state is ``{"m", "v", "step"}``: f32 moments with
the parameters' tree and an int32 scalar step on their device.

:func:`adamw_update` writes the new parameters and moments into the
tensors it was given, under ``torch.no_grad()``: it stands in for the
reference's donated buffers (``jax.jit(..., donate_argnums=(0, 1))``), so
a full-size step never holds two copies of the state.  It still returns
``(params', state', metrics)``; callers that need the old values keep a
copy.  On DTensor leaves (``launch/steps.py``) each gradient is first
redistributed to its parameter's placements (a reduce-scatter under
FSDP), so every in-place write keeps the shard it writes into.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.parallel.sharding import placed_like


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # schedule hook: step -> multiplier (see schedule.cosine_schedule)
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def adamw_init(params: Any) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(leaf for _, leaf in tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in
    the reference's (sorted-key) order, in f32."""
    total = 0
    for _, leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig,
                 lr_schedule: Optional[Callable[[torch.Tensor],
                                                torch.Tensor]] = None,
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params', state', metrics)."""
    with torch.no_grad():
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
        lr = cfg.lr * (lr_schedule(step) if lr_schedule is not None
                       else 1.0)
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device),
                              step.float())
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device),
                              step.float())

        g_leaves = dict(tree_leaves(grads))
        m_leaves = dict(tree_leaves(state["m"]))
        v_leaves = dict(tree_leaves(state["v"]))
        for path, p in tree_leaves(params):
            m, v = m_leaves[path], v_leaves[path]
            g = placed_like(g_leaves[path], p).float() * scale
            m.copy_(placed_like(cfg.b1 * m + (1.0 - cfg.b1) * g, m))
            v.copy_(placed_like(cfg.b2 * v + (1.0 - cfg.b2)
                                * torch.square(g), v))
            del g
            pf = p.float()
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * pf
            p.copy_(placed_like((pf - lr * delta).to(p.dtype), p))
            del pf, delta
        metrics = {"grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, dtype=torch.float32,
                                         device=step.device)}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
