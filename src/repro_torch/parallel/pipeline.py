"""GPipe-style pipeline parallelism over a mesh axis (the ``pod`` axis).

The reference's ``repro/parallel/pipeline.py``.  :func:`pipeline_apply`
runs a stage function over ``S`` pipeline stages with ``M`` microbatches in
the classic (M + S - 1)-tick schedule: at tick ``t`` stage ``s`` applies
its layer chunk to microbatch ``t - s`` and hands the result one stage
forward; stage 0 feeds microbatch ``t`` while ``t < M``; the last stage
emits microbatch ``t - (S - 1)``.

The reference runs it under ``shard_map`` with a ``ppermute`` per tick.
The port places stage ``s``'s parameter slice on the first device of pod
index ``s`` of a :class:`~repro_torch.parallel.sharding.DeviceMesh`, and
moves each boundary activation with one ``.to(device)`` per tick; CUDA
launches are asynchronous, so stages on distinct cards overlap.  Stages
only compute the microbatches they hold (the reference also computes, and
discards, the empty slots of the bubble).

Bubble fraction = (S-1)/(M+S-1); the default is M = 4*S.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from repro_torch.models.params import tree_map
from repro_torch.parallel.sharding import DeviceMesh, mesh_shard_devices


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh: DeviceMesh, axis: str = "pod",
                   microbatches: Optional[int] = None) -> torch.Tensor:
    """Run ``y = stages(x)`` pipelined over ``mesh.shape[axis]`` stages.

    stage_fn(params_slice, act) -> act : one stage's computation.
    stage_params: tree with leading dim = n_stages.
    x: (B, ...) global batch; B % microbatches == 0.  The result is on
    x's device.
    """
    devs = mesh_shard_devices(mesh, (axis,))
    s = len(devs)
    m = microbatches or 4 * s
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} is not a multiple of {m} microbatches")
    xs = x.reshape((m, b // m) + tuple(x.shape[1:]))
    params = [tree_map(lambda a, i=i: a[i].to(devs[i]), stage_params)
              for i in range(s)]

    held: List[Optional[torch.Tensor]] = [None] * s
    outs: List[Optional[torch.Tensor]] = [None] * m
    for t in range(m + s - 1):
        if t < m:
            held[0] = xs[t].to(devs[0])
        done = [stage_fn(params[i], held[i]) if 0 <= t - i < m else None
                for i in range(s)]
        if t >= s - 1:
            outs[t - (s - 1)] = done[s - 1].to(x.device)
        # shift activations one stage forward
        held = [None] + [None if a is None else a.to(devs[i + 1])
                         for i, a in enumerate(done[:-1])]
    return torch.stack(outs).reshape((b,) + tuple(x.shape[1:]))


def stack_stages(layer_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer tree -> (S, L/S, ...) stage-major tree."""
    def f(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             "stages")
        return a.reshape((n_stages, n // n_stages) + tuple(a.shape[1:]))
    return tree_map(f, layer_params)
