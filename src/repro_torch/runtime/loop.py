"""Fault-tolerant step loop: checkpoint/restart with exact replay.

The reference's ``repro/runtime/loop.py``.  The data pipeline is
deterministic by step (``repro_torch.data.tokens``), so a restart from
step k replays the same batches, and loss curves across a failure are
bit-identical to an uninterrupted run.

``FaultInjector`` simulates node failures: it raises ``SimulatedFault`` at
configured steps (or those in ``REPRO_FAULT_STEPS=7,13``), standing in for
a real preemption signal.  On a fault the loop restores the last committed
checkpoint, rewinds the pipeline and continues; ``max_restarts`` bounds
the faults it absorbs.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.checkpoint import CheckpointManager


class SimulatedFault(RuntimeError):
    pass


class FaultInjector:
    def __init__(self, fail_at: Optional[Iterable[int]] = None,
                 env: str = "REPRO_FAULT_STEPS"):
        if fail_at is None:
            raw = os.environ.get(env, "")
            fail_at = [int(x) for x in raw.split(",") if x.strip()]
        self.fail_at = set(fail_at)
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFault(f"injected fault at step {step}")


def train_loop(
    step_fn: Callable,                  # (state, batch) -> (state, metrics)
    state: Any,
    make_pipeline: Callable[[int], Any],  # start_step -> iterator of batches
    ckpt: CheckpointManager,
    total_steps: int,
    ckpt_every: int = 50,
    injector: Optional[FaultInjector] = None,
    state_shardings: Optional[Any] = None,
    max_restarts: int = 8,
    log_every: int = 10,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
) -> Tuple[Any, List[Dict]]:
    """Run ``total_steps`` with checkpoint/restart. Returns (state, history).

    ``state_shardings`` is handed to :meth:`CheckpointManager.restore`
    (a device or a tree of devices; ``None`` keeps the state's devices).
    """
    injector = injector or FaultInjector([])
    history: List[Dict] = []
    restarts = 0

    start = ckpt.latest_step() or 0
    if start:
        _, state, _ = ckpt.restore(state, step=start,
                                   shardings=state_shardings)
    step = start
    pipeline = make_pipeline(step)

    while step < total_steps:
        try:
            batch = next(pipeline)
            injector.maybe_fail(step)
            state, metrics = step_fn(state, batch)
            step += 1
            if step % log_every == 0 or step == total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                history.append(m)
                if on_metrics:
                    on_metrics(step, m)
            if step % ckpt_every == 0 or step == total_steps:
                ckpt.save(step, state)
        except SimulatedFault as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts") from e
            ckpt.wait()
            restore_to = ckpt.latest_step() or 0
            if restore_to:
                _, state, _ = ckpt.restore(state, step=restore_to,
                                           shardings=state_shardings)
            else:
                raise RuntimeError(
                    "fault before first checkpoint; cannot recover") from e
            if hasattr(pipeline, "close"):
                pipeline.close()
            step = restore_to
            # drop metrics from the rolled-back region: replay re-logs them
            history = [h for h in history if h["step"] <= restore_to]
            pipeline = make_pipeline(step)        # exact replay
    ckpt.wait()
    if hasattr(pipeline, "close"):
        pipeline.close()
    return state, history
