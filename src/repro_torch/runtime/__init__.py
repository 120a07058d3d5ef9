"""Scheduling of GED workloads (a copy of the reference's
``repro/runtime/scheduler.py``) and the fault-tolerant training loop."""

from repro_torch.runtime.loop import FaultInjector, SimulatedFault, train_loop
from repro_torch.runtime.scheduler import (ESCALATION_RUNGS, Batch,
                                           GedScheduler, difficulty)

__all__ = ["FaultInjector", "SimulatedFault", "train_loop",
           "ESCALATION_RUNGS", "Batch", "GedScheduler", "difficulty"]
