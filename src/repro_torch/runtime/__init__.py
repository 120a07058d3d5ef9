"""Scheduling of GED workloads (a copy of the reference's
``repro/runtime/scheduler.py``)."""

from repro_torch.runtime.scheduler import (ESCALATION_RUNGS, Batch,
                                           GedScheduler, difficulty)

__all__ = ["ESCALATION_RUNGS", "Batch", "GedScheduler", "difficulty"]
