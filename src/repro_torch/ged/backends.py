"""Pluggable *policy* backends behind the ``repro_torch.ged`` facade.

Every backend implements ``run(plan, taus, verification, cfg) ->
List[GedOutcome]`` over the bucketed :class:`repro_torch.ged.plan.Plan`;
the executor (:mod:`repro_torch.ged.exec`) owns the device.

* ``"torch"`` — the batched engine in plain PyTorch
  (``use_kernel=False``); the reference's ``"jax"``.
* ``"cuda"``  — the same engine with the hand-written CUDA kernels on the
  hot path (``use_kernel=True``); the reference's ``"pallas"``.  On a CPU
  device the kernel wrappers use their plain twins.

The reference's ``"auto"``, ``"exact"`` and ``"sharded"`` backends are
still to port (``ROADMAP.md``, queue 1).  New backends register with
:func:`register_backend`.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Protocol

import numpy as np

from repro_torch.core.engine.search import EngineConfig
from repro_torch.ged.exec import Executor, engine_outcome
from repro_torch.ged.plan import Plan
from repro_torch.ged.results import GedOutcome


class Backend(Protocol):
    """What the facade requires of an execution-policy backend."""

    name: str
    # What ``EngineConfig.use_kernel`` must be for this backend; ``None``
    # means the backend honors whatever the config says.
    kernel_default: Optional[bool]

    def run(self, plan: Plan, taus: np.ndarray, verification: bool,
            cfg: EngineConfig) -> List[GedOutcome]:
        """Answer every pair in ``plan`` (in order); ``taus`` is aligned
        with ``plan.pairs`` (zeros in computation mode)."""
        ...


class EngineBackend:
    """Bucket-at-a-time policy over an :class:`~repro_torch.ged.exec.Executor`.

    ``cfg.use_kernel`` is taken as-is — ``GedEngine`` defaults it per
    backend name and rejects contradictions.
    """

    name = "torch"
    kernel_default = False

    def __init__(self, device=None, executor: Optional[Executor] = None):
        self.executor = executor or Executor(device)

    def run(self, plan: Plan, taus: np.ndarray, verification: bool,
            cfg: EngineConfig) -> List[GedOutcome]:
        results: List[Optional[GedOutcome]] = [None] * len(plan.pairs)
        for bucket in plan.buckets:
            t0 = time.perf_counter()
            out = self.executor.run_bucket(bucket, taus, cfg, verification)
            wall = time.perf_counter() - t0
            for bi, gi in enumerate(bucket.indices):
                results[gi] = engine_outcome(
                    out, bucket.packed, bi, verification,
                    float(taus[gi]) if verification else None,
                    self.name, wall, rung=0)
        return results  # type: ignore[return-value]


class CudaBackend(EngineBackend):
    """Engine policy with the CUDA kernels on the hot path; same outcomes
    as ``"torch"``."""

    name = "cuda"
    kernel_default = True


# -------------------------------------------------------------- registry

_REGISTRY: Dict[str, Callable[..., Backend]] = {}

# reference backends this port does not have yet
_NOT_PORTED = ("auto", "exact", "sharded")


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    """Make ``GedEngine(backend=name)`` constructible; ``factory`` receives
    the keyword options its signature names."""
    _REGISTRY[name] = factory


def available_backends() -> tuple:
    """Sorted names ``GedEngine(backend=...)`` accepts right now.

    >>> available_backends()
    ('cuda', 'torch')
    """
    return tuple(sorted(_REGISTRY))


def make_backend(name: str, **options) -> Backend:
    """Construct a registered backend, dropping options it doesn't take.

    >>> make_backend("torch", device="cpu", unused=1).name
    'torch'
    """
    if name in _NOT_PORTED and name not in _REGISTRY:
        raise ValueError(
            f"backend {name!r} is not ported yet (see ROADMAP.md, queue 1); "
            f"available: {available_backends()}")
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None
    import inspect
    params = inspect.signature(factory).parameters
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
        options = {k: v for k, v in options.items() if k in params}
    return factory(**options)


register_backend("torch", EngineBackend)
register_backend("cuda", CudaBackend)
