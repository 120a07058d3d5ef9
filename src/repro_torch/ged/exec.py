"""The execution layer under the ``repro_torch.ged`` facade.

Backends (:mod:`repro_torch.ged.backends`) are policies; everything about
*how* a packed bucket reaches the device lives here:

* :class:`Executor` — runs packed buckets on one torch device: the move
  onto the device and invocation counters.
* :class:`PendingBatch` — the future :meth:`Executor.run_packed_async`
  returns; :meth:`PendingBatch.result` hands back numpy.
* :func:`engine_outcome` — one :class:`GedOutcome` from a row of a result.

The reference's retry and degradation ladder (``repro/ged/exec.py``) is
not part of this layer yet; a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.engine import api as engine_api
from repro_torch.core.engine.search import EngineConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ged.plan import Bucket
from repro_torch.ged.results import GedOutcome, engine_mapping


class PendingBatch:
    """One dispatched-but-not-yet-drained engine invocation.

    Wraps the dict of torch tensors a dispatch produced; on the card the
    kernels may still be running when it is handed out.  :meth:`result`
    blocks once and caches the numpy conversion.

    >>> p = PendingBatch({"ged": torch.zeros(2)})
    >>> p.result()["ged"]
    array([0., 0.], dtype=float32)
    """

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._tensors = tensors
        self._result: Optional[Dict[str, np.ndarray]] = None

    def result(self) -> Dict[str, np.ndarray]:
        """Block until the batch lands; numpy result dict (cached)."""
        if self._result is None:
            self._result = {k: v.cpu().numpy()
                            for k, v in self._tensors.items()}
            self._tensors = None
        return self._result


class Executor:
    """Runs packed buckets on one torch device.

    >>> ex = Executor(device="cpu")
    >>> ex.device, sorted(ex.stats)
    (device(type='cpu'), ['calls', 'pairs'])
    """

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.stats: Dict[str, float] = {"calls": 0, "pairs": 0}

    def run_packed_async(self, packed, taus: np.ndarray, cfg: EngineConfig,
                         verification: bool, real: Optional[int] = None
                         ) -> PendingBatch:
        """Dispatch one engine invocation; ``real`` — pairs before batch
        padding, for the ``pairs`` counter."""
        self.stats["calls"] += 1
        self.stats["pairs"] += packed.batch if real is None else int(real)
        return PendingBatch(engine_api.dispatch_packed(
            packed, taus, cfg, verification, device=self.device))

    def run_bucket(self, bucket: Bucket, taus: np.ndarray, cfg: EngineConfig,
                   verification: bool) -> Dict[str, np.ndarray]:
        """Run one plan bucket; ``taus`` is the plan-global per-pair array."""
        return self.run_packed_async(bucket.packed, bucket.pad_values(taus),
                                     cfg, verification,
                                     real=bucket.real).result()


def engine_outcome(out: Dict[str, np.ndarray], packed, bi: int,
                   verification: bool, tau: Optional[float], backend: str,
                   wall_s: float, rung: int) -> GedOutcome:
    """One :class:`GedOutcome` from row ``bi`` of an executor result dict."""
    certified = bool(out["exact"][bi])
    n = int(packed.n[bi])
    mapping = engine_mapping(packed.order[bi], out["best_img"][bi], n)
    stats = {"rung": rung,
             "iterations": float(out["iterations"][bi]),
             "expanded": float(out["expanded"][bi])}
    lb = float(out["lower_bound"][bi])
    if verification:
        similar = bool(out["similar"][bi])
        ub = float(out["upper_bound"][bi])
        return GedOutcome(
            ged=None, similar=similar, certified=certified,
            lower_bound=lb, upper_bound=ub if similar else float("inf"),
            mapping=mapping if similar else None,
            backend=backend, wall_s=wall_s, tau=tau, stats=stats)
    raw = float(out["ged"][bi])
    ged = float(np.rint(raw)) if certified else raw
    return GedOutcome(
        ged=ged, similar=None, certified=certified,
        lower_bound=min(lb, ged), upper_bound=ged,
        mapping=mapping, backend=backend, wall_s=wall_s, stats=stats)
