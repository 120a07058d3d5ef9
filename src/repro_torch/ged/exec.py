"""The execution layer under the ``repro_torch.ged`` facade.

Backends (:mod:`repro_torch.ged.backends`) are policies; everything about
*how* a packed bucket reaches the device lives here:

* :class:`Executor` — runs packed buckets on one torch device: packing
  with its batch-shape policy, the ``use_kernel="auto"`` dispatch
  resolution, the move onto the device and invocation counters.
* :class:`PendingBatch` — the future :meth:`Executor.run_packed_async`
  returns; :meth:`PendingBatch.ready` polls without blocking and
  :meth:`PendingBatch.result` hands back numpy.
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
from repro_torch.ged.plan import Bucket, Vocab, pack_bucket
from repro_torch.ged.results import GedOutcome, engine_mapping
from repro_torch.kernels import autotune


class PendingBatch:
    """One dispatched-but-not-yet-drained engine invocation.

    Wraps the dict of torch tensors a dispatch produced.  On the card a
    CUDA event is recorded on the current stream when the batch is
    wrapped: :meth:`ready` polls it without blocking, :meth:`result`
    blocks once and caches the numpy conversion.  CPU tensors are always
    ready.  The search loop reads its termination flag on the host every
    iteration, so on the card a batch has all but finished by the time it
    is wrapped; ``ready`` is what the overlapped ``auto`` backend polls
    all the same.

    >>> p = PendingBatch({"ged": torch.zeros(2)})
    >>> p.ready()
    True
    >>> p.result()["ged"]
    array([0., 0.], dtype=float32)
    """

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._tensors = tensors
        self._result: Optional[Dict[str, np.ndarray]] = None
        self._event = None
        devices = {t.device for t in tensors.values()}
        if len(devices) == 1 and next(iter(devices)).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(
                next(iter(devices))))

    def ready(self) -> bool:
        """True when every output has landed (never blocks)."""
        return (self._result is not None or self._event is None
                or self._event.query())

    def result(self) -> Dict[str, np.ndarray]:
        """Block until the batch lands; numpy result dict (cached)."""
        if self._result is None:
            self._result = {k: v.cpu().numpy()
                            for k, v in self._tensors.items()}
            self._tensors = None
            self._event = None
        return self._result


class Executor:
    """Runs packed buckets on one torch device.

    >>> ex = Executor(device="cpu")
    >>> ex.device, ex.batch_multiple, sorted(ex.stats)
    (device(type='cpu'), 1, ['calls', 'pairs'])
    """

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.stats: Dict[str, float] = {"calls": 0, "pairs": 0}

    @property
    def batch_multiple(self) -> int:
        """Every bucket batch must be a multiple of this (one device: 1)."""
        return 1

    def pack(self, pairs, slots: int, vocab: Optional[Vocab]):
        """Pack ``pairs`` with this executor's batch-shape policy; returns
        ``(tensors, real_count)``."""
        return pack_bucket(pairs, slots, vocab, self.batch_multiple)

    def run_packed_async(self, packed, taus: np.ndarray, cfg: EngineConfig,
                         verification: bool, real: Optional[int] = None
                         ) -> PendingBatch:
        """Dispatch one engine invocation; ``real`` — pairs before batch
        padding, for the ``pairs`` counter.

        ``use_kernel="auto"`` resolves to a concrete per-bucket kernel
        plan here, from the tuning table for this device (or the static
        heuristic for unmeasured shapes).  Outcomes are bit-identical
        across plans.
        """
        cfg = autotune.resolve_config(cfg, packed.slots, packed.batch,
                                      self.device)
        self.stats["calls"] += 1
        self.stats["pairs"] += packed.batch if real is None else int(real)
        return PendingBatch(engine_api.dispatch_packed(
            packed, taus, cfg, verification, device=self.device))

    def run_bucket_async(self, bucket: Bucket, taus: np.ndarray,
                         cfg: EngineConfig, verification: bool
                         ) -> PendingBatch:
        """Dispatch one plan bucket; ``taus`` is the plan-global per-pair
        array."""
        return self.run_packed_async(bucket.packed, bucket.pad_values(taus),
                                     cfg, verification, real=bucket.real)

    def run_bucket(self, bucket: Bucket, taus: np.ndarray, cfg: EngineConfig,
                   verification: bool) -> Dict[str, np.ndarray]:
        """Run one plan bucket and wait for it; numpy result dict."""
        return self.run_bucket_async(bucket, taus, cfg,
                                     verification).result()


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
