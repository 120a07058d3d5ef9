"""Batched engine entry points: the raw compute step under ``repro_torch.ged``.

Pairs are data-parallel: one batch is one ``(pairs, P, ...)`` search on
one device (see :mod:`repro_torch.core.engine.search`).
:func:`dispatch_packed` runs a batch and returns its outputs;
:func:`start_packed` is the asynchronous form the executors use: on a
CUDA device the search runs on the device's :class:`DeviceWorker` and the
call returns at once, as the reference's dispatch of its
``lax.while_loop`` does.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine.search import EngineConfig, run_batch
from repro_torch.core.engine.tensor_graphs import (DevicePairs,
                                                   GraphPairTensors,
                                                   to_device)
from repro_torch.device import DeviceLike, resolve_device


def dispatch_packed(packed: GraphPairTensors, taus, cfg: EngineConfig,
                    verification: bool, *, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Run one engine invocation over a packed batch on ``device``.

    Returns the reference's ``_run_batch`` dict (``ged``/``similar``,
    ``exact``, ``lower_bound``, ``upper_bound``, ``iterations``,
    ``expanded``, ``best_img``, ``floor``) as tensors on that device,
    once they have landed.  ``device`` defaults to the card and must be
    given as ``"cpu"`` to run on the CPU.
    """
    dev = resolve_device(device)
    pairs = to_device(packed, dev)
    taus_t = torch.as_tensor(np.asarray(taus, dtype=np.float32), device=dev)
    return run_batch(pairs, taus_t, cfg, bool(verification))


class BatchFuture:
    """A batch a :class:`DeviceWorker` runs: :meth:`ready` never blocks,
    :meth:`result` waits for the worker and re-raises its exception as
    it was raised."""

    def __init__(self, future: concurrent.futures.Future):
        self._future = future

    def ready(self) -> bool:
        """True once the worker has finished (its outputs have landed)."""
        return self._future.done()

    def result(self) -> Dict[str, torch.Tensor]:
        return self._future.result()


class DeviceWorker:
    """One thread and, on a CUDA device, one stream of its own, that run
    the batches submitted to them in order.

    :func:`start_packed` uses one per CUDA device (:func:`worker`); a
    worker for the CPU exists only for tests of the worker.  A submit
    records an event on the caller's current stream, behind the copies
    of the inputs; the worker's stream waits on it, and the inputs are
    marked as used on that stream.  :func:`run_batch` returns once the
    outputs have landed, so a finished future means a finished batch.
    """

    def __init__(self, device: DeviceLike):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"repro-torch-{self.device}")

    def submit(self, pairs: DevicePairs, taus: torch.Tensor,
               cfg: EngineConfig, verification: bool) -> BatchFuture:
        if not self._cuda:
            return BatchFuture(self._pool.submit(run_batch, pairs, taus, cfg,
                                                 verification))
        inputs = torch.cuda.Event()
        inputs.record(torch.cuda.current_stream(self.device))
        stream = self._stream

        def work() -> Dict[str, torch.Tensor]:
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                stream.wait_event(inputs)
                for t in (*pairs[:6], taus):
                    t.record_stream(stream)
                return run_batch(pairs, taus, cfg, verification)

        return BatchFuture(self._pool.submit(work))


_WORKERS: Dict[torch.device, DeviceWorker] = {}
_WORKERS_LOCK = threading.Lock()


def worker(device: torch.device) -> DeviceWorker:
    """The process's :class:`DeviceWorker` for a CUDA ``device``."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _WORKERS_LOCK:
        w = _WORKERS.get(device)
        if w is None:
            w = _WORKERS[device] = DeviceWorker(device)
        return w


def start_packed(packed: GraphPairTensors, taus, cfg: EngineConfig,
                 verification: bool, *, device: DeviceLike = None
                 ) -> BatchFuture:
    """Start one engine invocation on a CUDA ``device``; returns before
    the batch ends.

    The inputs are copied to the card on the caller's stream and the
    kernel library is built (or loaded) on the caller's thread; the
    search runs on the device's worker.
    """
    from repro_torch.kernels import _build
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"start_packed runs on a CUDA device, not {dev}; "
                         "use dispatch_packed on the CPU")
    _build.library()
    pairs = to_device(packed, dev)
    taus_t = torch.as_tensor(np.asarray(taus, dtype=np.float32), device=dev)
    return worker(dev).submit(pairs, taus_t, cfg, bool(verification))
