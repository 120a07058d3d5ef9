"""The execution layer under the ``repro_torch.ged`` facade.

Backends (:mod:`repro_torch.ged.backends`) are policies; everything about
*how* a packed bucket reaches the device lives here:

* :class:`Executor` — runs packed buckets on one torch device: packing
  with its batch-shape policy, the ``use_kernel="auto"`` dispatch
  resolution, the move onto the device and invocation counters.
* :class:`ShardedExecutor` — the same over several devices (a flat
  ``mesh`` or a named ``DeviceMesh``,
  :func:`repro_torch.parallel.sharding.pair_devices`): each batch is
  split into one contiguous shard per pair shard of the mesh.  On a
  ``torch.distributed`` mesh each rank runs its own shard and a
  :class:`GatheredBatch` hands every rank the whole batch
  (:class:`RankGroup`).
* :class:`PendingBatch` — the future :meth:`Executor.run_packed_async`
  returns, on the card before the batch ends (the search runs on the
  device's worker thread and stream); :meth:`PendingBatch.ready` polls
  without blocking and :meth:`PendingBatch.result` hands back numpy,
  shards in batch order.
* :func:`engine_outcome` — one :class:`GedOutcome` from a row of a result.
* :class:`ResultCache` — the engine-level outcome cache keyed on canonical
  pair digests (:func:`graph_digest` / :func:`wl_digest`; label-vocab
  independent, tau-aware for verification) that
  :class:`repro_torch.ged.GedEngine` consults before any executor runs.
* :func:`wl_signature` / :func:`batch_signatures` — the WL-sketch
  signatures of the corpus layer's candidate index (:class:`SketchSpec`),
  on the host for one query and on the executor's device for a corpus,
  bit-identical to each other and to the reference's.
* :func:`enable_compile_cache` — the kernel library's build directory,
  the port's counterpart of the reference's persistent compile cache.

Dispatch goes through :meth:`Executor._robust_dispatch`, the reference's
retry loop: transient failures (:func:`repro_torch.ged.faults.classify_transient`)
retry with backoff, and the ``dispatch`` / ``kernel`` / ``result`` fault
sites fire there.  The port's degradation ladder starts below the kernels:
it has no unfused step and never re-runs a bucket with ``use_kernel=False``
after a kernel failure, so a :class:`PendingBatch` has no ``recover`` path
and a permanent failure (a kernel that fails to build or launch, or a
``kernel``- or ``result``-site fault) propagates to the backend.  The
backend sends the bucket to the host solver (``degraded_host``) when the
failure is injected or the device is the CPU, and raises it otherwise
(:func:`repro_torch.ged.faults.degradable`).  The reference's
``degraded_kernel`` never appears in the port's stats.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import api as engine_api
from repro_torch.core.engine.search import EngineConfig
from repro_torch.core.exact.graph import Graph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ged import faults
from repro_torch.ged.plan import Bucket, Vocab, pack_bucket
from repro_torch.ged.results import GedOutcome, engine_mapping
from repro_torch.kernels import _build, autotune
from repro_torch.parallel.sharding import (DeviceMesh, Mesh, RankShard,
                                          is_distributed_mesh, pair_devices,
                                          pairs_axes, rank_shard)

# one shard of a dispatched batch: its outputs, or the worker running it
Shard = Union[Dict[str, torch.Tensor], engine_api.BatchFuture]


# ------------------------------------------------- persistent compile cache

COMPILE_CACHE_ENV = "REPRO_GED_COMPILE_CACHE_DIR"


def enable_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the CUDA kernel library's build at ``cache_dir``.

    ``cache_dir`` defaults to the ``REPRO_GED_COMPILE_CACHE_DIR``
    environment variable; when neither is set this is a no-op returning
    ``None`` and the library stays in ``kernels/_build.BUILD_DIR``.  The
    library is built there once (``nvcc``, under a name that hashes the
    sources and flags) and loaded from there by later processes, so the
    build is paid once per machine.  Process-global: the library is loaded
    once per process, so re-pointing the directory after that load changes
    only where later processes build.  Hit/miss counts land in
    :func:`persistent_cache_stats` (and so in ``engine.stats``).

    >>> enable_compile_cache(None) is None     # no dir, no env: no-op
    True
    """
    path = cache_dir or os.environ.get(COMPILE_CACHE_ENV)
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(str(path))
    return str(path)


def persistent_cache_stats() -> Dict[str, float]:
    """Process-wide kernel-build counters (empty when no directory was
    enabled).

    ``persistent_cache_hits`` / ``persistent_cache_misses`` count the
    builds this process found already in the directory / compiled with
    ``nvcc``; ``persistent_cache_entries`` is the number of kernel
    libraries in the directory.
    """
    d = _build._CACHE["dir"]
    if d is None:
        return {}
    try:
        entries = sum(1 for name in os.listdir(str(d))
                      if name.startswith("librepro_torch_kernels-")
                      and name.endswith(".so"))
    except OSError:
        entries = 0
    return {"persistent_cache_hits": float(_build._CACHE["hits"]),
            "persistent_cache_misses": float(_build._CACHE["misses"]),
            "persistent_cache_entries": float(entries)}


class PendingBatch:
    """One dispatched-but-not-yet-drained engine invocation.

    Wraps what a dispatch produced: a dict of torch tensors (a batch that
    has already run, as on the CPU), a
    :class:`~repro_torch.core.engine.api.BatchFuture` (a batch the
    device's worker runs on the card), or a sequence of either, one per
    shard (a :class:`ShardedExecutor` batch, shards in batch order,
    possibly on several devices).  :meth:`ready` never blocks: it is true
    once every shard's worker has finished, which on the card is once its
    outputs have landed on the worker's stream.  :meth:`result` blocks
    once, re-raises a worker's exception as it was raised, and caches the
    numpy conversion, the shards' rows concatenated in batch order.

    ``check`` is the deterministic fault-injection hook of the
    materialisation window (the ``result`` site), run before the
    conversion; a failure there propagates (the port has no degraded
    re-dispatch: the backend host-solves the pairs or raises, see
    :func:`repro_torch.ged.faults.degradable`).  ``flags`` records
    what the robust dispatch did (``retries``) so backends can fold it
    into outcome stats.

    >>> p = PendingBatch({"ged": torch.zeros(2)})
    >>> p.ready()
    True
    >>> p.result()["ged"]
    array([0., 0.], dtype=float32)
    >>> PendingBatch([{"ged": torch.zeros(1)},
    ...               {"ged": torch.ones(1)}]).result()["ged"]
    array([0., 1.], dtype=float32)
    """

    def __init__(self, tensors: Union[Shard, Sequence[Shard]], check=None,
                 flags: Optional[Dict[str, float]] = None):
        self._shards: Optional[List[Shard]] = (
            [tensors] if isinstance(tensors, (dict, engine_api.BatchFuture))
            else list(tensors))
        self._result: Optional[Dict[str, np.ndarray]] = None
        self._check = check
        self.flags: Dict[str, float] = {} if flags is None else flags

    def ready(self) -> bool:
        """True when every output has landed (never blocks)."""
        return self._result is not None or all(
            s.ready() for s in self._shards
            if isinstance(s, engine_api.BatchFuture))

    def result(self) -> Dict[str, np.ndarray]:
        """Block until the batch lands; numpy result dict (cached)."""
        if self._result is None:
            if self._check is not None:
                self._check()
            shards = [s.result() if isinstance(s, engine_api.BatchFuture)
                      else s for s in self._shards]
            self._result = {k: np.concatenate([s[k].cpu().numpy()
                                               for s in shards])
                            for k in shards[0]}
            self._shards = None
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

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The devices a batch's shards run on, in shard order."""
        return (self.device,)

    @property
    def spmd(self) -> bool:
        """Do the ranks of a process group run this executor together, so
        that every decision a backend takes must be the same on each
        (:class:`ShardedExecutor` on a ``torch.distributed`` mesh)?"""
        return False

    def agree(self, *flags: bool) -> Tuple[bool, ...]:
        """Each flag, true where it is true on any rank of the executor's
        group.  One process is its own group: the flags come back."""
        return tuple(bool(f) for f in flags)

    def from_root(self, fn):
        """``fn()`` run on the group's first rank, its value on every
        rank.  One process is its own group: it calls ``fn``."""
        return fn()

    def local_rows(self, n: int) -> Tuple[int, int]:
        """The rows ``lo:hi`` of an ``n``-row array, padded to a multiple
        of :attr:`batch_multiple`, that this process holds, in one
        contiguous slice a device of :attr:`devices`.  One process holds
        them all; a rank of a ``torch.distributed`` mesh its shard's.

        >>> Executor(device="cpu").local_rows(5)
        (0, 5)
        """
        m = self.batch_multiple
        return 0, -(-int(n) // m) * m

    def gather_shards(self, fn) -> list:
        """``fn()``, this process's part of a host result, gathered from
        every shard of the group in shard order (replicas give the first
        copy); an error of ``fn`` on any rank raises on every rank.  One
        process is its own group: ``[fn()]``, no collective."""
        return [fn()]

    def pack(self, pairs, slots: int, vocab: Optional[Vocab]):
        """Pack ``pairs`` with this executor's batch-shape policy; returns
        ``(tensors, real_count)``."""
        return pack_bucket(pairs, slots, vocab, self.batch_multiple)

    def run_packed_async(self, packed, taus: np.ndarray, cfg: EngineConfig,
                         verification: bool, real: Optional[int] = None,
                         ctx: Optional[faults.RunContext] = None,
                         rung: Optional[int] = None) -> PendingBatch:
        """Dispatch one engine invocation; ``real`` — pairs before batch
        padding, for the ``pairs`` counter.

        ``use_kernel="auto"`` resolves to a concrete per-bucket kernel
        plan here, from the tuning table for this device (or the static
        heuristic for unmeasured shapes).  Outcomes are bit-identical
        across plans.  ``ctx`` — the engine's
        :class:`~repro_torch.ged.faults.RunContext` (retry policy, fault
        injector, counters); ``rung`` labels the dispatch for rung-scoped
        fault specs.  Both default to off.
        """
        cfg = autotune.resolve_config(cfg, packed.slots, packed.batch,
                                      self.device)
        self.stats["calls"] += 1
        self.stats["pairs"] += packed.batch if real is None else int(real)
        return self._robust_dispatch(packed, taus, cfg, verification, ctx,
                                     rung)

    def _robust_dispatch(self, packed, taus, cfg, verification, ctx,
                         rung) -> PendingBatch:
        """Dispatch with the retry policy.

        Transient failures retry with exponential backoff and jitter
        (:class:`~repro_torch.ged.faults.RetryPolicy`); a permanent
        failure, or a transient one past ``max_retries``, counts
        ``fault_dispatch`` and propagates to the backend above (see
        :func:`~repro_torch.ged.faults.degradable`).  The port has no unfused step, so a
        kernel failure is never retried with ``use_kernel=False``.  On the
        card the search runs on a worker after this returns, so a failure
        there is raised by :meth:`PendingBatch.result`, as the reference's
        materialisation failures are.  On a clean dispatch this is the
        plain path: the ``try`` costs nothing unless something raises.
        """
        inj = faults.get_injector(ctx)
        retry = ctx.retry if ctx is not None else faults.RetryPolicy()

        def bump(key: str, by: float = 1) -> None:
            self.stats[key] = self.stats.get(key, 0) + by
            if ctx is not None:
                ctx.bump(key, by)

        flags: Dict[str, float] = {}
        attempt = 0
        while True:
            try:
                if inj is not None:
                    inj.check("dispatch", rung)
                    if bool(cfg.use_kernel):
                        inj.check("kernel", rung)
                tensors = self._dispatch(packed, taus, cfg, verification)
                check = None
                if inj is not None:
                    check = (lambda: inj.check("result", rung))
                return PendingBatch(tensors, check=check, flags=flags)
            except Exception as exc:
                if (faults.classify_transient(exc)
                        and attempt < retry.max_retries):
                    bump("retries")
                    flags["retries"] = flags.get("retries", 0) + 1
                    time.sleep(retry.backoff_s(attempt))
                    attempt += 1
                    continue
                bump("fault_dispatch")
                raise

    def run_packed(self, packed, taus: np.ndarray, cfg: EngineConfig,
                   verification: bool, real: Optional[int] = None,
                   ctx: Optional[faults.RunContext] = None,
                   rung: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One blocking engine invocation over a packed bucket; numpy dict
        (:meth:`run_packed_async` + :meth:`PendingBatch.result`)."""
        return self.run_packed_async(packed, taus, cfg, verification,
                                     real=real, ctx=ctx, rung=rung).result()

    def run_bucket(self, bucket: Bucket, taus: np.ndarray, cfg: EngineConfig,
                   verification: bool) -> Dict[str, np.ndarray]:
        """Run one plan bucket and wait for it; ``taus`` is the
        plan-global per-pair array."""
        return self.run_bucket_async(bucket, taus, cfg,
                                     verification).result()

    def run_bucket_async(self, bucket: Bucket, taus: np.ndarray,
                         cfg: EngineConfig, verification: bool,
                         ctx: Optional[faults.RunContext] = None,
                         rung: Optional[int] = None) -> PendingBatch:
        """Dispatch one plan bucket; ``taus`` is the plan-global per-pair
        array.  ``ctx`` / ``rung`` as in :meth:`run_packed_async`."""
        return self.run_packed_async(bucket.packed, bucket.pad_values(taus),
                                     cfg, verification, real=bucket.real,
                                     ctx=ctx, rung=rung)

    def _dispatch(self, packed, taus, cfg, verification):
        """Start the device work: on the card a
        :class:`~repro_torch.core.engine.api.BatchFuture` (the search runs
        on the device's worker, and this returns at once), on the CPU the
        finished batch's dict of tensors (or one such per shard)."""
        if self.device.type == "cuda":
            return engine_api.start_packed(packed, taus, cfg, verification,
                                           device=self.device)
        return engine_api.dispatch_packed(packed, taus, cfg, verification,
                                          device=self.device)


def _rows(packed, lo: int, hi: int):
    """Rows ``lo:hi`` of a packed batch (the label counts stay global)."""
    return dataclasses.replace(
        packed, qv=packed.qv[lo:hi], gv=packed.gv[lo:hi],
        qa=packed.qa[lo:hi], ga=packed.ga[lo:hi],
        order=packed.order[lo:hi], n=packed.n[lo:hi])


def _on(device: torch.device):
    """Make ``device`` current for CUDA work in this thread."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it crosses a process intact (the same type and message
    after pickling), else a ``RuntimeError`` naming its type and message.

    >>> type(_portable(ValueError("x"))).__name__
    'ValueError'
    >>> str(_portable(faults.InjectedFault("dispatch")))
    "injected permanent fault at 'dispatch'"
    """
    try:
        copy = pickle.loads(pickle.dumps(exc))
        if type(copy) is type(exc) and str(copy) == str(exc):
            return exc
    except Exception:
        pass
    return RuntimeError(f"{type(exc).__name__}: {exc}")


# one gloo group per set of mesh ranks, remade when the default group is
_RANK_GROUPS: Dict[Tuple[int, ...], tuple] = {}


class RankGroup:
    """The host collectives that keep the ranks of a ``torch.distributed``
    mesh in step under a :class:`ShardedExecutor`.

    They run over a ``gloo`` group of the mesh's ranks, whatever the
    mesh's own backend: NCCL carries no CPU tensors, and what crosses is
    small (a shard's output rows, about 160 bytes a pair at 32 slots, a
    status and a few flags).  Making the group is a collective over the
    default group, so every rank builds its executor at the same point;
    the group is made once per set of ranks and default group.
    ``stats`` (the executor's) counts the batch gathers (``gathers``,
    ``gather_wall_s``) and the gathers of other host results, such as
    the corpus layer's stage-0 bounds and signatures (``shard_gathers``,
    ``shard_gather_wall_s``).
    """

    def __init__(self, shard: RankShard, stats: Dict[str, float]):
        import torch.distributed as dist
        ranks = tuple(sorted(shard.ranks))
        world = dist.group.WORLD
        made = _RANK_GROUPS.get(ranks)
        if made is None or made[0] is not world:
            made = (world, dist.new_group(list(ranks), backend="gloo"))
            _RANK_GROUPS[ranks] = made
        self.group = made[1]
        self.shard = shard
        self.ranks = ranks
        self.me = ranks.index(dist.get_rank())
        self.stats = stats
        stats.update(gathers=0, gather_wall_s=0.0, shard_gathers=0,
                     shard_gather_wall_s=0.0)

    def _exchange(self, part, failure: Optional[BaseException],
                  flags: Dict[str, float], counter: str
                  ) -> Tuple[list, Dict[str, float]]:
        """All-gather this rank's ``part`` (or its failure) and flags.
        Returns every shard's part in shard order (the first copy of a
        replicated shard) and each flag's largest value over the ranks;
        if any rank failed, raises the first failed rank's error, the
        same type and message, on every rank.  Counts ``counter`` and its
        wall in ``stats``."""
        import torch.distributed as dist
        sent = None if failure is None else _portable(failure)
        got: List[Optional[tuple]] = [None] * len(self.ranks)
        t0 = time.perf_counter()
        dist.all_gather_object(got, (self.shard.index, part, sent,
                                     dict(flags)), group=self.group)
        self.stats[counter + "s"] += 1
        self.stats[counter + "_wall_s"] += time.perf_counter() - t0
        for r, (_, _, err, _) in enumerate(got):
            if err is None:
                continue
            if r == self.me:
                if sent is failure:
                    raise failure
                raise sent from failure
            err.add_note(f"raised on rank {self.ranks[r]} of the mesh")
            raise err from failure
        first: Dict[int, object] = {}
        merged: Dict[str, float] = {}
        for index, got_part, _, fl in got:
            first.setdefault(index, got_part)
            for k, v in fl.items():
                merged[k] = max(merged.get(k, v), v)
        return [first[i] for i in range(self.shard.count)], merged

    def gather(self, rows: Optional[Dict[str, np.ndarray]],
               failure: Optional[BaseException], flags: Dict[str, float]
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
        """Exchange this rank's shard rows (or its failure) and flags
        (:meth:`_exchange`, counted as ``gathers``).  Returns every
        shard's rows in batch order and each flag's largest value over
        the ranks."""
        parts, merged = self._exchange(rows, failure, flags, "gather")
        return ({k: np.concatenate([p[k] for p in parts]) for k in parts[0]},
                merged)

    def gather_shards(self, fn) -> list:
        """``fn()`` on every rank, gathered in shard order
        (:meth:`_exchange`, counted as ``shard_gathers``); ``fn``'s error
        on any rank raises on every rank."""
        part, failure = None, None
        try:
            part = fn()
        except Exception as exc:
            failure = exc
        return self._exchange(part, failure, {}, "shard_gather")[0]

    def any(self, flags: Sequence[bool]) -> Tuple[bool, ...]:
        """Each flag OR-ed over the ranks (one small all-reduce)."""
        import torch.distributed as dist
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return tuple(bool(v) for v in t.tolist())

    def from_root(self, fn):
        """``fn()`` on the first rank, broadcast; its error is raised on
        every rank."""
        import torch.distributed as dist
        box: List[Optional[tuple]] = [None]
        own: Optional[BaseException] = None
        if self.me == 0:
            try:
                box[0] = (True, fn())
            except Exception as exc:
                own = exc
                box[0] = (False, _portable(exc))
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        ok, value = box[0]
        if ok:
            return value
        if own is not None and value is own:
            raise own
        raise value from own


class GatheredBatch(PendingBatch):
    """The :class:`PendingBatch` of a rank of a ``torch.distributed``
    mesh: this rank's shard, run locally (or the failure of its
    dispatch), and a :class:`RankGroup` to gather it through.

    :meth:`ready` stays local and never blocks.  :meth:`result` blocks:
    it waits for the local shard, then exchanges every rank's rows and
    status, so each rank holds the whole batch in batch order, or each
    raises the first failed rank's error.  The fault ladder above then
    takes the same step on every rank, and no rank is left waiting in a
    collective that another has left.  ``flags`` become each flag's
    largest value over the ranks.
    """

    def __init__(self, ranks: RankGroup, local: Optional[PendingBatch],
                 failure: Optional[BaseException] = None):
        super().__init__([], flags=local.flags if local is not None else {})
        self._ranks = ranks
        self._local = local
        self._failure = failure
        self._error: Optional[BaseException] = None

    def ready(self) -> bool:
        return (self._result is not None or self._local is None
                or self._local.ready())

    def result(self) -> Dict[str, np.ndarray]:
        if self._error is not None:
            raise self._error
        if self._result is None:
            rows, failure = None, self._failure
            if self._local is not None:
                try:
                    rows = self._local.result()
                except Exception as exc:
                    failure = exc
            try:
                self._result, flags = self._ranks.gather(rows, failure,
                                                         self.flags)
            except Exception as exc:
                self._error = exc
                raise
            self.flags.update(flags)
            self._local = None
        return self._result


class ShardedExecutor(Executor):
    """Split each pair batch over the devices of ``mesh``.

    ``mesh`` is a flat sequence of torch devices or a named
    :class:`~repro_torch.parallel.sharding.DeviceMesh`
    (:func:`repro_torch.parallel.sharding.pair_devices`); ``None`` means
    every visible card, or the one device ``device`` names.  A named mesh
    shards pairs over ``axes`` (default
    :func:`~repro_torch.parallel.sharding.pairs_axes`: ``pod`` x ``data``,
    else its first axis) and replicates them over the rest, as the
    reference's ``shard_map`` does; replicas compute the same rows, so
    each shard runs once, on the first device of its replica group.  A
    batch (padded by :func:`repro_torch.ged.plan.pack_bucket` to
    ``batch_multiple``, the shard count) is cut into contiguous, equal
    shards.  On the card shard ``i`` starts on its device's worker
    (:func:`~repro_torch.core.engine.api.start_packed`) and the dispatch
    returns one pending shard per device without waiting, so a shard's
    failure is raised by :meth:`PendingBatch.result`.  On the CPU shard
    ``i`` runs :func:`dispatch_packed` with its device current: one worker
    thread per distinct device runs its shards in order (one distinct
    device: the caller's thread), and the dispatch joins them before it
    returns, so a shard's failure is raised inside the retry loop of
    :meth:`Executor._robust_dispatch`.  The search is per pair, so
    outcomes equal the single-device run's.

    Any policy composes with it: ``GedEngine("sharded")`` is the plain
    engine policy on this executor, ``GedEngine("auto", mesh=...)`` the
    escalation policy.  A one-device mesh is the single-device path
    (``stats["single_device_fastpath"]`` counts those dispatches).

    ``mesh`` may also be a ``torch.distributed`` ``DeviceMesh``
    (:func:`~repro_torch.parallel.sharding.is_distributed_mesh`, e.g.
    from :mod:`repro_torch.launch.mesh`), one process per device, used
    SPMD: every rank builds the executor at the same point (building it
    makes a ``gloo`` group of the mesh's ranks, a collective) and calls
    the same engine methods with the same arguments in the same order.
    ``batch_multiple`` is the product of the pairs axes' sizes; each rank
    runs its shard (:func:`~repro_torch.parallel.sharding.rank_shard`) on
    its own device and returns a :class:`GatheredBatch`, whose
    ``result()`` hands every rank the whole batch, or raises on every
    rank the error of the first rank that failed.  Replicas along the
    other axes compute the same rows.  Backends make every decision that
    reads a clock or ``ready()`` through :meth:`agree`, and host solves
    through :meth:`from_root`, so each rank returns the same outcomes.  A
    mesh whose pairs axes have size 1 takes the fast path and gathers
    nothing; when it has several ranks (replicas) they still agree and
    take the first rank's host solves and writes, and one rank alone
    makes no collective.  Callers other than the dispatch split their
    own arrays the same way: :meth:`local_rows` names the rows a rank
    holds, :meth:`gather_shards` hands every rank each shard's part
    (the corpus layer's stage-0 features and signatures,
    :mod:`repro_torch.ged.filters`, :func:`batch_signatures`).

    >>> ex = ShardedExecutor(["cpu"] * 4)
    >>> ex.batch_multiple, ex.stats["single_device_fastpath"]
    (4, 0)
    >>> ShardedExecutor(device="cpu").batch_multiple
    1
    >>> from repro_torch.parallel.sharding import DeviceMesh
    >>> ShardedExecutor(DeviceMesh([["cpu"] * 2] * 4, ("data", "model"))
    ...                 ).batch_multiple
    4
    """

    name = "sharded"

    def __init__(self, mesh: Mesh = None,
                 axes: Optional[Sequence[str]] = None,
                 device: DeviceLike = None):
        self._shard: Optional[RankShard] = None
        self._ranks: Optional[RankGroup] = None
        if is_distributed_mesh(mesh):
            self._shard = rank_shard(mesh, axes, device)
            self._devices = (self._shard.device,)
            self.axes = self._shard.axes
        else:
            self._devices = pair_devices(mesh, device, axes)
            self.axes = (tuple(axes) if axes is not None
                         else pairs_axes(mesh)
                         ) if isinstance(mesh, DeviceMesh) else None
        self.mesh = mesh
        super().__init__(self._devices[0])
        self.stats["single_device_fastpath"] = 0
        if self._shard is not None and len(self._shard.ranks) > 1:
            self._ranks = RankGroup(self._shard, self.stats)

    @property
    def batch_multiple(self) -> int:
        if self._shard is not None:
            return self._shard.count
        return len(self._devices)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self._devices

    @property
    def spmd(self) -> bool:
        return self._ranks is not None

    def agree(self, *flags: bool) -> Tuple[bool, ...]:
        return (super().agree(*flags) if self._ranks is None
                else self._ranks.any(flags))

    def from_root(self, fn):
        return fn() if self._ranks is None else self._ranks.from_root(fn)

    @property
    def _split(self) -> bool:
        """Is each batch split over the ranks of a process group?"""
        return self._ranks is not None and self._shard.count > 1

    def local_rows(self, n: int) -> Tuple[int, int]:
        if not self._split:
            return super().local_rows(n)
        size = -(-int(n) // self._shard.count)
        return self._shard.index * size, (self._shard.index + 1) * size

    def gather_shards(self, fn) -> list:
        if not self._split:
            return super().gather_shards(fn)
        return self._ranks.gather_shards(fn)

    def _robust_dispatch(self, packed, taus, cfg, verification, ctx,
                         rung) -> PendingBatch:
        if not self._split:
            return super()._robust_dispatch(packed, taus, cfg, verification,
                                            ctx, rung)
        # a rank whose dispatch failed still joins the batch's gather,
        # which raises its error on every rank
        try:
            local = super()._robust_dispatch(packed, taus, cfg,
                                             verification, ctx, rung)
        except Exception as exc:
            return GatheredBatch(self._ranks, None, exc)
        return GatheredBatch(self._ranks, local)

    def _dispatch(self, packed, taus, cfg, verification):
        if len(self._devices) == 1 and not self._split:
            # one shard: nothing to split
            self.stats["single_device_fastpath"] += 1
            return super()._dispatch(packed, taus, cfg, verification)
        shards = self.batch_multiple
        if packed.batch % shards:
            raise ValueError(
                f"batch {packed.batch} is not a multiple of the executor's "
                f"{shards} shards; pack with batch_multiple="
                f"{shards} (GedEngine does this automatically)")
        size = packed.batch // shards
        taus = np.asarray(taus, dtype=np.float32)
        if self._split:
            # this rank's rows only; GatheredBatch.result gathers the rest
            lo = self._shard.index * size
            return super()._dispatch(_rows(packed, lo, lo + size),
                                     taus[lo:lo + size], cfg, verification)
        if self.device.type == "cuda":
            # every shard starts on its device's worker; none is waited for
            out: List[Shard] = []
            for i, d in enumerate(self._devices):
                lo = i * size
                with _on(d):
                    out.append(engine_api.start_packed(
                        _rows(packed, lo, lo + size), taus[lo:lo + size],
                        cfg, verification, device=d))
            return out
        per_device: Dict[torch.device, List[int]] = {}
        for i, d in enumerate(self._devices):
            per_device.setdefault(d, []).append(i)

        def run(shards: List[int]) -> List[Dict[str, torch.Tensor]]:
            outs = []
            for i in shards:
                d, lo = self._devices[i], i * size
                with _on(d):
                    outs.append(engine_api.dispatch_packed(
                        _rows(packed, lo, lo + size), taus[lo:lo + size],
                        cfg, verification, device=d))
            return outs

        groups = list(per_device.values())
        if len(groups) == 1:
            return run(groups[0])
        # leaving the block waits for every worker, so every shard has
        # ended before a failed one raises
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(groups),
                thread_name_prefix="repro-torch-shard") as pool:
            futures = [pool.submit(run, g) for g in groups]
        out: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(
            self._devices)
        for g, f in zip(groups, futures):
            for i, shard in zip(g, f.result()):
                out[i] = shard
        return out


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


# ------------------------------------------------------------ result cache

def graph_digest(g: Graph) -> bytes:
    """Canonical digest of one graph, independent of any batch label vocab.

    Hashes the concrete representation (raw int64 labels + adjacency), so
    equality means *identical* graphs — mappings in cached outcomes stay
    index-compatible.  Byte-equal to the reference's ``graph_digest``.

    >>> from repro_torch.ged.plan import as_graph
    >>> g = as_graph(([0, 1], [(0, 1, 1)]))
    >>> len(graph_digest(g))
    16
    >>> graph_digest(g) == graph_digest(as_graph(([0, 1], [(0, 1, 1)])))
    True
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(g.n).tobytes())
    h.update(np.ascontiguousarray(g.vlabels, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(g.adj, dtype=np.int64).tobytes())
    return h.digest()


def wl_digest(g: Graph, iters: int = 3) -> bytes:
    """Isomorphism-invariant digest: Weisfeiler-Leman color refinement.

    Vertex colors start from vertex labels and are refined ``iters`` times
    with the sorted multiset of ``(edge_label, neighbor_color)`` pairs; the
    digest hashes the sorted final color multiset, an edge summary (sorted
    ``(color, color, edge_label)`` triples) and the graph sizes, so
    isomorphic graphs always collide.  WL refinement is not a complete
    isomorphism test: WL-equivalent non-isomorphic graphs (a 6-cycle and
    two triangles) share a digest, which is the trade
    ``GedEngine(digest="wl")`` opts into.  Byte-equal to the reference's
    ``wl_digest``.

    >>> from repro_torch.ged.plan import as_graph
    >>> g = as_graph(([0, 1, 2], [(0, 1, 1), (1, 2, 2)]))
    >>> p = as_graph(([2, 1, 0], [(1, 0, 2), (2, 1, 1)]))   # relabelled copy
    >>> wl_digest(g) == wl_digest(p)
    True
    >>> graph_digest(g) == graph_digest(p)
    False
    """
    def h8(*parts: bytes) -> bytes:
        hh = hashlib.blake2b(digest_size=8)
        for p in parts:
            hh.update(p)
        return hh.digest()

    adj = g.adj
    colors = [h8(np.int64(int(a)).tobytes()) for a in g.vlabels]
    for _ in range(iters):
        colors = [
            h8(colors[v], *(np.int64(int(adj[v, u])).tobytes() + colors[u]
                            for u in sorted(np.nonzero(adj[v])[0].tolist(),
                                            key=lambda u: (adj[v, u],
                                                           colors[u]))))
            for v in range(g.n)
        ]
    out = hashlib.blake2b(digest_size=16)
    out.update(np.int64(g.n).tobytes())
    out.update(np.int64(g.m).tobytes())
    for c in sorted(colors):
        out.update(c)
    ii, jj = np.nonzero(np.triu(adj, k=1))
    for t in sorted(
        h8(*sorted((colors[i], colors[j])),
           np.int64(int(adj[i, j])).tobytes())
        for i, j in zip(ii.tolist(), jj.tolist())
    ):
        out.update(t)
    return out.digest()


DIGESTS = {"exact": graph_digest, "wl": wl_digest}


# ------------------------------------------------------- sketch signatures

# Multiplicative uint32 hash constants (Knuth / murmur-style finalisers),
# the reference's.  The same wraparound arithmetic runs in numpy on the
# host (one query graph) and in torch on the executor's device (the
# packed corpus), so signatures agree bit for bit whichever path produced
# them; CandidateIndex probes depend on that.
_H_VMUL = 2654435761        # vertex-label hash multiplier
_H_VADD = 0x9E3779B9
_H_EMUL = 0xC2B2AE35        # edge label inside the neighbor combine
_H_NMUL = 0x27D4EB2F        # per-neighbor contribution
_H_CMUL = 0x85EBCA6B        # self color between WL rounds
_H_CADD = 0x165667B1
_H_BMUL = 0x9E3779B1        # edge-label histogram bin
_H_BADD = 0x85EBCA77
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Shape of a WL-sketch signature (see :func:`wl_signature`).

    ``dims_v`` / ``dims_e`` are the hashed vertex- and edge-histogram
    widths; ``wl_iters`` rounds of Weisfeiler-Leman color refinement run
    before the vertex part is binned (0 = plain label histogram, the
    default — deeper sketches discriminate more but carry a larger
    admissible damage factor, see :func:`repro_torch.ged.index.sketch_damage`).

    >>> SketchSpec().dims        # 64 vertex + 16 edge bins + (n, m)
    82
    """

    dims_v: int = 64
    dims_e: int = 16
    wl_iters: int = 0

    @property
    def dims(self) -> int:
        return self.dims_v + self.dims_e + 2


def wl_signature(g: Graph, spec: SketchSpec = SketchSpec()) -> np.ndarray:
    """Integer sketch of one graph: hashed WL-color histogram (``dims_v``
    bins) ⊕ hashed edge-label histogram (``dims_e`` bins) ⊕ ``(n, m)``.

    One unit edit operation moves the sketch's L1 norm by a bounded amount
    (the damage factor, 2 at ``wl_iters=0``), and hashing labels into bins
    only merges histogram mass, so ``ceil(L1 / damage)`` is an admissible
    GED lower bound at any width.  Host path of the pair whose batched
    twin is :func:`batch_signatures`; byte-equal to the reference's.

    >>> from repro_torch.ged.plan import as_graph
    >>> s = wl_signature(as_graph(([0, 1], [(0, 1, 1)])))
    >>> int(s.sum() - s[-2] - s[-1]), int(s[-2]), int(s[-1])   # 2 vertices, 1 edge
    (3, 2, 1)
    """
    u32 = np.uint32
    c = np.asarray(g.vlabels, dtype=np.int64).astype(u32) * u32(_H_VMUL) \
        + u32(_H_VADD)
    adj = np.ascontiguousarray(g.adj, dtype=np.int64).astype(u32)
    present = g.adj > 0
    for _ in range(spec.wl_iters):
        h = (adj * u32(_H_EMUL) + c[None, :]) * u32(_H_NMUL)
        nsum = np.where(present, h, u32(0)).sum(axis=1, dtype=u32)
        c = c * u32(_H_CMUL) + nsum + u32(_H_CADD)
    sig = np.zeros(spec.dims, dtype=np.int32)
    sig[:spec.dims_v] = np.bincount(
        (c % u32(spec.dims_v)).astype(np.int64), minlength=spec.dims_v)
    iu, ju = np.nonzero(np.triu(g.adj, k=1))
    elabs = np.asarray(g.adj, dtype=np.int64)[iu, ju].astype(u32)
    ebin = ((elabs * u32(_H_BMUL) + u32(_H_BADD))
            % u32(spec.dims_e)).astype(np.int64)
    sig[spec.dims_v:spec.dims_v + spec.dims_e] = np.bincount(
        ebin, minlength=spec.dims_e)
    sig[-2] = g.n
    sig[-1] = g.m
    return sig


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit
    constant: ``c`` is split into 16-bit halves so no product reaches
    2**49 (torch has no uint32 multiply on the card)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _signatures(vlab: torch.Tensor, mask: torch.Tensor, adj: torch.Tensor,
                spec: SketchSpec) -> torch.Tensor:
    """:func:`wl_signature` of a padded batch: ``vlab`` / ``mask``
    ``(batch, slots)`` and ``adj`` ``(batch, slots, slots)`` int64; the
    reference's uint32 ops in the same order, in int64 masked to 32 bits.
    Returns ``(batch, dims)`` int64."""
    batch, slots = vlab.shape
    c = (_mul32(vlab & _U32, _H_VMUL) + _H_VADD) & _U32
    present = adj > 0
    adj32 = adj & _U32
    for _ in range(spec.wl_iters):
        h = _mul32((_mul32(adj32, _H_EMUL) + c[:, None, :]) & _U32, _H_NMUL)
        nsum = torch.where(present, h, 0).sum(dim=2) & _U32
        c = (_mul32(c, _H_CMUL) + nsum + _H_CADD) & _U32
    sig = torch.zeros((batch, spec.dims), dtype=torch.int64,
                      device=vlab.device)
    sig[:, :spec.dims_v].scatter_add_(1, c % spec.dims_v, mask)
    tri = torch.triu(torch.ones((slots, slots), dtype=torch.int64,
                                device=vlab.device), diagonal=1)
    w = present.to(torch.int64) * tri
    ebin = ((_mul32(adj32, _H_BMUL) + _H_BADD) & _U32) % spec.dims_e
    sig[:, spec.dims_v:spec.dims_v + spec.dims_e].scatter_add_(
        1, ebin.reshape(batch, -1), w.reshape(batch, -1))
    sig[:, -2] = mask.sum(dim=1)
    sig[:, -1] = w.sum(dim=(1, 2))
    return sig


def batch_signatures(graphs: Sequence[Graph],
                     spec: SketchSpec = SketchSpec(),
                     executor: Optional[Executor] = None,
                     chunk: int = 2048) -> np.ndarray:
    """:func:`wl_signature` for a whole corpus, batched on the executor's
    device.

    Graphs are grouped into power-of-two slot buckets (the planner's
    shapes), packed into ``(batch, slots)`` label/mask and
    ``(batch, slots, slots)`` adjacency tensors in chunks of ``chunk``
    rows, and hashed with batched torch ops (``scatter_add_`` bins the
    histograms).  On a :class:`ShardedExecutor` each chunk is padded to
    the shard multiple and split into one contiguous shard per mesh
    device, as the reference splits it over its mesh; on a
    ``torch.distributed`` mesh each rank packs and hashes only its own
    shard (:meth:`Executor.local_rows`) and one gather
    (:meth:`Executor.gather_shards`) hands every rank all of them.
    Returns ``(len(graphs), spec.dims)`` int32 on the host, row order =
    input order, bit-identical to the host path and to the reference's
    ``batch_signatures``:

    >>> from repro_torch.ged.plan import as_graph
    >>> g = as_graph(([0, 1, 0], [(0, 1, 1), (1, 2, 2)]))
    >>> ex = Executor(device="cpu")
    >>> bool((batch_signatures([g], executor=ex)[0] == wl_signature(g)).all())
    True
    """
    from repro_torch.ged.plan import slot_bucket
    sigs = np.zeros((len(graphs), spec.dims), dtype=np.int32)
    if not len(graphs):
        return sigs
    executor = executor or Executor()
    devices = executor.devices
    by_slots: Dict[int, list] = {}
    for i, g in enumerate(graphs):
        by_slots.setdefault(slot_bucket(g.n), []).append(i)
    chunks = [(slots, by_slots[slots][lo:lo + chunk])
              for slots in sorted(by_slots)
              for lo in range(0, len(by_slots[slots]), chunk)]

    def local() -> List[np.ndarray]:
        outs = []
        for slots, part in chunks:
            lo, hi = executor.local_rows(len(part))
            vlab = np.zeros((hi - lo, slots), dtype=np.int64)
            mask = np.zeros((hi - lo, slots), dtype=np.int64)
            adj = np.zeros((hi - lo, slots, slots), dtype=np.int64)
            for r, gi in enumerate(part[lo:hi]):
                g = graphs[gi]
                vlab[r, :g.n] = g.vlabels
                mask[r, :g.n] = 1
                adj[r, :g.n, :g.n] = g.adj
            size = (hi - lo) // len(devices)
            # every shard is started before any is read back
            outs.append([_signatures(*(
                torch.from_numpy(a[s * size:(s + 1) * size]).to(d)
                for a in (vlab, mask, adj)), spec)
                for s, d in enumerate(devices)])
        return [np.concatenate([o.cpu().numpy() for o in row]
                               ).astype(np.int32) for row in outs]

    parts = executor.gather_shards(local)
    for c, (_, part) in enumerate(chunks):
        out = np.concatenate([p[c] for p in parts])
        sigs[np.asarray(part, dtype=np.int64)] = out[:len(part)]
    return sigs


def pair_key_from_digests(dq: bytes, dg: bytes, verification: bool,
                          tau: Optional[float], cfg: EngineConfig,
                          backend: str, digest: str = "exact") -> tuple:
    """:func:`pair_key` when the graph digests are already in hand (the
    form :meth:`repro_torch.ged.GedEngine.cached_distance` uses)."""
    return (digest, dq, dg, bool(verification),
            None if tau is None else float(tau), cfg, backend)


def pair_key(q: Graph, g: Graph, verification: bool, tau: Optional[float],
             cfg: EngineConfig, backend: str, digest: str = "exact") -> tuple:
    """Cache key for one query: pair digests + mode (tau-aware) + config.

    The same pair in a different mode (or at a different tau) keys
    differently, so a verification answer never shadows a computation.
    ``cfg`` enters as given: ``use_kernel="auto"`` stays unresolved, so
    tuned and untuned runs (bit-identical outcomes) share entries.

    >>> from repro_torch.ged.plan import as_graph
    >>> q = as_graph(([0], [])); g = as_graph(([1], []))
    >>> pair_key(q, g, True, 2.0, None, "torch") == \\
    ...     pair_key(q, g, False, None, None, "torch")
    False
    >>> p = as_graph(([1], []))                 # same graph, new object
    >>> pair_key(q, p, False, None, None, "torch", digest="wl") == \\
    ...     pair_key(q, g, False, None, None, "torch", digest="wl")
    True
    """
    fn = DIGESTS[digest]
    return pair_key_from_digests(fn(q), fn(g), verification, tau, cfg,
                                 backend, digest=digest)


def detached(outcome: GedOutcome, stats: Dict[str, float]) -> GedOutcome:
    """An independent copy of ``outcome`` — own stats dict, own mapping
    array — with ``stats`` swapped in, so a caller may mutate what it is
    handed without corrupting a cached entry or a duplicate's answer.

    >>> a = GedOutcome(ged=1.0, similar=None, certified=True,
    ...                lower_bound=1.0, upper_bound=1.0, mapping=None,
    ...                backend="exact", wall_s=0.0, stats={"rung": 0})
    >>> b = detached(a, {**a.stats, "cached": True})
    >>> b.stats["cached"], "cached" in a.stats
    (True, False)
    """
    mapping = None if outcome.mapping is None else np.array(outcome.mapping)
    return dataclasses.replace(outcome, mapping=mapping, stats=stats)


class ResultCache:
    """LRU cache of :class:`GedOutcome` keyed by :func:`pair_key`.

    Sits in front of every executor (``GedEngine`` consults it before
    planning), so duplicate pairs — across calls or within one batch —
    never re-execute, whatever the backend.

    >>> cache = ResultCache(maxsize=2)
    >>> cache.get(("some", "key")) is None     # miss
    True
    >>> out = GedOutcome(ged=2.0, similar=None, certified=True,
    ...                  lower_bound=2.0, upper_bound=2.0, mapping=None,
    ...                  backend="torch", wall_s=0.01)
    >>> cache.put(("some", "key"), out)
    >>> hit = cache.get(("some", "key"))
    >>> hit.ged, hit.stats["cached"], (cache.hits, cache.misses)
    (2.0, True, (1, 1))
    """

    def __init__(self, maxsize: int = 4096):
        self.maxsize = int(maxsize)
        self._entries: "collections.OrderedDict[tuple, GedOutcome]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        # distance-reuse probes (cached_distance) are counted apart from
        # query hits/misses: a probe miss is expected and must not skew
        # the hit rate of the query path
        self.pivot_hits = 0
        self.pivot_misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def peek(self, key: tuple) -> Optional[GedOutcome]:
        """Read-only probe: no LRU bump, no hit/miss counting and no
        detached copy.  Callers treat the entry as frozen and read only
        scalars off it (``ged``, ``certified``), never its ``mapping``."""
        return self._entries.get(key)

    def get(self, key: tuple) -> Optional[GedOutcome]:
        out = self._entries.get(key)
        if out is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        # wall_s stays the cost of the run that produced the entry
        return detached(out, {**out.stats, "cached": True})

    def put(self, key: tuple, outcome: GedOutcome) -> None:
        self._entries[key] = detached(outcome, dict(outcome.stats))
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
