"""The front door of the port: ``repro_torch.ged.GedEngine``.

    from repro_torch import ged

    outcomes = ged.compute([(q, g), ...])          # "auto", on the card
    engine = ged.GedEngine("torch", pool=512, device="cpu")
    outcomes = engine.verify(pairs, tau=4.0)
    engine.submit(q, g); engine.submit(q2, g2, tau=3.0)
    outcomes = engine.flush()                      # streaming

Inputs are anything :func:`repro_torch.ged.plan.as_graph` understands;
every entry point returns one :class:`GedOutcome` per pair.  Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a visible GPU the default raises.

In front of every backend sits an engine-level result cache
(:class:`repro_torch.ged.exec.ResultCache`): queries are keyed on
canonical pair digests (label-vocab-independent; tau-aware for
verification), so duplicate pairs — within one batch or across calls —
are answered without planning or running the engine again.
``GedEngine(cache=False)`` opts out (timed runs do, to time real work).

``deadline_s`` makes every call *anytime*: when the budget runs out,
each pair still comes back, uncertified, with admissible best-so-far
bounds (:mod:`repro_torch.ged.faults`).  Injected faults, and any
failure on the CPU, degrade down a ladder (engine -> host solver ->
admissible floor) instead of raising; a real kernel or CUDA failure on
the card is raised.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.engine.search import EngineConfig
from repro_torch.device import DeviceLike
from repro_torch.ged.backends import Backend, make_backend
from repro_torch.ged.exec import (DIGESTS, ResultCache, detached,
                                  enable_compile_cache, pair_key,
                                  pair_key_from_digests,
                                  persistent_cache_stats)
from repro_torch.ged.faults import (Deadline, FaultInjector, RetryPolicy,
                                    RunContext)
from repro_torch.ged.plan import Vocab, as_graph, as_pairs, build_plan
from repro_torch.ged.results import GedOutcome
from repro_torch.kernels.autotune import autotune_stats, enable_autotune
from repro_torch.parallel.sharding import Mesh, is_distributed_mesh
from repro_torch.store_io.shared_cache import (SHARED_CACHE_ENV,
                                               SharedResultCache)

Taus = Union[float, Sequence[float]]

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(EngineConfig)}


class GedEngine:
    """Facade over the port's GED backends.

    Parameters
    ----------
    backend : ``"auto"`` (default) | ``"exact"`` | ``"cuda"`` | ``"torch"``
        | ``"sharded"`` or any name registered via
        :func:`repro_torch.ged.register_backend`.
        ``"auto"`` escalates uncertified pairs through growing engine rungs
        to the host solver, so every answer is certified; ``"exact"`` is
        the host solver alone; ``"cuda"`` runs the engine with the
        hand-written kernels on the hot path, ``"torch"`` the plain
        PyTorch engine, ``"sharded"`` the plain engine with every batch
        split over the devices of ``mesh``, all with identical outcomes.
    device : ``"cuda"`` (default) or ``"cpu"``.  The default needs a
        visible GPU and raises without one.
    mesh : devices for the ``"sharded"`` and ``"auto"`` backends, a flat
        sequence such as ``["cuda:0", "cuda:1"]`` or ``["cpu"] * 4``, or
        a named :class:`~repro_torch.parallel.sharding.DeviceMesh`
        (:func:`repro_torch.parallel.sharding.pair_devices`): each batch
        is padded to a multiple of its shard count (the flat mesh's
        length, or the size of the named mesh's pairs axes) and split
        into one contiguous shard per entry or pairs index.
        ``"sharded"`` defaults to every visible card; ``"auto"`` runs on
        one device unless a mesh is given.  A bare nested or a mixed
        mesh, or a ``device`` that disagrees with it, raises
        ``ValueError``.  The other backends ignore it, as
        in the reference.  It may also be a ``torch.distributed``
        ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`, one process per
        card, as ``torchrun`` starts them), used SPMD: every rank builds
        the engine at the same point and calls the same methods with the
        same arguments in the same order.  Each rank searches its own
        shard of every batch (sharded over ``pod`` x ``data``, else the
        first axis) on its own device, and every rank returns the whole
        batch's outcomes, the same on each rank and equal to the
        one-device run's; a failure on one rank raises, or degrades, on
        all of them, and deadlines are agreed.  The shared result-cache
        tier is per machine, so ranks would answer from different entries:
        it raises there (pass ``shared_cache_dir=""`` to turn off one set
        in the environment).
    slots : pin every batch to this slot count instead of per-pair
        power-of-two bucketing.
    vocab : optional ``(vertex_labels, edge_labels)`` universe shared by
        every bucket.
    batch_size : scheduler batch size (``"auto"`` only).
    overlap : overlapped rung execution (``"auto"`` only, default True);
        ``overlap=False`` is the sequential rung loop.  Outcomes are
        identical either way.
    max_in_flight : rung buckets dispatched but not yet drained at once
        (``"auto"``, overlap mode).
    cache : keep an engine-level result cache (default True): duplicate
        pairs — within one batch or across calls — are answered from the
        cache instead of running again.  ``cache_size`` bounds it (LRU).
    shared_cache_dir : directory of the cross-process result-cache tier
        (default: ``$REPRO_GED_SHARED_CACHE_DIR``; unset means off).  An
        on-disk, file-locked LRU of certified scalars
        (:class:`repro_torch.store_io.SharedResultCache`) behind the
        in-memory cache: probed on in-memory misses (hits are promoted),
        written with every certified outcome, in the reference's format.
        Counters appear in :attr:`stats` as ``shared_cache_*``.
    compile_cache_dir : build directory of the CUDA kernel library
        (default: ``$REPRO_GED_COMPILE_CACHE_DIR``; unset means
        ``build/repro_torch_kernels``).  The library is built there once
        and loaded by later processes.  Process-global; counters appear
        in :attr:`stats` as ``persistent_cache_*``.
    digest : graph hash of the result-cache keys.  ``"exact"`` (default)
        keys byte-identical graphs, so cached mappings stay valid;
        ``"wl"`` keys Weisfeiler-Leman digests, so isomorphic duplicates
        hit too (and WL-equivalent non-isomorphic pairs alias: the trade
        it opts into); cached copies then drop their mappings.
    autotune_dir : directory of the measured kernel-tuning table (default:
        ``$REPRO_GED_AUTOTUNE_DIR``; unset means in memory only).
        ``use_kernel="auto"`` resolves each bucket's ``(slots, batch)``
        shape to fused or unfused kernels through it; pre-warm it with
        :func:`repro_torch.kernels.autotune.tune`.  Process-global.
    deadline_s : wall-clock budget of the search in each ``compute`` /
        ``verify`` call (default ``None``: unbounded, bit-identical to no
        deadline).  As in the reference, the clock starts once the call's
        pairs are digested and planned: that preparation comes on top of
        the budget.  ``flush`` starts one clock when it is called and
        shares it across its sub-batches.  On expiry, in-flight work
        drains, remaining rungs are skipped and every pair still returns a
        :class:`GedOutcome` with best-so-far admissible ``lower_bound`` /
        ``upper_bound``, ``certified=False`` and ``timed_out`` set.  Each
        entry point takes a per-call override.  A dispatch is the unit of
        work: a call returns after the dispatch in progress when the
        budget ran out.
    per_pair_deadline_s : additional per-pair budget for host-solver
        searches (checked inside the search loop), capped by what remains
        of ``deadline_s``.
    fault_inject : deterministic fault spec (a string for
        :class:`repro_torch.ged.faults.FaultInjector`, or an injector)
        scoped to this engine; ``REPRO_GED_FAULT_INJECT`` injects
        process-wide instead.
    retry : :class:`repro_torch.ged.faults.RetryPolicy` for transient
        dispatch failures (default: 2 retries, exponential backoff and
        jitter).
    Remaining keyword arguments (``pool``, ``expand``, ``max_iters``,
    ``sweeps``, ``bound``, ``strategy``, ``use_kernel``, ``dispatch``)
    override :class:`EngineConfig` defaults.  ``use_kernel`` is implied by
    ``"torch"`` and ``"sharded"`` (False) and ``"cuda"`` (True): a
    contradicting boolean raises, while ``use_kernel="auto"`` is accepted
    on every backend — it picks among bit-identical implementations, so
    outcomes never change.

    >>> from repro_torch import ged
    >>> q, g = ([0, 1], [(0, 1, 1)]), ([0, 2], [(0, 1, 1)])
    >>> eng = ged.GedEngine("torch", device="cpu", pool=16, expand=2)
    >>> [o.ged for o in eng.compute([(q, g)])]
    [1.0]

    The anytime deadline contract: an exhausted budget still answers
    every pair, with sound bounds.

    >>> eng = ged.GedEngine("exact", device="cpu", deadline_s=0.0)
    >>> out, = eng.compute([(q, g)])
    >>> out.timed_out, out.certified, out.lower_bound, out.upper_bound
    (True, False, 1.0, inf)
    >>> out, = eng.compute([(q, g)], deadline_s=60.0)   # per-call override
    >>> out.ged, out.certified
    (1.0, True)
    """

    def __init__(self, backend: str = "auto", *,
                 device: DeviceLike = None,
                 mesh: Mesh = None,
                 slots: Optional[int] = None,
                 vocab: Optional[Vocab] = None,
                 batch_size: int = 256,
                 overlap: bool = True,
                 max_in_flight: int = 4,
                 cache: bool = True,
                 cache_size: int = 4096,
                 shared_cache_dir: Optional[str] = None,
                 compile_cache_dir: Optional[str] = None,
                 autotune_dir: Optional[str] = None,
                 digest: str = "exact",
                 deadline_s: Optional[float] = None,
                 per_pair_deadline_s: Optional[float] = None,
                 fault_inject: Union[None, str, FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 config: Optional[EngineConfig] = None,
                 **config_overrides):
        unknown = set(config_overrides) - _CONFIG_FIELDS
        if unknown:
            raise TypeError(f"unknown GedEngine options: {sorted(unknown)}")
        self.deadline_s = deadline_s
        self.per_pair_deadline_s = per_pair_deadline_s
        self._injector = (FaultInjector(fault_inject)
                          if isinstance(fault_inject, str) else fault_inject)
        self._retry = retry if retry is not None else RetryPolicy()
        self._fault_stats: Dict[str, float] = {}
        if digest not in DIGESTS:
            raise ValueError(f"unknown digest {digest!r}; "
                             f"expected one of {sorted(DIGESTS)}")
        self.digest = digest
        self.compile_cache_dir = enable_compile_cache(compile_cache_dir)
        self.autotune_dir = enable_autotune(autotune_dir)
        if config is None:
            config = EngineConfig(**{"use_kernel": False, **config_overrides})
        elif config_overrides:
            config = dataclasses.replace(config, **config_overrides)
        self.slots = slots
        self.vocab = vocab
        self._cache = ResultCache(cache_size) if cache else None
        if shared_cache_dir is None:
            shared_cache_dir = os.environ.get(SHARED_CACHE_ENV) or None
        if shared_cache_dir and is_distributed_mesh(mesh):
            raise ValueError(
                "the shared result-cache tier cannot serve the ranks of a "
                "torch.distributed mesh: each would answer from different "
                "entries; pass shared_cache_dir=''")
        self._shared = (SharedResultCache(str(shared_cache_dir))
                        if shared_cache_dir else None)
        self.shared_cache_dir = shared_cache_dir
        self._pending: List[Tuple[object, object, Optional[float]]] = []
        self._backend: Backend = make_backend(
            backend, device=device, mesh=mesh, batch_size=batch_size,
            overlap=overlap, max_in_flight=max_in_flight)
        self.backend = self._backend.name
        self.device = getattr(getattr(self._backend, "executor", None),
                              "device", None)
        # "torch" means plain PyTorch and "cuda" means kernels; default the
        # flag from the backend name and refuse a contradicting boolean.
        # "auto" is welcome everywhere: it picks among bit-identical paths.
        self._kernel_default = getattr(self._backend, "kernel_default", None)
        if self._kernel_default is not None:
            asked = config_overrides.get("use_kernel")
            if asked is not None and asked != "auto" \
                    and asked != self._kernel_default:
                raise ValueError(
                    f"backend {backend!r} implies use_kernel="
                    f"{self._kernel_default}; use the "
                    f"{'cuda' if asked else 'torch'!r} backend instead")
            if asked != "auto":
                config = dataclasses.replace(config,
                                             use_kernel=self._kernel_default)
        self.config = config
        # a backend registered without ``ctx`` in its run() signature
        # keeps working: the context is passed only when it is named
        try:
            self._backend_takes_ctx = "ctx" in inspect.signature(
                self._backend.run).parameters
        except (TypeError, ValueError):            # pragma: no cover
            self._backend_takes_ctx = False

    def compute(self, pairs, vocab: Optional[Vocab] = None,
                deadline_s: Union[None, float, Deadline] = None,
                per_pair_deadline_s: Optional[float] = None,
                **config_overrides) -> List[GedOutcome]:
        """Exact-with-certificate GED for every pair.

        ``vocab`` overrides the engine's label universe for this call
        only; ``deadline_s`` / ``per_pair_deadline_s`` override the
        engine's budgets for this call.
        """
        return self._run(pairs, None, False, config_overrides, vocab,
                         deadline_s, per_pair_deadline_s)

    def verify(self, pairs, tau: Taus, vocab: Optional[Vocab] = None,
               deadline_s: Union[None, float, Deadline] = None,
               per_pair_deadline_s: Optional[float] = None,
               **config_overrides) -> List[GedOutcome]:
        """Certified ``delta(q, g) <= tau``? for every pair.

        ``tau`` is a scalar (broadcast) or one threshold per pair; the
        other arguments as in :meth:`compute`.
        """
        return self._run(pairs, tau, True, config_overrides, vocab,
                         deadline_s, per_pair_deadline_s)

    def submit(self, q, g, tau: Optional[float] = None) -> int:
        """Enqueue one pair (verification when ``tau`` is given, otherwise
        computation); returns its ticket — the index into ``flush()``'s
        result list.

        >>> from repro_torch import ged
        >>> eng = ged.GedEngine("exact", device="cpu")
        >>> eng.submit(([0], []), ([1], []))        # computation
        0
        >>> eng.submit(([0], []), ([0], []), tau=0.5)   # verification
        1
        >>> [(o.ged, o.similar) for o in eng.flush()]
        [(1.0, None), (None, True)]
        """
        self._pending.append((q, g, None if tau is None else float(tau)))
        return len(self._pending) - 1

    def flush(self, deadline_s: Union[None, float, Deadline] = None,
              per_pair_deadline_s: Optional[float] = None
              ) -> List[GedOutcome]:
        """Answer every submitted pair, in submission order.

        Computation and verification submissions come back as one list
        aligned with the tickets :meth:`submit` returned; a drained engine
        flushes to ``[]``.  ``deadline_s`` is one budget for the whole
        flush: the computation and verification sub-batches draw from the
        same clock.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return []
        dl = deadline_s if deadline_s is not None else self.deadline_s
        shared = dl if isinstance(dl, Deadline) or dl is None \
            else Deadline(dl)
        results: List[Optional[GedOutcome]] = [None] * len(pending)
        comp = [i for i, (_, _, tau) in enumerate(pending) if tau is None]
        veri = [i for i, (_, _, tau) in enumerate(pending) if tau is not None]
        if comp:
            outs = self.compute([pending[i][:2] for i in comp],
                                deadline_s=shared,
                                per_pair_deadline_s=per_pair_deadline_s)
            for i, o in zip(comp, outs):
                results[i] = o
        if veri:
            outs = self.verify([pending[i][:2] for i in veri],
                               [pending[i][2] for i in veri],
                               deadline_s=shared,
                               per_pair_deadline_s=per_pair_deadline_s)
            for i, o in zip(veri, outs):
                results[i] = o
        return results  # type: ignore[return-value]

    @property
    def batch_multiple(self) -> int:
        """Shard count every batch is padded to (1 on a single device)."""
        return getattr(self._backend, "batch_multiple", 1)

    @property
    def stats(self) -> Dict[str, float]:
        """Backend counters (``"auto"``: ``pairs``, ``escalated``,
        ``host_solved``, ``batches``, ``dispatches``, ``overlap_saved_s``,
        ``survivors_rung_{k}``), ``executor_*`` counters, the result
        cache's ``result_cache_*`` and ``index_pivot_*`` counters (with
        ``cache=True``), the shared tier's ``shared_cache_*`` (with a
        ``shared_cache_dir``), the kernel build's ``persistent_cache_*``
        (with a ``compile_cache_dir``), the tuning table's
        ``autotune_*`` counters, and the robustness counters
        (``retries``, ``degraded_host``, ``fault_*``, ``timed_out_pairs``)
        once the event has happened.

        >>> from repro_torch import ged
        >>> eng = ged.GedEngine("exact", device="cpu")
        >>> _ = eng.compute([(([0], []), ([1], []))])
        >>> eng.stats["result_cache_misses"]
        1
        """
        out: Dict[str, float] = dict(getattr(self._backend, "stats", {}))
        executor = getattr(self._backend, "executor", None)
        if executor is not None:
            out.update({f"executor_{k}": v
                        for k, v in executor.stats.items()})
        if self._cache is not None:
            out["result_cache_hits"] = self._cache.hits
            out["result_cache_misses"] = self._cache.misses
            out["result_cache_entries"] = len(self._cache)
            out["index_pivot_hits"] = self._cache.pivot_hits
            out["index_pivot_misses"] = self._cache.pivot_misses
        if self._shared is not None:
            out["shared_cache_hits"] = self._shared.hits
            out["shared_cache_misses"] = self._shared.misses
            out["shared_cache_evictions"] = self._shared.evictions
            out["shared_cache_entries"] = self._shared.entries()
            out["shared_cache_lock_timeouts"] = self._shared.lock_timeouts
        # robustness counters accumulated across runs; an absent key means
        # nothing happened
        out.update(self._fault_stats)
        out.update(persistent_cache_stats())
        out.update(autotune_stats())
        return out

    def cached_distance(self, q=None, g=None, *,
                        digests: Optional[Tuple[bytes, bytes]] = None
                        ) -> Optional[float]:
        """A certified exact distance for one pair straight from the result
        cache — no planning, no execution, ``None`` on a miss.

        Pass ``digests=(dq, dg)`` when the graphs are already hashed; both
        orientations of the pair are probed.  Only certified computation
        entries answer, and only the scalar comes back.  Lookups count
        into ``stats["index_pivot_hits"]`` / ``["index_pivot_misses"]``,
        not the query path's ``result_cache_*``.

        >>> from repro_torch import ged
        >>> eng = ged.GedEngine("exact", device="cpu")
        >>> a, b = ([0], []), ([1], [])
        >>> eng.cached_distance(a, b) is None       # nothing cached yet
        True
        >>> _ = eng.compute([(a, b)])
        >>> eng.cached_distance(b, a)               # either orientation
        1.0
        """
        if self._cache is None:
            return None
        if digests is None:
            fn = DIGESTS[self.digest]
            digests = (fn(as_graph(q)), fn(as_graph(g)))
        for dq, dg in (digests, digests[::-1]):
            key = pair_key_from_digests(dq, dg, False, None, self.config,
                                        self.backend, digest=self.digest)
            out = self._cache.peek(key)
            if out is not None and out.certified and out.ged is not None:
                self._cache.pivot_hits += 1
                return float(out.ged)
        self._cache.pivot_misses += 1
        return None

    def _run(self, pairs, tau: Optional[Taus], verification: bool,
             overrides: dict, vocab: Optional[Vocab],
             deadline_s: Union[None, float, Deadline] = None,
             per_pair_deadline_s: Optional[float] = None
             ) -> List[GedOutcome]:
        unknown = set(overrides) - _CONFIG_FIELDS
        if unknown:
            raise TypeError(f"unknown engine options: {sorted(unknown)}")
        asked = overrides.get("use_kernel")
        if (asked is not None and asked != "auto"
                and self._kernel_default is not None
                and asked != self._kernel_default):
            raise ValueError(
                f"backend {self.backend!r} implies use_kernel="
                f"{self._kernel_default}")
        cfg = dataclasses.replace(self.config, **overrides) \
            if overrides else self.config
        pairs = as_pairs(pairs)
        n = len(pairs)
        if n == 0:
            return []
        if verification:
            taus = np.broadcast_to(
                np.asarray(tau, dtype=np.float32), (n,)).copy()
        else:
            taus = np.zeros((n,), dtype=np.float32)

        results: List[Optional[GedOutcome]] = [None] * n
        run_idx = list(range(n))
        keys: List[Optional[tuple]] = [None] * n
        dup_of: Dict[int, int] = {}
        if self._cache is not None or self._shared is not None:
            run_idx, seen = [], {}
            for i, (q, g) in enumerate(pairs):
                keys[i] = pair_key(
                    q, g, verification,
                    float(taus[i]) if verification else None, cfg,
                    self.backend, digest=self.digest)
                if keys[i] in seen:
                    # duplicate within this batch: runs once, answers twice
                    dup_of[i] = seen[keys[i]]
                    if self._cache is not None:
                        self._cache.hits += 1
                    continue
                hit = self._cache.get(keys[i]) \
                    if self._cache is not None else None
                if hit is None and self._shared is not None:
                    # the cross-process tier answers in-memory misses;
                    # promote hits so this process stops paying disk
                    hit = self._shared.get(keys[i])
                    if hit is not None and self._cache is not None:
                        self._cache.put(keys[i], self._cache_view(hit))
                if hit is not None:
                    results[i] = hit
                else:
                    seen[keys[i]] = i
                    run_idx.append(i)

        if run_idx:
            plan = build_plan(
                [pairs[i] for i in run_idx], slots=self.slots,
                vocab=vocab if vocab is not None else self.vocab,
                batch_multiple=self.batch_multiple)
            dl = deadline_s if deadline_s is not None else self.deadline_s
            pp = (per_pair_deadline_s if per_pair_deadline_s is not None
                  else self.per_pair_deadline_s)
            ctx = RunContext(
                deadline=dl if isinstance(dl, Deadline) else Deadline(dl),
                per_pair_deadline_s=pp, injector=self._injector,
                retry=self._retry)
            if self._backend_takes_ctx:
                outs = self._backend.run(plan, taus[run_idx], verification,
                                         cfg, ctx=ctx)
            else:
                outs = self._backend.run(plan, taus[run_idx], verification,
                                         cfg)
            for k, v in ctx.stats.items():
                self._fault_stats[k] = self._fault_stats.get(k, 0) + v
            for i, o in zip(run_idx, outs):
                results[i] = o
                # never cache a timed-out or fault-degraded uncertified
                # answer: a later unconstrained run must not be poisoned by
                # this run's budget or faults (degraded but certified
                # answers are exact, so they stay cacheable)
                if o.timed_out or (not o.certified
                                   and o.stats.get("degraded")):
                    continue
                if self._cache is not None:
                    self._cache.put(keys[i], self._cache_view(o))
                if self._shared is not None:
                    self._shared.put(keys[i], o)   # certified-only inside
        for i, j in dup_of.items():
            # a distinct outcome per position, so mutating one entry
            # cannot leak into its duplicates (or the cache)
            results[i] = detached(self._cache_view(results[j]),
                                  {**results[j].stats, "cached": True})
        return results  # type: ignore[return-value]

    def _cache_view(self, outcome: GedOutcome) -> GedOutcome:
        """What a cache (or in-batch duplicate) may reuse of ``outcome``:
        everything under exact digests; under WL digests the vertex
        mapping, valid only for the graph that produced it, is dropped."""
        if self.digest == "exact" or outcome.mapping is None:
            return outcome
        return dataclasses.replace(outcome, mapping=None)


def compute(pairs, backend: str = "auto", **options) -> List[GedOutcome]:
    """One-shot :meth:`GedEngine.compute` with a throwaway engine.

    >>> from repro_torch import ged
    >>> [o.ged for o in ged.compute([(([0], []), ([1], []))],
    ...                             backend="torch", device="cpu")]
    [1.0]
    """
    return GedEngine(backend, **options).compute(pairs)


def verify(pairs, tau: Taus, backend: str = "auto",
           **options) -> List[GedOutcome]:
    """One-shot :meth:`GedEngine.verify` with a throwaway engine.

    >>> from repro_torch import ged
    >>> [o.similar for o in ged.verify([(([0], []), ([1], []))], tau=2.0,
    ...                                backend="torch", device="cpu")]
    [True]
    """
    return GedEngine(backend, **options).verify(pairs, tau)
