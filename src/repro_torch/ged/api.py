"""The front door of the port: ``repro_torch.ged.GedEngine``.

    from repro_torch import ged

    outcomes = ged.compute([(q, g), ...])          # "auto", on the card
    engine = ged.GedEngine("torch", pool=512, device="cpu")
    outcomes = engine.verify(pairs, tau=4.0)

Inputs are anything :func:`repro_torch.ged.plan.as_graph` understands;
every entry point returns one :class:`GedOutcome` per pair.  Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a visible GPU the default raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.engine.search import EngineConfig
from repro_torch.device import DeviceLike
from repro_torch.ged.backends import Backend, make_backend
from repro_torch.ged.plan import Vocab, as_pairs, build_plan
from repro_torch.ged.results import GedOutcome
from repro_torch.kernels.autotune import autotune_stats, enable_autotune

Taus = Union[float, Sequence[float]]

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(EngineConfig)}

# options of the reference's GedEngine that the port does not have yet
_NOT_PORTED_OPTIONS = ("cache", "cache_size", "shared_cache_dir",
                       "compile_cache_dir", "digest", "deadline_s",
                       "per_pair_deadline_s", "retry", "fault_inject", "mesh")


def _refuse_unported(options) -> None:
    asked = sorted(set(options) & set(_NOT_PORTED_OPTIONS))
    if asked:
        raise TypeError(f"GedEngine options {asked} are not ported yet "
                        "(see ROADMAP.md, queue 1)")


class GedEngine:
    """Facade over the port's GED backends.

    Parameters
    ----------
    backend : ``"auto"`` (default) | ``"exact"`` | ``"cuda"`` | ``"torch"``
        or any name registered via :func:`repro_torch.ged.register_backend`.
        ``"auto"`` escalates uncertified pairs through growing engine rungs
        to the host solver, so every answer is certified; ``"exact"`` is
        the host solver alone; ``"cuda"`` runs the engine with the
        hand-written kernels on the hot path, ``"torch"`` the plain
        PyTorch engine, both with identical outcomes.
    device : ``"cuda"`` (default) or ``"cpu"``.  The default needs a
        visible GPU and raises without one.
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
    autotune_dir : directory of the measured kernel-tuning table (default:
        ``$REPRO_GED_AUTOTUNE_DIR``; unset means in memory only).
        ``use_kernel="auto"`` resolves each bucket's ``(slots, batch)``
        shape to fused or unfused kernels through it; pre-warm it with
        :func:`repro_torch.kernels.autotune.tune`.  Process-global.
    Remaining keyword arguments (``pool``, ``expand``, ``max_iters``,
    ``sweeps``, ``bound``, ``strategy``, ``use_kernel``, ``dispatch``)
    override :class:`EngineConfig` defaults.  ``use_kernel`` is implied by
    ``"torch"`` (False) and ``"cuda"`` (True): a contradicting boolean
    raises, while ``use_kernel="auto"`` is accepted on every backend — it
    picks among bit-identical implementations, so outcomes never change.
    The reference's result cache, deadlines, retries, fault injection and
    mesh are not ported yet; passing one raises ``TypeError``.

    >>> from repro_torch import ged
    >>> eng = ged.GedEngine("torch", device="cpu", pool=16, expand=2)
    >>> [o.ged for o in eng.compute([(([0, 1], [(0, 1, 1)]),
    ...                               ([0, 2], [(0, 1, 1)]))])]
    [1.0]
    """

    def __init__(self, backend: str = "auto", *,
                 device: DeviceLike = None,
                 slots: Optional[int] = None,
                 vocab: Optional[Vocab] = None,
                 batch_size: int = 256,
                 overlap: bool = True,
                 max_in_flight: int = 4,
                 autotune_dir: Optional[str] = None,
                 config: Optional[EngineConfig] = None,
                 **config_overrides):
        _refuse_unported(config_overrides)
        unknown = set(config_overrides) - _CONFIG_FIELDS
        if unknown:
            raise TypeError(f"unknown GedEngine options: {sorted(unknown)}")
        self.autotune_dir = enable_autotune(autotune_dir)
        if config is None:
            config = EngineConfig(**{"use_kernel": False, **config_overrides})
        elif config_overrides:
            config = dataclasses.replace(config, **config_overrides)
        self.slots = slots
        self.vocab = vocab
        self._backend: Backend = make_backend(
            backend, device=device, batch_size=batch_size, overlap=overlap,
            max_in_flight=max_in_flight)
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

    def compute(self, pairs, vocab: Optional[Vocab] = None,
                **config_overrides) -> List[GedOutcome]:
        """Exact-with-certificate GED for every pair.

        ``vocab`` overrides the engine's label universe for this call only.
        """
        return self._run(pairs, None, False, config_overrides, vocab)

    def verify(self, pairs, tau: Taus, vocab: Optional[Vocab] = None,
               **config_overrides) -> List[GedOutcome]:
        """Certified ``delta(q, g) <= tau``? for every pair.

        ``tau`` is a scalar (broadcast) or one threshold per pair.
        """
        return self._run(pairs, tau, True, config_overrides, vocab)

    @property
    def batch_multiple(self) -> int:
        """Shard count every batch is padded to (1 on a single device)."""
        return getattr(self._backend, "batch_multiple", 1)

    @property
    def stats(self):
        """Backend counters (``"auto"``: ``pairs``, ``escalated``,
        ``host_solved``, ``batches``, ``dispatches``, ``overlap_saved_s``,
        ``survivors_rung_{k}``), ``executor_*`` counters and the tuning
        table's ``autotune_*`` counters."""
        out = dict(getattr(self._backend, "stats", {}))
        executor = getattr(self._backend, "executor", None)
        if executor is not None:
            out.update({f"executor_{k}": v
                        for k, v in executor.stats.items()})
        out.update(autotune_stats())
        return out

    def _run(self, pairs, tau: Optional[Taus], verification: bool,
             overrides: dict, vocab: Optional[Vocab]) -> List[GedOutcome]:
        _refuse_unported(overrides)
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
        plan = build_plan(pairs, slots=self.slots,
                          vocab=vocab if vocab is not None else self.vocab,
                          batch_multiple=self.batch_multiple)
        return self._backend.run(plan, taus, verification, cfg)


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
