"""The front door of the port: ``repro_torch.ged.GedEngine``.

    from repro_torch import ged

    outcomes = ged.compute([(q, g), ...])                 # on the card
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

Taus = Union[float, Sequence[float]]

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(EngineConfig)}


class GedEngine:
    """Facade over the port's GED backends.

    Parameters
    ----------
    backend : ``"cuda"`` (default) | ``"torch"`` or any name registered via
        :func:`repro_torch.ged.register_backend`.  ``"cuda"`` runs the
        hand-written kernels on the hot path, ``"torch"`` the plain
        PyTorch engine; both give identical outcomes.  The reference's
        default, the escalating ``"auto"`` backend, is not ported yet, so
        until it lands the port defaults to ``"cuda"``.
    device : ``"cuda"`` (default) or ``"cpu"``.  The default needs a
        visible GPU and raises without one.
    slots : pin every batch to this slot count instead of per-pair
        power-of-two bucketing.
    vocab : optional ``(vertex_labels, edge_labels)`` universe shared by
        every bucket.
    Remaining keyword arguments (``pool``, ``expand``, ``max_iters``,
    ``sweeps``, ``bound``, ``strategy``, ``use_kernel``) override
    :class:`EngineConfig` defaults.  ``use_kernel`` is implied by the
    backend name (``"torch"`` False, ``"cuda"`` True); passing a
    contradicting value raises.

    >>> from repro_torch import ged
    >>> eng = ged.GedEngine("torch", device="cpu", pool=16, expand=2)
    >>> [o.ged for o in eng.compute([(([0, 1], [(0, 1, 1)]),
    ...                               ([0, 2], [(0, 1, 1)]))])]
    [1.0]
    """

    def __init__(self, backend: str = "cuda", *,
                 device: DeviceLike = None,
                 slots: Optional[int] = None,
                 vocab: Optional[Vocab] = None,
                 config: Optional[EngineConfig] = None,
                 **config_overrides):
        unknown = set(config_overrides) - _CONFIG_FIELDS
        if unknown:
            raise TypeError(f"unknown GedEngine options: {sorted(unknown)}")
        if config is None:
            config = EngineConfig(**{"use_kernel": False, **config_overrides})
        elif config_overrides:
            config = dataclasses.replace(config, **config_overrides)
        self.slots = slots
        self.vocab = vocab
        self._backend: Backend = make_backend(backend, device=device)
        self.backend = self._backend.name
        self.device = getattr(getattr(self._backend, "executor", None),
                              "device", None)
        # "torch" means plain PyTorch and "cuda" means kernels; default the
        # flag from the backend name and refuse a contradicting value
        self._kernel_default = getattr(self._backend, "kernel_default", None)
        if self._kernel_default is not None:
            asked = config_overrides.get("use_kernel")
            if asked is not None and asked != self._kernel_default:
                raise ValueError(
                    f"backend {backend!r} implies use_kernel="
                    f"{self._kernel_default}; use the "
                    f"{'cuda' if asked else 'torch'!r} backend instead")
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
    def stats(self):
        """Executor counters (``executor_calls``, ``executor_pairs``)."""
        executor = getattr(self._backend, "executor", None)
        if executor is None:
            return {}
        return {f"executor_{k}": v for k, v in executor.stats.items()}

    def _run(self, pairs, tau: Optional[Taus], verification: bool,
             overrides: dict, vocab: Optional[Vocab]) -> List[GedOutcome]:
        unknown = set(overrides) - _CONFIG_FIELDS
        if unknown:
            raise TypeError(f"unknown engine options: {sorted(unknown)}")
        asked = overrides.get("use_kernel")
        if (asked is not None and self._kernel_default is not None
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
                          vocab=vocab if vocab is not None else self.vocab)
        return self._backend.run(plan, taus, verification, cfg)


def compute(pairs, backend: str = "cuda", **options) -> List[GedOutcome]:
    """One-shot :meth:`GedEngine.compute` with a throwaway engine.

    >>> from repro_torch import ged
    >>> [o.ged for o in ged.compute([(([0], []), ([1], []))],
    ...                             backend="torch", device="cpu")]
    [1.0]
    """
    return GedEngine(backend, **options).compute(pairs)


def verify(pairs, tau: Taus, backend: str = "cuda",
           **options) -> List[GedOutcome]:
    """One-shot :meth:`GedEngine.verify` with a throwaway engine.

    >>> from repro_torch import ged
    >>> [o.similar for o in ged.verify([(([0], []), ([1], []))], tau=2.0,
    ...                                backend="torch", device="cpu")]
    [True]
    """
    return GedEngine(backend, **options).verify(pairs, tau)
