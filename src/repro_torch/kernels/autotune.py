"""Per-bucket kernel dispatch.

The reference (``repro/kernels/autotune.py``) resolves
``use_kernel="auto"`` through a measured tuning table; the port carries
only the concrete plan for ``use_kernel`` True or False, which is all the
engine consults.  The tuning table and ``"auto"`` are still to port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelDispatch:
    """A concrete per-bucket kernel plan: which bound families run fused.

    ``merge_fused`` stays False: the merge-ranks kernel is not ported yet.
    """

    lsa_fused: bool = False
    bma_fused: bool = False
    merge_fused: bool = False


def concrete_dispatch(cfg, n: int) -> KernelDispatch:
    """The plan the search loop follows — pure in ``cfg`` (``n`` is the
    bucket's slot count, kept for the reference's signature).

    >>> from repro_torch.core.engine.search import EngineConfig
    >>> concrete_dispatch(EngineConfig(use_kernel=True), 32)
    KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=False)
    """
    d = getattr(cfg, "dispatch", None)
    if d is not None:
        return d
    on = bool(cfg.use_kernel)
    return KernelDispatch(lsa_fused=on, bma_fused=on)
