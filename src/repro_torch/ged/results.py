"""The result schema every ``repro_torch.ged`` entry point returns.

The same :class:`GedOutcome` as ``repro/ged/results.py``: whatever the
backend, a query for one pair comes back as one outcome.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class GedOutcome:
    """Answer for one (q, g) pair.

    * Computation mode fills ``ged`` and leaves ``similar`` ``None``;
      verification mode fills ``similar`` (and ``tau``) and leaves ``ged``
      ``None``.
    * ``certified`` — the answer carries the engine's pool-floor
      exactness certificate.
    * ``lower_bound <= delta(q, g) <= upper_bound`` always holds; for a
      certified computation both equal ``ged``.  For a certified
      verification *rejection* the true distance exceeds ``tau`` and
      ``lower_bound`` records the engine's proven floor.
    * ``mapping`` — image of padded-q vertex ``i`` in g (``-1`` = unset);
      ``None`` when the backend produced no full mapping.
    * ``backend`` — which registry entry produced the answer.
    * ``stats`` — backend-specific diagnostics (engine iterations,
      expanded states, ...), and ``timed_out`` / ``degraded`` under a
      deadline or a fault (:attr:`timed_out`, :attr:`degraded`).

    >>> o = GedOutcome(ged=2.0, similar=None, certified=True,
    ...                lower_bound=2.0, upper_bound=2.0, mapping=None,
    ...                backend="cuda", wall_s=0.01, stats={"rung": 0})
    >>> o.certified, o.rung
    (True, 0)
    """

    ged: Optional[float]
    similar: Optional[bool]
    certified: bool
    lower_bound: float
    upper_bound: float
    mapping: Optional[np.ndarray]
    backend: str
    wall_s: float
    tau: Optional[float] = None
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def rung(self) -> int:
        """Escalation rung that answered (0 for the engine backends)."""
        return int(self.stats.get("rung", 0))

    @property
    def timed_out(self) -> bool:
        """The deadline expired before this pair was certified.

        The bounds are still admissible (best-so-far anytime contract,
        :mod:`repro_torch.ged.faults`); ``certified`` is always ``False``
        when this is set.
        """
        return bool(self.stats.get("timed_out", False))

    @property
    def degraded(self) -> bool:
        """A fault forced this pair down the degradation ladder.

        The answer itself is unaffected: the port's ladder goes from the
        engine to the host solver, which is exact, and from a failed host
        solve to the admissible floor, uncertified.  The flag marks that
        the preferred execution path failed.
        """
        return bool(self.stats.get("degraded", False))


def engine_mapping(order_row: np.ndarray, img_row: np.ndarray,
                   n: int) -> Optional[np.ndarray]:
    """Convert the engine's by-order-position image to a by-vertex mapping.

    ``img_row[pos]`` is the g-slot assigned to q vertex ``order_row[pos]``.
    Returns the first ``n`` entries (the padded pair size) or ``None`` when
    the engine produced no full mapping.

    >>> import numpy as np
    >>> engine_mapping(np.array([1, 0, 2]), np.array([2, 0, -1]), 3)
    array([ 0,  2, -1])
    >>> engine_mapping(np.array([0, 1]), np.array([-1, -1]), 2) is None
    True
    """
    if n <= 0 or np.all(img_row[:n] < 0):
        return None if n > 0 else np.zeros(0, dtype=np.int64)
    out = np.full(order_row.shape[0], -1, dtype=np.int64)
    for pos in range(n):
        if img_row[pos] >= 0:
            out[int(order_row[pos])] = int(img_row[pos])
    return out[:n]
