"""The result schemas every ``repro_torch.ged`` entry point returns.

The same :class:`GedOutcome` and :class:`SearchHit` as
``repro/ged/results.py``: whatever the backend, a query for one pair
comes back as one outcome, and a corpus query
(:class:`repro_torch.ged.GraphStore`) wraps each answered candidate in a
hit carrying its corpus id and the pipeline stage that decided it.
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


# Pipeline stages a :class:`SearchHit` / store statistic can refer to (the
# reference's values).
STAGE_INDEX = -1     # sublinear candidate index (banded WL-sketch LSH +
                     # pivot triangle bounds); like stage 0, it only rejects
STAGE_FILTER = 0     # vectorized corpus scan (label/degree/size bounds)
STAGE_BOUND = 1      # batched anchor-aware engine bounds, tiny budget
STAGE_VERIFY = 2     # full certified verification / computation


@dataclasses.dataclass
class SearchHit:
    """One corpus graph answered by a :class:`repro_torch.ged.GraphStore`
    query.

    * ``graph_id`` — index into the store's ingested corpus (duplicate
      corpus entries each get their own hit, sharing one computed
      outcome).
    * ``outcome`` — the full :class:`GedOutcome` that decided this
      candidate (certified for range search and top-k).
    * ``stage`` — which pipeline stage decided it: ``STAGE_BOUND`` (1)
      when the cheap anchor-aware engine pass already certified the
      answer, ``STAGE_VERIFY`` (2) when full verification ran.  Pruned
      candidates never become hits, so hits report stage 1 or 2.
    * ``query_id`` — position of the query in a ``search_batch`` call
      (``None`` for single-query entry points).

    >>> o = GedOutcome(ged=1.0, similar=None, certified=True,
    ...                lower_bound=1.0, upper_bound=1.0, mapping=None,
    ...                backend="auto", wall_s=0.0)
    >>> h = SearchHit(graph_id=7, outcome=o, stage=STAGE_VERIFY)
    >>> h.graph_id, h.ged, h.certified, h.stage
    (7, 1.0, True, 2)
    """

    graph_id: int
    outcome: GedOutcome
    stage: int
    query_id: Optional[int] = None

    @property
    def ged(self) -> Optional[float]:
        return self.outcome.ged

    @property
    def similar(self) -> Optional[bool]:
        return self.outcome.similar

    @property
    def certified(self) -> bool:
        return self.outcome.certified

    @property
    def lower_bound(self) -> float:
        return self.outcome.lower_bound

    @property
    def upper_bound(self) -> float:
        return self.outcome.upper_bound


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
