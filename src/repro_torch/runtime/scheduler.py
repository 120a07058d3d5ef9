"""Straggler-aware scheduling for GED workloads.

GED pairs have wildly variable difficulty (the paper's own TLE phenomenon:
one pair can take 10^4x another at the same |V|).  In a lockstep batched
engine the slowest pair in a batch sets the batch's wall time, so naive
batching wastes the whole mesh on a handful of stragglers.

Mitigation, in order:
  1. **cost model** — ``difficulty()`` predicts search effort from |V|,
     edge density, label diversity and the threshold margin;
  2. **LPT packing** — pairs are sorted by predicted difficulty and packed
     longest-processing-time-first into batches with equalised predicted
     work, so batch wall-times are balanced and easy batches use small
     ``max_iters`` budgets;
  3. **escalation** — pairs whose result is not certified exact
     (pool overflow / iteration cap) are re-queued with a bigger pool;
     the final rung is the exact host solver (``repro_torch.core.exact``),
     mirroring the paper's guidance that AStar+-BMa handles the heavy
     tail while trivial pairs should never pay for it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _entropy(labels: Sequence[int]) -> float:
    vals, counts = np.unique(np.asarray(labels), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log(p + 1e-12)).sum())


def difficulty(n_q: int, n_g: int, m_q: int, m_g: int,
               vlabels_q: Sequence[int], vlabels_g: Sequence[int],
               tau: Optional[float] = None) -> float:
    """Predicted search effort for one pair (arbitrary units).

    * branching grows with |V(g)|; depth with |V(q)| -> n_g ** ~sqrt scaling
      captured as n_q * n_g;
    * dense graphs make bounds looser (more edge interactions): x (1 + density);
    * low label diversity makes bounds looser: / (1 + H_v);
    * verification with small tau prunes hard: x sigmoid(tau - |size diff|).
    """
    n_q, n_g = min(n_q, n_g), max(n_q, n_g)
    density = (m_q + m_g) / max(n_q + n_g, 1)
    h = _entropy(list(vlabels_q) + list(vlabels_g))
    base = n_q * n_g * (1.0 + density) / (1.0 + h)
    if tau is not None:
        size_gap = abs(n_g - n_q) + abs(m_g - m_q)
        margin = tau - size_gap          # >0: can't reject cheaply
        base *= 1.0 / (1.0 + math.exp(-0.8 * margin))
    return base


@dataclasses.dataclass
class Batch:
    indices: List[int]
    predicted: float
    rung: int                      # escalation rung (0 = first attempt)


ESCALATION_RUNGS = (
    # (pool, expand, max_iters) per rung; final rung handled by host solver
    (256, 4, 128),
    (1024, 8, 512),
    (4096, 8, 2048),
)


class GedScheduler:
    """Difficulty-sorted LPT packer with escalation re-queue."""

    def __init__(self, batch_size: int, rungs=ESCALATION_RUNGS):
        self.batch_size = batch_size
        self.rungs = rungs

    def pack(self, difficulties: Sequence[float], rung: int = 0
             ) -> List[Batch]:
        """LPT: sort desc, fill the currently-lightest open batch."""
        n = len(difficulties)
        if n == 0:
            return []
        n_batches = max(1, math.ceil(n / self.batch_size))
        order = np.argsort(-np.asarray(difficulties, dtype=np.float64))
        batches = [Batch([], 0.0, rung) for _ in range(n_batches)]
        loads = np.zeros(n_batches)
        sizes = np.zeros(n_batches, dtype=int)
        for idx in order:
            open_mask = sizes < self.batch_size
            cand = np.where(open_mask)[0]
            tgt = cand[np.argmin(loads[cand])]
            batches[tgt].indices.append(int(idx))
            loads[tgt] += difficulties[idx]
            sizes[tgt] += 1
            batches[tgt].predicted = float(loads[tgt])
        return batches

    def engine_params(self, rung: int) -> Optional[Tuple[int, int, int]]:
        """(pool, expand, max_iters) for this rung; None -> host solver."""
        if rung < len(self.rungs):
            return self.rungs[rung]
        return None

    def escalate(self, batch: Batch, uncertified: Sequence[int]) -> Optional[Batch]:
        """Re-queue the pairs (by index into the batch) that failed
        certification; None when the next rung is the host solver."""
        if not uncertified:
            return None
        nxt = batch.rung + 1
        idxs = [batch.indices[i] for i in uncertified]
        if nxt >= len(self.rungs):
            return Batch(idxs, 0.0, nxt)      # caller routes to host solver
        return Batch(idxs, 0.0, nxt)
