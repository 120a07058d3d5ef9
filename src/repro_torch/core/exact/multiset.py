"""Multiset edit distance (paper App. A.2).

``Y(S1, S2) = max(|S1|, |S2|) - |S1 /\\ S2|`` where ``/\\`` is multiset
intersection.  Metric; computable in ``O(|S1| + |S2|)`` with hashing.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable

import numpy as np


def multiset_edit_distance(s1: Iterable, s2: Iterable) -> int:
    """``Y(S1, S2)`` for arbitrary hashable elements."""
    c1, c2 = Counter(s1), Counter(s2)
    inter = sum(min(c1[k], c2[k]) for k in c1.keys() & c2.keys())
    return max(sum(c1.values()), sum(c2.values())) - inter


def hist_edit_distance(h1: np.ndarray, h2: np.ndarray) -> int:
    """``Y`` over dense label histograms (same binning)."""
    n1 = int(h1.sum())
    n2 = int(h2.sum())
    inter = int(np.minimum(h1, h2).sum())
    return max(n1, n2) - inter


def counter_intersection_size(c1: Counter, c2: Counter) -> int:
    return sum(min(c1[k], c2[k]) for k in c1.keys() & c2.keys())
