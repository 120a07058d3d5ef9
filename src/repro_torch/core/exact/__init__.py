"""The paper-faithful host solver (Chang et al., 2017), plain numpy.

Copies of the reference's ``repro/core/exact`` modules, with imports
rewritten to this package:

  - ``graph``      : labeled undirected graphs, padding simplifications (§2.1)
  - ``multiset``   : multiset edit distance ``Y`` (App. A.2)
  - ``assignment`` : exact Hungarian (Jonker-Volgenant style) + forced variants
  - ``bounds``     : LS / LSa / BM / BMa / BMaN / SM / SMa child scoring (§4, A.3)
  - ``order``      : frequency-aware connected matching order (App. A.1)
  - ``search``     : unified framework (Alg. 2) -> AStar+ / DFS+ (§3, §5)
  - ``brute``      : brute-force oracle for tests

The ``"exact"`` backend and the final rung of ``"auto"`` run it.
"""

from repro_torch.core.exact.graph import BOTTOM, Graph, editorial_cost, pad_pair
from repro_torch.core.exact.multiset import multiset_edit_distance
from repro_torch.core.exact.assignment import hungarian, solve_forced_all
from repro_torch.core.exact.order import matching_order
from repro_torch.core.exact.search import BOUNDS, SearchResult, ged, ged_verify

__all__ = [
    "Graph",
    "BOTTOM",
    "pad_pair",
    "editorial_cost",
    "multiset_edit_distance",
    "hungarian",
    "solve_forced_all",
    "matching_order",
    "ged",
    "ged_verify",
    "SearchResult",
    "BOUNDS",
]
