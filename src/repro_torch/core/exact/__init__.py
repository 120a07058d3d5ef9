"""Numpy graph representation and matching order (copies of the
reference's ``core/exact/graph.py`` and ``core/exact/order.py``)."""

from repro_torch.core.exact.graph import BOTTOM, Graph, editorial_cost, pad_pair
from repro_torch.core.exact.order import matching_order

__all__ = ["Graph", "BOTTOM", "pad_pair", "editorial_cost", "matching_order"]
