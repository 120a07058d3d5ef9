"""Labeled-graph generators (a copy of the reference's ``data/graphs.py``)."""

from repro_torch.data.graphs import (aids_like_graph, graph_pair_groups,
                                     perturb, random_graph)

__all__ = ["random_graph", "perturb", "graph_pair_groups", "aids_like_graph"]
