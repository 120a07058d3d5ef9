"""Labeled-graph generators and the synthetic token pipeline (copies of
the reference's ``data/graphs.py`` and ``data/tokens.py``)."""

from repro_torch.data.graphs import (aids_like_graph, graph_pair_groups,
                                     perturb, random_graph)
from repro_torch.data.tokens import TokenPipeline, synthetic_token_batches

__all__ = ["random_graph", "perturb", "graph_pair_groups", "aids_like_graph",
           "synthetic_token_batches", "TokenPipeline"]
