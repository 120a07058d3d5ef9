"""Batched GED engine in PyTorch.

* ``tensor_graphs`` — padded dense pair representation, host packing and
  the move onto a device
* ``bounds``        — anchor-aware LSa / BMa child bounds, batched over
  leading state axes
* ``auction``       — fixed-sweep auction with LP-dual forced bounds
* ``search``        — the sorted-pool best-first search over a
  ``(pairs, P, ...)`` pool: eager chunks on the CPU, CUDA graph replays
  on the card
* ``api``           — ``dispatch_packed``, the raw compute step under the
  ``repro_torch.ged`` facade, and ``start_packed``, its asynchronous form
  on the card (the device's worker thread and stream)
"""

from repro_torch.core.engine.search import EngineConfig
from repro_torch.core.engine.tensor_graphs import GraphPairTensors, pack_pairs

__all__ = ["GraphPairTensors", "pack_pairs", "EngineConfig"]
