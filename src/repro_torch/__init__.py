"""``repro_torch`` — the PyTorch/CUDA port of the batched GED engine.

A second package beside the JAX reference (``repro``): the same packing,
bound algebra, auction, sorted-pool search, escalating ``"auto"`` backend
with the host solver and measured kernel dispatch, and ``GedEngine`` facade,
written as plain PyTorch over explicit leading batch axes, with the hot
bound kernels hand-written in CUDA C++ for Hopper (``kernels/csrc``).

It imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``; the numpy modules it needs (the host solver ``core.exact``,
``data.graphs``, ``runtime.scheduler``, ``store_io.atomic``) are kept here
as copies.

Entry points take ``device=`` and default to the card; without a visible
GPU they raise and ask for ``device="cpu"`` instead of quietly running on
the CPU.  ``serving`` holds the GED services and LM decoding
(``generate``), ``launch`` their entry points (``python -m
repro_torch.launch.serve --mode ged|lm``, ``python -m
repro_torch.launch.train``); ``configs`` and ``models`` the LM
architectures and the stacks they run on; ``optim``, ``checkpoint``,
``runtime.loop`` and ``parallel.pipeline`` LM training.
"""

__all__ = ["checkpoint", "configs", "core", "data", "ged", "kernels",
           "launch", "models", "optim", "parallel", "runtime", "serving",
           "store_io"]
