"""Hand-written Hopper kernels of the engine's hot path (``csrc/*.cu``),
their build (``_build.py``), wrappers with launch counters (``ops.py``)
and the plain PyTorch twins the wrappers use for CPU tensors (``ref.py``)."""
