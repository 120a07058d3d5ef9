"""Production mesh construction over ``torch.distributed``.

The reference's ``repro/launch/mesh.py``.  These are FUNCTIONS, so
importing the module touches no distributed state.  Each returns a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is already initialised: a real launch gets it from ``torchrun`` (NCCL, one
rank per card), the dry run (``launch/dryrun.py``) from an in-process
``"fake"`` group of the mesh's world size.

Topology (the reference's, kept as it is):
  single pod : (16, 16)    axes ("data", "model")          = 256 devices
  multi pod  : (2, 16, 16) axes ("pod", "data", "model")   = 512 devices

``model`` carries TP / EP / KV-sequence sharding, ``data`` FSDP and batch,
``pod`` composes with ``data`` for batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _make_mesh(shape: Sequence[int], axes: Sequence[str],
               device_type: Optional[str] = None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs an initialised "
                           f"process group of world size {need}")
    if dist.get_world_size() != need:
        raise ValueError(f"a {tuple(shape)} {tuple(axes)} mesh needs world "
                         f"size {need}, the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   device_type: Optional[str] = None):
    """Small mesh for unit tests on a fake or ``gloo`` group."""
    return _make_mesh(shape, axes, device_type)


def chips(mesh) -> int:
    return int(mesh.size())
