"""Which devices carry a pair batch: the port's placement of GED pairs.

The reference shards pair batches over the ``"pairs"`` logical axis of a
named JAX mesh (``parallel/sharding.py::pairs_axes`` with
``default_rules(mesh).mesh_size``).  The port takes two forms of mesh:

* a *flat* sequence of torch devices (strings or :class:`torch.device`):
  every entry carries one contiguous shard of each batch, and the shard
  count is its length;
* a :class:`DeviceMesh`, a named grid of devices such as the reference's
  ``(4, 2)`` ``("data", "model")`` mesh.  Pairs are sharded over its
  pairs axes (:func:`pairs_axes`, or the ``axes`` a caller names) and
  replicated over the rest.  Replicas compute the same rows, so shard
  ``i`` runs on the first device of its replica group only.

A bare nested list has no axis names and raises.

Repeated entries are allowed (``["cpu"] * 4``, ``["cuda:0"] * 2``): the
batch is still split into that many shards, which then run one after
another on the shared device.  On a machine with one device that holds
the split to the single-device outcomes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class DeviceMesh:
    """A named grid of torch devices, the port's ``jax.sharding.Mesh``.

    ``devices`` is a nested sequence of devices (strings or
    :class:`torch.device`) with one nesting level per name in
    ``axis_names``.  ``shape`` maps each axis name to its size, as the
    reference mesh's does.

    >>> mesh = DeviceMesh([["cpu"] * 2] * 4, ("data", "model"))
    >>> dict(mesh.shape), mesh.axis_names
    ({'data': 4, 'model': 2}, ('data', 'model'))
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        names = tuple(axis_names)
        if len(set(names)) != len(names) or not all(
                isinstance(n, str) for n in names):
            raise ValueError(f"axis names must be distinct strings, got "
                             f"{names!r}")
        sizes, flat = _grid(devices)
        if len(sizes) != len(names):
            raise ValueError(f"a {len(sizes)}-D device grid needs "
                             f"{len(sizes)} axis names, got {names!r}")
        if not flat:
            raise ValueError("mesh is empty")
        grid = np.empty(len(flat), dtype=object)
        grid[:] = [torch.device(d) for d in flat]
        self.devices = grid.reshape(sizes)
        self.axis_names = names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"DeviceMesh({dict(self.shape)!r})"


def _grid(devices) -> Tuple[Tuple[int, ...], list]:
    """Sizes and row-major entries of a nested device sequence."""
    if isinstance(devices, (str, torch.device)):
        return (), [devices]
    parts = [_grid(d) for d in devices]
    if not parts:
        return (0,), []
    if any(p[0] != parts[0][0] for p in parts):
        raise ValueError("the device grid is ragged")
    return (len(parts),) + parts[0][0], [d for p in parts for d in p[1]]


def pairs_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh axes that carry GED pairs, by the reference's rule: those
    of ``("pod", "data")`` the mesh has, else its first axis.

    >>> pairs_axes(DeviceMesh([["cpu"] * 2] * 2, ("x", "model")))
    ('x',)
    """
    found = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return found or (mesh.axis_names[0],)


def mesh_shard_devices(mesh: DeviceMesh,
                       axes: Optional[Sequence[str]] = None
                       ) -> Tuple[torch.device, ...]:
    """One device per pair shard of a named mesh: shards run over
    ``axes`` (default :func:`pairs_axes`) in row-major order, each on the
    first device of its replica group along the other axes.

    >>> mesh = DeviceMesh([["cpu", "cpu:0"]] * 2, ("data", "model"))
    >>> mesh_shard_devices(mesh, ("model",))
    (device(type='cpu'), device(type='cpu', index=0))
    """
    axes = pairs_axes(mesh) if axes is None else tuple(axes)
    unknown = [a for a in axes if a not in mesh.axis_names]
    if unknown or len(set(axes)) != len(axes) or not axes:
        raise ValueError(f"axes {axes!r} must be distinct names of the "
                         f"mesh's axes {mesh.axis_names!r}")
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    grid = mesh.devices.transpose(order + rest)
    shards = int(np.prod([mesh.devices.shape[i] for i in order]))
    return tuple(grid.reshape(shards, -1)[:, 0])


Mesh = Union[None, DeviceMesh, Sequence[Union[str, torch.device]]]


def _pinned(dev: torch.device) -> torch.device:
    """A CUDA device with its index filled in (the current device when
    none was given), so equal cards compare equal."""
    if dev.type != "cuda":
        return dev
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"mesh names cuda:{index}, but only "
                         f"{torch.cuda.device_count()} CUDA devices are "
                         "visible")
    return torch.device("cuda", index)


def pair_devices(mesh: Mesh = None, device: DeviceLike = None,
                 axes: Optional[Sequence[str]] = None
                 ) -> Tuple[torch.device, ...]:
    """The devices that carry a pair batch's shards, in shard order.

    ``mesh=None`` means every visible CUDA device (and raises like
    :func:`repro_torch.device.resolve_device` when there is none), unless
    ``device`` names a CPU or one indexed card, which is then the one
    shard.  A :class:`DeviceMesh` gives one shard per index along
    ``axes`` (:func:`mesh_shard_devices`); ``axes`` names axes of a
    ``DeviceMesh`` only.  Each entry goes through ``resolve_device`` (so
    TF32 stays off).  A mixed CPU/CUDA mesh, a bare nested one (no axis
    names), an empty one, or a ``device`` that disagrees with the mesh
    raises ``ValueError``.

    >>> pair_devices(["cpu"] * 4)
    (device(type='cpu'), device(type='cpu'), device(type='cpu'), device(type='cpu'))
    >>> pair_devices(None, device="cpu")
    (device(type='cpu'),)
    >>> pair_devices([["cpu", "cpu"], ["cpu", "cpu"]])
    Traceback (most recent call last):
    ...
    ValueError: a mesh is a flat sequence of devices or a DeviceMesh(devices, axis_names); entry 0 is ['cpu', 'cpu'], a nested list without axis names
    """
    if isinstance(mesh, DeviceMesh):
        mesh = mesh_shard_devices(mesh, axes)
    elif axes is not None:
        raise ValueError("axes= names axes of a DeviceMesh; a flat mesh "
                         "has none")
    if mesh is None:
        dev = resolve_device(device)
        if dev.type == "cpu" or dev.index is not None:
            return (_pinned(dev),)
        return tuple(resolve_device(f"cuda:{i}")
                     for i in range(torch.cuda.device_count()))
    if isinstance(mesh, (str, torch.device)):
        raise ValueError(f"mesh must be a sequence of devices, got {mesh!r}; "
                         "pass [device] for one shard")
    entries = list(mesh)
    if not entries:
        raise ValueError("mesh is empty")
    for i, e in enumerate(entries):
        if not isinstance(e, (str, torch.device)):
            raise ValueError(
                "a mesh is a flat sequence of devices or a DeviceMesh("
                f"devices, axis_names); entry {i} is {e!r}, a nested list "
                "without axis names")
    parsed = [torch.device(e) for e in entries]
    kinds = sorted({d.type for d in parsed})
    if len(kinds) > 1:
        raise ValueError(f"mesh mixes device types {kinds}")
    if device is not None:
        want = torch.device(device)
        if any(d.type != want.type
               or (want.index is not None and d.index != want.index)
               for d in parsed):
            raise ValueError(f"device={str(want)!r} disagrees with mesh "
                             f"{[str(d) for d in parsed]}")
    return tuple(_pinned(resolve_device(d)) for d in parsed)
