"""Which devices carry a pair batch: the port's placement of GED pairs.

The reference shards pair batches over the ``"pairs"`` logical axis of a
named JAX mesh (``parallel/sharding.py::pairs_axes`` with
``default_rules(mesh).mesh_size``).  A torch device list has no named
axes, so the port's ``mesh`` is a *flat* sequence of torch devices
(strings or :class:`torch.device`); every entry carries one contiguous
shard of each batch, and the shard count is its length.  A 2-D mesh such
as the reference's ``(4, 2)`` ``("data", "model")`` has no counterpart
and raises.

Repeated entries are allowed (``["cpu"] * 4``, ``["cuda:0"] * 2``): the
batch is still split into that many shards, which then run one after
another on the shared device.  On a machine with one device that holds
the split to the single-device outcomes.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

Mesh = Union[None, Sequence[Union[str, torch.device]]]


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


def pair_devices(mesh: Mesh = None, device: DeviceLike = None
                 ) -> Tuple[torch.device, ...]:
    """The devices that carry a pair batch's shards, in shard order.

    ``mesh=None`` means every visible CUDA device (and raises like
    :func:`repro_torch.device.resolve_device` when there is none), unless
    ``device`` names a CPU or one indexed card, which is then the one
    shard.  Each entry goes through ``resolve_device`` (so TF32 stays
    off).  A mixed CPU/CUDA mesh, a nested (2-D) one, an empty one, or a
    ``device`` that disagrees with the mesh raises ``ValueError``.

    >>> pair_devices(["cpu"] * 4)
    (device(type='cpu'), device(type='cpu'), device(type='cpu'), device(type='cpu'))
    >>> pair_devices(None, device="cpu")
    (device(type='cpu'),)
    >>> pair_devices([["cpu", "cpu"], ["cpu", "cpu"]])
    Traceback (most recent call last):
    ...
    ValueError: the port's mesh is a flat sequence of devices (a nested, 2-D mesh has no counterpart); entry 0 is ['cpu', 'cpu']
    """
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
                "the port's mesh is a flat sequence of devices (a nested, "
                f"2-D mesh has no counterpart); entry {i} is {e!r}")
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
