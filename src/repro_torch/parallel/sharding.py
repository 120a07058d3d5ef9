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
  ``i`` runs on the first device of its replica group only;
* a ``torch.distributed`` ``DeviceMesh`` (:func:`is_distributed_mesh`),
  one process per device: each rank runs the shard its coordinate over
  the pairs axes names (:func:`rank_shard`) on its own device, and
  replicas compute the same rows.

A bare nested list has no axis names and raises.

Repeated entries are allowed (``["cpu"] * 4``, ``["cuda:0"] * 2``): the
batch is still split into that many shards, which then run one after
another on the shared device.  On a machine with one device that holds
the split to the single-device outcomes.

The second half of the module is the reference's logical-axis rules
(``ShardingRules`` ... ``named_sharding``).  Model code names tensor dims
by *logical* axes ("batch", "embed", "heads", "ff", "vocab", "expert",
"kv_seq", ...); a rules table maps them to mesh axes, and a dim that its
mapped axes do not divide is replicated.  A spec is a tuple with one entry
per dim (``None``, a mesh axis name, or a tuple of names), the reference's
``PartitionSpec``.  The rules read only axis names and sizes, so they take
the port's :class:`DeviceMesh` and a ``torch.distributed`` ``DeviceMesh``
alike; :func:`spec_to_placements` and :func:`constrain` turn specs into
``torch.distributed.tensor`` placements on the latter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

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
    of ``("pod", "data")`` the mesh has, else its first axis.  Takes a
    ``torch.distributed`` ``DeviceMesh`` too (:func:`is_distributed_mesh`).

    >>> pairs_axes(DeviceMesh([["cpu"] * 2] * 2, ("x", "model")))
    ('x',)
    """
    names = _axis_names(mesh)
    found = tuple(a for a in ("pod", "data") if a in names)
    return found or (names[0],)


def _axis_names(mesh) -> Tuple[str, ...]:
    if not is_distributed_mesh(mesh):
        return mesh.axis_names
    if mesh.mesh_dim_names is None:
        raise ValueError("a torch.distributed mesh that carries pairs needs "
                         "mesh_dim_names")
    return tuple(mesh.mesh_dim_names)


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


# ----------------------------------------------- torch.distributed meshes

def is_distributed_mesh(mesh) -> bool:
    """Is ``mesh`` a ``torch.distributed`` ``DeviceMesh`` (one process per
    device, as ``repro_torch.launch.mesh`` builds them) rather than a flat
    device list or the port's own :class:`DeviceMesh`?  Read from the
    object (``mesh_dim_names`` and ``get_coordinate``), so that importing
    this module creates no process-group state.

    >>> is_distributed_mesh(DeviceMesh([["cpu"] * 2] * 2, ("data", "model")))
    False
    >>> is_distributed_mesh(["cpu"] * 2), is_distributed_mesh(None)
    (False, False)
    """
    return (not isinstance(mesh, DeviceMesh)
            and hasattr(mesh, "mesh_dim_names")
            and hasattr(mesh, "get_coordinate"))


@dataclasses.dataclass(frozen=True)
class RankShard:
    """This process's share of a pair batch split over a ``torch.distributed``
    mesh: shard ``index`` of ``count`` (the product of the pairs axes'
    sizes), run on ``device``; ``ranks`` are the mesh's global ranks."""

    axes: Tuple[str, ...]
    index: int
    count: int
    device: torch.device
    ranks: Tuple[int, ...]


def rank_shard(mesh, axes: Optional[Sequence[str]] = None,
               device: DeviceLike = None) -> RankShard:
    """This rank's pair shard on a ``torch.distributed`` ``DeviceMesh``.

    Pairs run over ``axes`` (default :func:`pairs_axes`: ``pod`` x
    ``data``, else the first axis) and are replicated over the rest, as
    under the reference's ``shard_map``: the shard index is the rank's
    coordinate over ``axes``, row-major in their order.  The local device
    is ``cuda:{torch.cuda.current_device()}`` on a ``"cuda"`` mesh (a
    launch sets it from the local rank) and the CPU otherwise; a
    ``device`` that disagrees with it raises ``ValueError``, as does a
    rank outside the mesh.
    """
    names = _axis_names(mesh)
    axes = pairs_axes(mesh) if axes is None else tuple(axes)
    unknown = [a for a in axes if a not in names]
    if unknown or len(set(axes)) != len(axes) or not axes:
        raise ValueError(f"axes {axes!r} must be distinct names of the "
                         f"mesh's axes {names!r}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not a member of the mesh")
    sizes = dict(zip(names, tuple(mesh.shape)))
    index = int(np.ravel_multi_index(
        tuple(coord[names.index(a)] for a in axes),
        tuple(sizes[a] for a in axes)))
    count = int(np.prod([sizes[a] for a in axes]))
    local = (torch.device("cuda", torch.cuda.current_device())
             if mesh.device_type == "cuda" else torch.device("cpu"))
    if device is not None:
        want = torch.device(device)
        if want.type != local.type or (want.index is not None
                                       and want.index != local.index):
            raise ValueError(f"device={str(want)!r} disagrees with the "
                             f"mesh's local device {str(local)!r}")
    ranks = tuple(int(r) for r in mesh.mesh.reshape(-1).tolist())
    return RankShard(axes, index, count, resolve_device(local), ranks)


# ------------------------------------------------------------ logical rules

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a port :class:`DeviceMesh` or of a
    ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` and a shape
    tuple).

    >>> mesh_axis_sizes(DeviceMesh([["cpu"] * 2] * 4, ("data", "model")))
    {'data': 4, 'model': 2}
    """
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any
    table: Dict[str, AxisVal]

    def mesh_size(self, axis: AxisVal) -> int:
        if axis is None:
            return 1
        if isinstance(axis, str):
            axis = (axis,)
        sizes = mesh_axis_sizes(self.mesh)
        size = 1
        for a in axis:
            size *= sizes[a]
        return size


def default_rules(mesh, fsdp: bool = True) -> ShardingRules:
    """The reference's table: batch over (``pod``, ``data``), FSDP over
    ``data`` on the embed axis, TP / EP / KV-sequence over ``model``."""
    names = tuple(mesh_axis_sizes(mesh))
    batch_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data")
                                        if a in names)
    table: Dict[str, AxisVal] = {
        "batch": batch_axes or None,
        "pairs": batch_axes or None,      # GED verification pairs
        "seq": None,
        "act_seq": "model",               # sequence-parallel activations
        "kv_seq": "model",                # decode KV cache sequence sharding
        "embed": ("data" if (fsdp and "data" in names) else None),
        "heads": "model",
        "qkv_flat": "model",              # flattened (H*hd) projections
        "ff": "model",
        "vocab": "model",
        "expert": "model",
        "conv": None,
        "state": None,
        "stage": ("pod" if "pod" in names else None),
    }
    return ShardingRules(mesh, table)


_RULES: Optional[ShardingRules] = None


def set_rules(rules: Optional[ShardingRules]) -> None:
    """Install (or, with ``None``, remove) the rules :func:`constrain`
    and :func:`logical_spec` read: a module global, one launch at a
    time."""
    global _RULES
    _RULES = rules


def get_rules() -> Optional[ShardingRules]:
    return _RULES


def logical_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 rules: Optional[ShardingRules] = None) -> Spec:
    """The spec of a tensor of ``shape`` with logical ``axes`` (``None``
    = replicated): ``()`` without rules, and a dim that its mapped mesh
    axes do not divide is replicated.

    >>> r = default_rules(DeviceMesh([["cpu"] * 2] * 4, ("data", "model")))
    >>> logical_spec((8, 6, 3), ("batch", "heads", "ff"), r)
    ('data', 'model', None)
    """
    rules = rules or _RULES
    if rules is None:
        return ()
    spec = []
    for dim, name in zip(shape, axes):
        mapped = None if name is None else rules.table.get(name)
        if mapped is None or dim % rules.mesh_size(mapped) != 0:
            spec.append(None)
        else:
            spec.append(mapped)
    return canonical_spec(spec)


def canonical_spec(spec: Sequence[AxisVal]) -> Spec:
    """``spec`` in ``PartitionSpec``'s own form: a one-name tuple entry is
    the name, an empty one ``None``.

    >>> canonical_spec([("data",), ("pod", "data"), (), None])
    ('data', ('pod', 'data'), None, None)
    """
    out = []
    for entry in spec:
        if isinstance(entry, (tuple, list)):
            entry = (None if not entry else entry[0] if len(entry) == 1
                     else tuple(entry))
        out.append(entry)
    return tuple(out)


def spec_to_placements(spec: Spec, mesh, shape: Optional[Sequence[int]]
                       = None) -> Tuple[Any, ...]:
    """``torch.distributed.tensor`` placements, one per mesh dim, that lay
    a tensor out as JAX's ``NamedSharding(mesh, P(*spec))`` does.

    A dim mapped to a tuple of axes (``("pod", "data")``) is split
    major-to-minor in the tuple's order; DTensor splits repeated
    ``Shard(d)`` entries in mesh-dim order, so the tuple must follow the
    mesh's axis order (the reference's tables always do).  A mesh axis no
    dim names is ``Replicate()``.  With ``shape``, a dim its axes do not
    divide raises: the port never emits an uneven ``Shard``.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    sizes = mesh_axis_sizes(mesh)
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)!r}")
        if shape is not None and shape[d] % int(np.prod(
                [sizes[a] for a in axes])) != 0:
            raise ValueError(f"dim {d} of size {shape[d]} does not divide "
                             f"over {axes!r} ({sizes})")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the port's ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: Spec

    def placements(self, shape: Optional[Sequence[int]] = None):
        return spec_to_placements(self.spec, self.mesh, shape)


def named_sharding(rules: ShardingRules, shape: Sequence[int],
                   axes: Sequence[Optional[str]]) -> NamedSharding:
    return NamedSharding(rules.mesh, logical_spec(shape, axes, rules))


def is_distributed(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``."""
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements``; the gradient is redistributed to the
    same placements, as JAX transposes a sharding constraint into the
    same constraint on the cotangent."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return _to(x, placements)

    @staticmethod
    def backward(ctx, g):
        return _to(g, ctx.placements), None


def _to(x, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x, *axes: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical axis names.

    The identity without rules or on a plain tensor; a DTensor is
    redistributed to the spec's placements on its own mesh (an all-gather,
    all-reduce, reduce-scatter or local split, as the change needs), and
    so is its gradient.
    """
    rules = _RULES
    if rules is None or not is_distributed(x):
        return x
    spec = logical_spec(x.shape, axes, rules)
    placements = spec_to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements and not x.requires_grad:
        return x
    return _Constrain.apply(x, placements)


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements when both are DTensors
    and differ (a gradient reduce-scattered onto its parameter's shards);
    otherwise ``x`` itself."""
    if not (is_distributed(x) and is_distributed(ref)) \
            or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def reduce_partial(x):
    """A DTensor with pending sums (``Partial`` placements, such as the
    output of a row-parallel matmul) all-reduced to ``Replicate`` on those
    mesh dims; its shards kept.  Plain tensors pass through.  The port
    calls it where the residual stream enters a norm, so DTensor never
    chooses to reduce-scatter the stream onto the sequence dim (whose
    later ``(B*S, d)`` folds have no cheap sharding rule)."""
    if not is_distributed(x) or not any(pl.is_partial()
                                        for pl in x.placements):
        return x
    return _ReducePartial.apply(x)


class _ReducePartial(torch.autograd.Function):
    """Partial -> Replicate; the gradient passes in the layout it comes
    (the logical value is unchanged, so is its gradient).  DTensor's own
    backward would hand back a ``Partial`` of the forward's reduce kind,
    which it cannot then add to gradients of another kind."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        return x.redistribute(x.device_mesh, [
            Replicate() if pl.is_partial() else pl for pl in x.placements])

    @staticmethod
    def backward(ctx, g):
        return g


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) of per-device partial values over mesh dims, inside
    a ``local_map`` region.  The sum is replicated, so the gradient of each
    device's contribution is the sum's gradient as it is."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        import torch.distributed._functional_collectives as funcol

        for d in dims:
            x = funcol.all_reduce(x, "sum", (mesh, d))
        return funcol.wait_tensor(x) if dims else x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """Sum a local tensor's per-device values over mesh ``dims`` (inside
    ``local_map``); differentiable, with the gradient passed through."""
    return _SumOver.apply(x, mesh, tuple(dims))
