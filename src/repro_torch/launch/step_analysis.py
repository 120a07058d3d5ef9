"""Per-device cost counts of one step: the stand-in for ``hlo_analysis``.

The reference compiles each cell and reads per-device costs out of the
post-SPMD HLO text (``repro/launch/hlo_analysis.py``).  Torch emits no
HLO, so ``parse_module`` has no counterpart here.  Instead
:func:`analyze_step` runs the step once under :class:`StepCounter`, a
``TorchDispatchMode`` that sees the *local* aten ops of every DTensor (it
returns ``NotImplemented`` for DTensor ops, so DTensor first lowers each
one to the ops on this device's shards and to its collectives, which the
mode then sees) and counts them with the reference's rules
(``hlo_analysis.py:395-420``):

* FLOPs: a matmul counts 2·prod(out)·prod(contracting dims); a
  convolution 2·prod(out)·prod(window)·(Cin/groups); an elementwise op its
  output elements; a reduce, sort, scan or scatter its operand bytes / 4.
* bytes: operands plus outputs of every op that moves data, i.e. the
  eager port's real traffic with no fusion (view and other metadata-only
  ops move nothing and are skipped).  It is an upper bound next to the
  reference's fusion-boundary bytes.
* collective bytes: the operand bytes of every ``_c10d_functional`` /
  ``c10d_functional`` collective; one whose group is the ``pod`` mesh
  dim's counts as DCN (``dcn_bytes``).
* ``f32_staging_bytes`` is 0: it corrects a CPU-backend artefact of XLA
  (f32 copies of bf16 dot operands) that the port does not have.
* loops: the port's layer and accumulation loops are Python loops that
  run L times, so every trip is seen; there is no trip count to recover.

Shape-inference calls DTensor makes on ``FakeTensor``s are not counted.
Kernels launched through ``ctypes`` (the GED engine's ``reduced_top2``)
are not aten ops and are not seen.  The mode also keeps the peak of the
bytes live in tensors the step allocated (``peak_live_bytes``), as a
function of the op trace alone, as the reference's buffer liveness is:
each non-aliasing op output is an allocation, live from the op that
makes it to its last use as an op's input (through any view of it);
an allocation still reachable when the counter closes, after a
``gc.collect()``, lives to the end.  When Python frees a tensor plays no
part, so the peak is the same every run.
"""

from __future__ import annotations

import gc
import math
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv", "addmv",
           "matmul", "_scaled_mm", "linear"}
_CONV = {"convolution", "_convolution", "conv1d", "conv2d", "conv3d"}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "any", "all", "norm", "linalg_vector_norm", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "var", "std", "var_mean", "std_mean", "cumsum", "cumprod", "cummax",
    "cummin", "sort", "topk", "argsort", "searchsorted", "scatter",
    "scatter_add", "scatter_reduce", "index_add", "index_put",
    "_index_put_impl", "index_reduce", "embedding_dense_backward",
    "nll_loss_forward", "nll_loss_backward", "unique", "_unique2",
    "bincount", "histc", "kthvalue", "median", "mode", "count_nonzero",
}
_COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (tensors, and lists,
    tuples and dicts of them, one or two levels deep)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    items = tree.values() if isinstance(tree, dict) else tree
    if not isinstance(items, (list, tuple, type({}.values()))):
        return out
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: torch.Tensor) -> bool:
    return type(t).__name__ == "FakeTensor"


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by its views (meta tensors
    included, whose data pointers are all 0)."""
    return t.untyped_storage()._cdata


_INFO: Dict[Any, Tuple] = {}


def _info(func) -> Tuple:
    """(namespace, name, per-return aliasing, metadata-only, pointwise) of
    an op, computed once per overload."""
    info = _INFO.get(func)
    if info is None:
        pkt = func._overloadpacket
        ns = pkt._qualified_op_name.split("::")[0]
        name = pkt.__name__.rstrip("_") if ns == "aten" else pkt.__name__
        aliases = tuple(r.alias_info is not None
                        for r in func._schema.returns)
        meta_only = bool(aliases) and all(aliases) and (
            torch.Tag.inplace_view in func.tags or func.is_view)
        info = (ns, name, aliases, meta_only,
                torch.Tag.pointwise in func.tags)
        _INFO[func] = info
    return info


class StepCounter(TorchDispatchMode):
    """Counts the local ops run while it is active (see the module)."""

    def __init__(self, mesh=None, pod_axis: str = "pod"):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collective_bytes = 0.0
        self.dcn_bytes = 0.0
        self.collective_by_op: Dict[str, float] = {}
        self.collective_count = 0.0
        self.ops: Counter = Counter()
        self.warnings: list = []
        # allocations by id: bytes, first and last op index, and weak
        # references to the tensors (views included) that share it
        self._n_ops = 0
        self._alloc: List[List[Any]] = []
        self._by_storage: Dict[int, int] = {}
        self.peak_live = 0
        self._pod_groups = set()
        self._groups = set()
        if mesh is not None and getattr(mesh, "mesh_dim_names", None):
            for i, name in enumerate(mesh.mesh_dim_names):
                gname = mesh.get_group(i).group_name
                self._groups.add(gname)
                if name == pod_axis:
                    self._pod_groups.add(gname)

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented          # let DTensor lower to local ops
        out = func(*args, **kwargs)
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs)
        outs = _tensors(out) if not isinstance(out, torch.Tensor) else [out]
        if any(_is_fake(t) for t in ins) or any(_is_fake(t) for t in outs):
            return out                     # DTensor's shape inference
        self._count(func, args, ins, outs)
        return out

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        gc.collect()
        self.peak_live = self._peak()
        return out

    def _owner(self, t: torch.Tensor):
        """The allocation ``t`` shares storage with, if the step made it
        and one of its tensors is alive (a dead one's storage address may
        have been reused)."""
        a = self._by_storage.get(_storage(t))
        if a is None or not any(r() is not None for r in self._alloc[a][3]):
            return None
        return a

    def _uses(self, ins, outs, fresh) -> None:
        """Op ``self._n_ops`` reads ``ins`` and makes ``outs``;
        ``fresh[j]`` is true where ``outs[j]`` is a new allocation (the
        rest alias an input)."""
        i = self._n_ops
        for t in ins:
            a = self._owner(t)
            if a is not None:
                self._alloc[a][2] = i
        for t, new in zip(outs, fresh):
            if new:
                self._by_storage[_storage(t)] = len(self._alloc)
                self._alloc.append([_nbytes(t), i, i, [weakref.ref(t)]])
            else:
                a = self._owner(t)
                if a is not None:
                    self._alloc[a][3].append(weakref.ref(t))

    def _peak(self) -> int:
        """The largest sum of live allocations over op indices."""
        delta = [0] * (self._n_ops + 1)
        for nb, first, last, refs in self._alloc:
            delta[first] += nb
            if not any(r() is not None for r in refs):
                delta[last + 1] -= nb
        live = peak = 0
        for d in delta[:-1]:
            live += d
            peak = max(peak, live)
        return peak

    def _count(self, func, args, ins, outs) -> None:
        ns, name, aliased, meta_only, pointwise = _info(func)
        self.ops[(ns, name)] += 1
        fresh = [not meta_only and not (aliased[i] if i < len(aliased)
                                        else False)
                 for i in range(len(outs))]
        self._uses(ins, outs, fresh)
        self._n_ops += 1
        if meta_only:
            return                         # views: metadata only

        if ns in ("_c10d_functional", "c10d_functional", "c10d"):
            base = name.rstrip("_")
            if base in _NOT_COLLECTIVES:
                return
            kind = _COLLECTIVE_NAMES.get(base, base)
            b = float(sum(_nbytes(t) for t in ins))
            self.collective_bytes += b
            self.collective_count += 1
            self.collective_by_op[kind] = \
                self.collective_by_op.get(kind, 0.0) + b
            names = [a for a in args if isinstance(a, str)]
            group = names[-1] if names else None   # the group's name
            if group in self._pod_groups:
                self.dcn_bytes += b
            elif ns != "c10d" and self._groups and group not in self._groups:
                self.warnings.append(f"{kind} over group {group!r}: not a "
                                     "mesh dim's group, DCN not attributed")
            self.bytes_accessed += b + sum(_nbytes(t) for t in outs)
            return

        if name in _MATMUL:
            self.flops += _matmul_flops(name, ins, outs)
        elif name in _CONV:
            self.flops += _conv_flops(args, outs)
        elif name in _REDUCE:
            self.flops += sum(_nbytes(t) for t in ins) / 4.0
        elif pointwise:
            self.flops += sum(t.numel() for t in outs)
        self.bytes_accessed += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)

    # ------------------------------------------------------------ result
    def costs(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "dcn_bytes": self.dcn_bytes,
            "collective_by_op": dict(self.collective_by_op),
            "collective_count": self.collective_count,
            "f32_staging_bytes": 0.0,
            "warnings": self.warnings[:20],
            "n_computations": len(self.ops),
            "peak_live_bytes": self.peak_live,
            "bytes_note": "eager op traffic, no fusion (operands + outputs "
                          "of every data-moving op)",
        }


def _matmul_flops(name: str, ins: Sequence[torch.Tensor],
                  outs: Sequence[torch.Tensor]) -> float:
    """2·prod(out)·prod(contracting dims): the contracting dim is the last
    dim of the left operand (``addmm``-style ops take the bias first)."""
    if not outs:
        return 0.0
    lhs = ins[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
        else ins[0]
    k = lhs.shape[-1] if lhs.ndim else 1
    return 2.0 * outs[0].numel() * k


def _conv_flops(args, outs) -> float:
    """2·prod(out)·prod(window)·(Cin/groups): the weight is ``(Cout,
    Cin/groups, *window)``."""
    w = args[1]
    return 2.0 * outs[0].numel() * math.prod(w.shape[1:])


def analyze_step(fn: Callable, args: Sequence[Any], mesh=None,
                 pod_axis: str = "pod", return_output: bool = False):
    """Run ``fn(*args)`` once under :class:`StepCounter` and return its
    per-device costs: the keys of the reference's ``analyze_hlo``
    (``flops``, ``bytes_accessed``, ``collective_bytes``, ``dcn_bytes``,
    ``collective_by_op``, ``collective_count``, ``f32_staging_bytes``,
    ``warnings``, ``n_computations`` = distinct aten ops) plus
    ``peak_live_bytes`` and ``wall_s``.  With ``return_output`` it
    returns ``(costs, fn's output)``."""
    counter = StepCounter(mesh, pod_axis)
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    costs = counter.costs()
    costs["wall_s"] = time.perf_counter() - t0
    return (costs, out) if return_output else costs
