"""Per-device cost of one step, counted from what the step dispatches.

The port's counterpart of ``repro.launch.hlo_cost``, and not a line-for-line
one. JAX compiles a cell and walks the post-SPMD HLO, scaling each while
body by its trip count. PyTorch has no HLO, and an eager step runs every
iteration of its loops, so the trip counts come for free: :class:`OpCounter`
is a ``TorchDispatchMode`` that sees each aten op, each of the port's kernel
ops and each c10d collective as the step runs (under ``FakeTensorMode`` it
runs on shapes alone). Counted per device, i.e. for this rank:

* ``flops``: 2 x result x contraction for every matmul-family aten op
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``; ``matmul`` and ``einsum``
  reach these), as ``torch.utils.flop_counter`` counts them, plus each
  kernel op's operations from :mod:`repro_torch.kernels.cost`; other
  elementwise work is not counted, as JAX's walk counts dots only;
* ``bytes``: operands plus results of every op; views, ``detach``,
  allocations and metadata ops are free (JAX's ``_FREE_OPS``); a kernel op
  moves its :mod:`~repro_torch.kernels.cost` bytes, a collective its
  result;
* ``collective_wire_bytes``: JAX's ring model (``dryrun.py``
  ``parse_collectives``) by kind and group size s: all-reduce
  2 (s - 1) / s x out, all-gather (s - 1) / s x out, reduce-scatter
  (s - 1) x out, all-to-all (s - 1) / s x out, point-to-point out (and a
  broadcast (s - 1) / s x out, which JAX's HLO never holds);
* ``peak_bytes``: the high-water mark of live storage bytes, the tracked
  arguments' included;
* per kernel op: how many times it was met, its flops and bytes (JAX's
  record has no such field).

A host read of a fake tensor's value (``int(t)``, ``t.item()``) has no
value to read: it reads 1, the first step's count, which is what the CPU
route's AdamW reads it for (its bias corrections).

:meth:`OpCounter.result` gives JAX's ``analyze_hlo`` keys where they mean
the same thing (``unknown_trip_loops`` is always 0: no loop goes
unseen).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels.cost import COSTS

#: c10d op -> its kind; the op's first argument holds its result
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast_": "broadcast",
}

_SCALAR = torch.ops.aten._local_scalar_dense.default
#: What a host read of a fake tensor gives, by "is it floating": the first
#: step's count.
_STAND_IN = {False: 1, True: 1.0}

_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "resize_",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_contiguous", "is_same_size", "_local_scalar_dense", "set_",
         "_has_compatible_shallow_copy_type"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(args) -> int:
    from torch._C._distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
    return 1


def ring_wire(kind: str, out_bytes: float, group: int) -> float:
    """Per-device wire bytes of one collective by JAX's ring model; a group
    of one rank moves nothing (XLA drops such a collective from the
    HLO)."""
    if group <= 1:
        return 0.0
    s = group
    ring = (s - 1) / s
    if kind == "all-reduce":
        return 2 * ring * out_bytes
    if kind == "reduce-scatter":
        return ring * out_bytes * s
    if kind == "collective-permute":
        return out_bytes
    return ring * out_bytes  # all-gather, all-to-all, broadcast


def _tensor_leaves(obj):
    """Tensors in a tree of containers, modules (their parameters and
    buffers) and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensor_leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensor_leaves(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for v in vars(obj).values():
            yield from _tensor_leaves(v)


class OpCounter(TorchDispatchMode):
    """Counts what runs under it; :meth:`track` the step's arguments first
    so that the peak holds them. One counter counts one step."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.wire: Dict[str, float] = defaultdict(float)
        self.collective_counts: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    # -- live storage ------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        if storage in self._seen:
            return
        n = storage.nbytes()
        self._seen[storage] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n

    def track(self, *trees: Any) -> None:
        """Hold every tensor of ``trees`` live from now (the arguments)."""
        for tree in trees:
            for t in _tensor_leaves(tree):
                self._hold(t)

    # -- the dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _SCALAR and isinstance(args[0], FakeTensor):
            # a host read of a value that a fake tensor has not got (the
            # CPU route's AdamW bias correction reads its step count)
            return _STAND_IN[args[0].dtype.is_floating_point]
        out = func(*args, **kwargs)
        space = func.namespace
        if space == "prim":
            return out
        name = func.__name__.split(".")[0]
        if space == "repro_torch":
            cost = COSTS[name](*args, **kwargs)
            row = self.kernels.setdefault(name, {"count": 0, "flops": 0.0,
                                                 "bytes": 0.0})
            row["count"] += 1
            row["flops"] += cost.flops
            row["bytes"] += cost.bytes
            self.flops += cost.flops
            self.bytes += cost.bytes
        elif space == "c10d":
            if name in _C10D:
                kind = _C10D[name]
                out_bytes = _nbytes(args[0])
                self.wire[kind] += ring_wire(kind, out_bytes,
                                             _group_size(args))
                self.collective_counts[kind] += 1
                self.bytes += out_bytes
        elif name not in _FREE and not func.is_view:
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        for t in _tensors(out):
            self._hold(t)
        return out

    def result(self) -> Dict[str, Any]:
        """JAX's ``analyze_hlo`` keys, plus the collectives' counts, the
        peak of live bytes and the per-kernel-op rows."""
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collective_wire_bytes": float(sum(self.wire.values())),
            "collective_ops": {k: float(v) for k, v in self.wire.items()},
            "collective_counts": dict(self.collective_counts),
            "unknown_trip_loops": 0,
            "peak_bytes": int(self.peak),
            "kernel_ops": {k: dict(v) for k, v in self.kernels.items()},
        }

