"""Shared cell-building machinery for the dry run (port of
``repro.configs.common``).

Every architecture module exposes ``FULL`` (the published configuration),
``reduced()`` (a small same-family config for CPU tests), ``SHAPES`` and
``build_cell(shape, mesh)`` -> :class:`Cell`: the step, its arguments and
their placement, and the analytic ``model_flops``.

Where JAX describes a cell's arguments as ``ShapeDtypeStruct``s of the
global shapes with a ``NamedSharding`` each (``sds``, ``named``,
``eval_shape_tree``), and lets GSPMD cut them, the port's step runs on one
rank's local tensors with explicit collectives. So a cell's ``args`` are
this rank's blocks, made under the caller's ``FakeTensorMode`` (shapes and
types, no storage): :func:`local_empty` cuts each global shape by its spec
(the port's :class:`~repro_torch.distrib.shardings.PartitionSpec`) on the
mesh, and :func:`fake_module` gives a module built on ``meta`` its tensors
on the cell's device. ``in_specs`` / ``out_specs`` record the placement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.distrib.shardings import (DATA_AXES, NamedSharding, P,
                                           axis_size)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str          # train | prefill | decode | serve | retrieval
    fn: Callable       # the step: fn(*args)
    args: Tuple[Any, ...]  # this rank's (fake) tensors, modules, ints
    in_specs: Any
    out_specs: Any
    model_flops: float  # analytic useful FLOPs per call
    notes: str = ""
    donate: tuple = ()  # args the step updates in place


def dp_axes(mesh) -> tuple:
    return DATA_AXES(mesh)


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= axis_size(mesh, a)
    return out


def divisible_batch_spec(mesh, batch: int) -> P:
    """Batch dim over as many data axes as divide it (1 -> replicated)."""
    axes = []
    remaining = batch
    for a in dp_axes(mesh):
        size = axis_size(mesh, a)
        if remaining % size == 0:
            axes.append(a)
            remaining //= size
    return P(tuple(axes)) if axes else P(None)


def local_shape(mesh, spec: P, shape) -> Tuple[int, ...]:
    """This rank's block of a global ``shape`` placed by ``spec``."""
    return tuple(s.stop - s.start
                 for s in NamedSharding(mesh, spec).block(tuple(shape)))


def local_empty(mesh, spec: P, shape, dtype, device) -> torch.Tensor:
    """An uninitialised tensor of this rank's block of ``shape`` (a fake
    one under a ``FakeTensorMode``)."""
    return torch.empty(local_shape(mesh, spec, shape), dtype=dtype,
                       device=device)


def local_batch(mesh, shapes: dict, specs: dict, device) -> dict:
    """``{key: local_empty(...)}`` for ``shapes`` ``{key: (shape,
    dtype)}`` placed by ``specs``."""
    return {k: local_empty(mesh, specs[k], shape, dtype, device)
            for k, (shape, dtype) in shapes.items()}


def fake_module(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` (built on ``meta``, its tables already cut to this rank's
    rows) with uninitialised tensors on ``device``: fake ones under the
    caller's ``FakeTensorMode``), each made anew from its shape and
    type."""
    for sub in module.modules():
        for name, p in list(sub._parameters.items()):
            if p is not None:
                sub._parameters[name] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device),
                    requires_grad=p.requires_grad)
        for name, b in list(sub._buffers.items()):
            if b is not None:
                sub._buffers[name] = torch.empty(b.shape, dtype=b.dtype,
                                                 device=device)
    return module
