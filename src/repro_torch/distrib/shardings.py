"""Mesh-axis conventions and sharding rules (port of
``repro.distrib.shardings``).

Axis convention:
  * ``pod``   — outer data-parallel axis (across hosts).
  * ``data``  — data parallelism within a host.
  * ``model`` — row-sharded tables (and, later, tensor parallelism).

Batch dims shard over ``(pod, data)``; tables shard over ``model``.

A spec is the port's own :class:`PartitionSpec`, JAX's type (not
DTensor's placements: the engine keeps local shards and runs explicit
collectives, see :mod:`repro_torch.train.engine`): one entry per tensor
dimension, the mesh axis (or tuple of axes) it is split over, or ``None``
for whole. :class:`NamedSharding` pairs a spec with its mesh and cuts a
full tensor to this rank's block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

from repro_torch.tree import map_with_paths

MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh axis name, a tuple of them, or None.
    Dimensions past the end are whole. As JAX's, a tuple of one axis is
    that axis, and an empty one None."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            (d[0] if len(d) == 1 else d or None) if isinstance(d, tuple)
            else d for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's axis names and sizes without ranks (JAX's
    ``AbstractMesh``): what a rule that reads only the mesh's shape takes
    (``param_specs`` at a production shape, with no world behind it)."""

    def __init__(self, shape, axis_names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axis_names)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.mesh_dim_names} differ in length")

    def size(self, dim: int) -> int:
        return self.shape[dim]


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(axis_names(mesh).index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def DATA_AXES(mesh) -> tuple:
    """Data-parallel axes present in this mesh ('pod' included if
    multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def data_parallel_size(mesh) -> int:
    """Total ways the batch axis splits: product of the data-axis sizes."""
    size = 1
    for axis in DATA_AXES(mesh):
        size *= axis_size(mesh, axis)
    return size


def data_parallel_index(mesh) -> int:
    """This rank's block of the batch: its row-major coordinate over the
    data axes."""
    index = 0
    for axis in DATA_AXES(mesh):
        index = index * axis_size(mesh, axis) + axis_index(mesh, axis)
    return index


def batch_spec(mesh, extra_dims: int = 1) -> P:
    """Leading dim over all data axes; remaining dims replicated."""
    return P(DATA_AXES(mesh), *([None] * extra_dims))


def chunked_batch_spec(mesh) -> P:
    """Spec for a ``(chunk, batch, ...)`` stacked-batch tensor: the chunk
    axis whole, the batch axis split over the data axes."""
    return P(None, DATA_AXES(mesh))


def table_spec(mesh, extra_dims: int = 1) -> P:
    """Row-sharded embedding table / stacked weight over the model axis."""
    return P(MODEL_AXIS, *([None] * extra_dims))


def replicated_spec() -> P:
    return P()


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); a leaf in the port's
    tree walks."""

    mesh: Any
    spec: P

    def block(self, shape) -> Tuple[slice, ...]:
        """This rank's block of a full tensor of ``shape``: per dimension,
        a contiguous slice, split over its axes in row-major order (JAX's
        layout)."""
        out = []
        for dim, size in enumerate(shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            parts, index = 1, 0
            for axis in _axes(entry):
                n = axis_size(self.mesh, axis)
                parts, index = parts * n, index * n + axis_index(self.mesh,
                                                                 axis)
            if size % parts:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split {parts} ways ({self.spec})")
            step = size // parts
            out.append(slice(index * step, (index + 1) * step))
        return tuple(out)

    def local(self, full):
        """This rank's block of ``full`` (a tensor or numpy array)."""
        return full[self.block(tuple(full.shape))]


def make_shardings(mesh, tree: Any, rule: Callable[[str, Any], P]):
    """A tree of :class:`NamedSharding` from a ``(path, leaf) -> spec``
    rule over ``tree`` (a nested dict such as the port's parameter tree;
    ``path`` is the leaf's ``/``-joined key path). A rule that returns
    None replicates."""
    def to_sharding(path, leaf):
        spec = rule(path, leaf)
        return NamedSharding(mesh, spec if spec is not None else P())

    return map_with_paths(to_sharding, tree)


def clax_param_rule(mesh, min_rows_to_shard: int = 1 << 16,
                    leading_axes: int = 0):
    """Sharding rule for CLAX/recsys params: big tables row-sharded over
    'model', everything else replicated (dense towers are tiny).

    ``leading_axes=k`` skips k leading dims before the row-count test and
    leaves them whole, e.g. the ``(R,)`` replica axis of a sweep.
    """
    model_size = axis_size(mesh, MODEL_AXIS)

    def rule(path, leaf):
        del path
        row_dim = leading_axes
        ndim = len(leaf.shape)
        if ndim >= row_dim + 1 and leaf.shape[row_dim] >= min_rows_to_shard \
                and leaf.shape[row_dim] % model_size == 0:
            return P(*([None] * row_dim), MODEL_AXIS,
                     *([None] * (ndim - row_dim - 1)))
        return P()

    return rule
