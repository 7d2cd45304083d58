"""Collectives of the sharded lookups (port of
``repro.distrib.collectives``).

Two lookups into a table row-sharded over ``model`` (each model rank
holds rows ``[m * rows, (m + 1) * rows)``; ids are this rank's batch
rows, as the data axes split them):

* :func:`sharded_embedding_lookup` — JAX's pjit baseline: the full table
  is gathered over ``model`` and indexed. Wire bytes grow with the table.
* :func:`masked_psum_lookup` — each model rank gathers the rows it owns,
  zeroes the rest, and one all-reduce over ``model`` sums the pieces. Wire
  bytes = ids x dim x 4, whatever the table's size.

Every model rank then holds the same activations, and what follows is
replicated. Their backward is therefore JAX's transpose of a collective
under a replicated consumer: the all-reduce's is the identity (each rank
scatters its full, equal gradient into the rows it owns), the all-gather's
is the slice of the rank's own rows. ``torch.distributed.nn``'s
differentiable ``all_reduce`` sums the gradients in its backward, which
would multiply every table gradient by the model axis's size.

FSDP's gather is the other case: a weight sharded over the data axes is
gathered for a consumer that differs from data rank to data rank (each
runs its own rows), so its backward must sum the ranks' gradients and
cut this rank's block (:class:`AllGatherReduceScatter`); the slicing
backward of :class:`AllGatherRows` would drop the other ranks' shares.
"""
from __future__ import annotations

import datetime
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distrib.shardings import (MODEL_AXIS, axis_index,
                                           axis_names)

#: Every process group's timeout: a collective that some rank never joins
#: fails after this long instead of waiting for ever.
TIMEOUT = datetime.timedelta(seconds=300)

# (id(mesh), axes) -> (the mesh, this rank's group over those axes); the
# mesh kept so that a later mesh at a freed one's id is not taken for it
_AXES_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[object, object]] = {}


def axes_group(mesh, axes: Sequence[str]):
    """This rank's process group over the mesh ``axes`` (the ranks that
    share its coordinates on every other axis). One axis is the mesh's
    own group; several are made once per mesh (every rank makes every
    group, in the same order), with :data:`TIMEOUT`."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _AXES_GROUPS or _AXES_GROUPS[key][0] is not mesh:
        names = axis_names(mesh)
        if sorted(axes, key=names.index) != list(axes):
            raise ValueError(f"axes {axes} out of the mesh's order {names}")
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims)
        size = 1
        for d in dims:
            size *= ranks.shape[len(rest) + dims.index(d)]
        me = dist.get_rank()
        for row in ranks.reshape(-1, size).tolist():
            group = dist.new_group(row, timeout=TIMEOUT)
            if me in row:
                _AXES_GROUPS[key] = (mesh, group)
    return _AXES_GROUPS[key][1]


class AllReduceSum(torch.autograd.Function):
    """Forward: the sum over ``group``. Backward: the identity (the
    consumer is replicated over ``group``)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class AllGatherRows(torch.autograd.Function):
    """Forward: the blocks of ``group``'s ranks stacked along dim 0 (rank
    order). Backward: this rank's block of the gradient (the consumer is
    replicated over ``group``)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        ctx.block = (dist.get_rank(group) * x.shape[0], x.shape[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, rows = ctx.block
        return grad[lo:lo + rows], None


class AllGatherReduceScatter(torch.autograd.Function):
    """Forward: the blocks of ``group``'s ranks concatenated along ``dim``
    (rank order), laid out as the unsharded tensor. Backward: the gradient
    summed over ``group`` and cut to this rank's block, a reduce-scatter
    (FSDP: each rank's consumer is its own)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                          + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        # a weight's layout decides the GEMM the card runs on it
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.movedim(ctx.dim, 0).contiguous()
        out = grad.new_empty((grad.shape[0] // dist.get_world_size(
            ctx.group),) + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad, group=ctx.group)
        # a parameter's gradient, for kernels that take contiguous tensors
        return out.movedim(0, ctx.dim).contiguous(), None, None


def gather_rows(block: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The full tensor of ``group``'s blocks stacked along ``dim`` in rank
    order (no gradient)."""
    block = block.detach().movedim(dim, 0).contiguous()
    full = block.new_empty((dist.get_world_size(group) * block.shape[0],)
                           + tuple(block.shape[1:]))
    dist.all_gather_into_tensor(full, block, group=group)
    return full.movedim(0, dim)


class SumGradients(torch.autograd.Function):
    """Forward: the identity on a tensor every rank of ``group`` holds
    equal. Backward: the sum over ``group`` of the ranks' gradients, each
    of which covers only the rank's share of the work that read it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                             mesh) -> torch.Tensor:
    """The baseline: gather the whole table over ``model``, then index it
    (``table`` is this rank's row shard; ``ids`` global row ids)."""
    full = AllGatherRows.apply(table, mesh.get_group(MODEL_AXIS))
    return full[ids]


def masked_psum_lookup(mesh, *, batch_dims: int = 2, gather=None):
    """A lookup ``(table_shard (rows, d), ids (B, K) or (B,)) -> (B, K, d)``
    for a table row-sharded over ``model``: each model rank gathers the
    rows it owns (ids outside its range give zeros) and the pieces are
    summed over ``model``. Differentiable: the gradient scatters into the
    owning shard only. ``gather(table, rows)`` gathers the local rows
    (default ``table[rows]``; the recsys tables pass theirs, whose
    backward is one ``index_add_``)."""
    group = mesh.get_group(MODEL_AXIS)
    midx = axis_index(mesh, MODEL_AXIS)

    def lookup(table_shard: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if ids.dim() != batch_dims:
            raise ValueError(f"masked_psum_lookup(batch_dims={batch_dims}) "
                             f"got ids of shape {tuple(ids.shape)}")
        rows = table_shard.shape[0]
        local = ids.to(torch.int64) - midx * rows
        owned = (local >= 0) & (local < rows)
        safe = torch.clamp(local, 0, rows - 1)
        emb = table_shard[safe] if gather is None else gather(table_shard,
                                                               safe)
        emb = torch.where(owned[..., None], emb, torch.zeros_like(emb))
        return AllReduceSum.apply(emb, group)

    return lookup


def moe_all_to_all_dispatch(mesh, n_experts: int, capacity: int):
    """GShard-style capacity-bounded MoE dispatch: kept with the model."""
    raise NotImplementedError(
        "dispatch lives in repro.models.lm.moe.MoELayer (kept with the model)")
