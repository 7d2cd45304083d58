"""Shared huge-table embedding substrate for the recsys models.

Port of ``repro.models.recsys.embedding``: one unified table that fields
reach through disjoint id ranges, with optional hashing-trick or
quotient-remainder compression. A table's parameters are a mapping of
tensors keyed as in the JAX tree (``table``, or ``quotient`` and
``remainder``), e.g. a ``torch.nn.ParameterDict``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.parameterization import _round_up, hash_ids
from repro_torch.kernels import embedding_bag
from repro_torch.nn import init as initializers


@dataclasses.dataclass
class TableConfig:
    rows: int
    dim: int
    compression: str = "none"           # none | hash | qr
    compression_ratio: float = 1.0

    @property
    def stored_rows(self) -> int:
        if self.compression == "hash":
            return _round_up(
                max(int(self.rows / max(self.compression_ratio, 1.0)), 2))
        return self.rows

    @property
    def qr_rem_rows(self) -> int:
        return _round_up(
            max(int(self.rows / max(self.compression_ratio, 1.0) / 2), 2))

    @property
    def qr_quot_rows(self) -> int:
        return _round_up(int(-(-self.rows // self.qr_rem_rows)))


def init_table(cfg: TableConfig, generator: torch.Generator, device=None,
               stddev: float = 0.02) -> Dict[str, torch.Tensor]:
    normal = initializers.normal(stddev)
    if cfg.compression == "qr":
        return {"quotient": normal((cfg.qr_quot_rows, cfg.dim), generator,
                                   device),
                "remainder": normal((cfg.qr_rem_rows, cfg.dim), generator,
                                    device)}
    return {"table": normal((cfg.stored_rows, cfg.dim), generator, device)}


class _Rows(torch.autograd.Function):
    """``table[rows]`` for rows in range, whose backward is one
    ``index_add_``, as the ``embedding_bag`` op's is: the card's atomics
    add an id's repeats as they come, in no fixed order, so two runs of the
    same step give table gradients that differ in their last bits.
    Indexing's backward (``index_put_`` with accumulate) sorts the ids and
    sums each id's repeats one after another, and ``F.embedding``'s sorts
    them into partial sums; both repeat to the bit. Skewed ids make the
    difference: MIND reads every padded slot as row 0, and
    ``chip_smoke.py``'s ``gather_forms`` (the three forms in turns, PERF.md
    §6) times a training batch's forward and backward on an H100 at 683 ms
    with indexing, 40 with ``F.embedding`` and 31 with this (127, 32 and
    28 with the padding redrawn); BST 61, 47, 45; DeepFM 11.2, 13.2,
    9.6."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.table_shape = table.shape
        return F.embedding(rows, table)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        d_table = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        d_table.index_add_(0, rows.reshape(-1),
                           g.reshape(-1, ctx.table_shape[1]))
        return d_table, None


def _lookup(mesh, table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` for global rows in range by the ``index_add_``-backed
    gather; on a mesh ``table`` is this rank's block of rows over
    ``model`` and the rows it owns are summed over ``model``
    (:func:`~repro_torch.distrib.collectives.masked_psum_lookup`)."""
    if mesh is None:
        return _Rows.apply(table, rows)
    from repro_torch.distrib.collectives import masked_psum_lookup

    return masked_psum_lookup(mesh, batch_dims=rows.dim(),
                              gather=_Rows.apply)(table, rows)


def table_lookup(cfg: TableConfig, params: Mapping[str, torch.Tensor],
                 ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """ids (...,) -> embeddings (..., dim). With ``mesh`` the tables are
    this rank's rows over ``model``: each id is hashed or clipped globally
    first, then looked up where it lives. A QR table's quotient and
    remainder rows are each summed over ``model`` before their product."""
    ids = ids.long()
    if cfg.compression == "hash":
        return _lookup(mesh, params["table"], hash_ids(ids, cfg.stored_rows))
    if cfg.compression == "qr":
        q = _lookup(mesh, params["quotient"],
                    (ids // cfg.qr_rem_rows) % cfg.qr_quot_rows)
        r = _lookup(mesh, params["remainder"], ids % cfg.qr_rem_rows)
        return q * r
    return _lookup(mesh, params["table"],
                   torch.clamp(ids, 0, cfg.stored_rows - 1))


def bag_lookup(cfg: TableConfig, params: Mapping[str, torch.Tensor],
               ids: torch.Tensor, weights: Optional[torch.Tensor] = None,
               combiner: str = "sum", mesh=None) -> torch.Tensor:
    """Fused bag reduction: out[b] = reduce_l w[b,l] * table[ids[b,l]].

    Routes through the ``embedding_bag`` kernel (ids < 0 are padding). An
    uncompressed table's ids are handed over untouched with ``clip_ids``:
    the op reads an id >= ``stored_rows`` as the last row in the forward
    and the backward, which is the clip that JAX's ``bag_lookup`` applies.
    QR-compressed tables have no materialized row table to gather from, so
    they take lookup + reduce.

    With ``mesh`` the table is this rank's rows over ``model``: each id is
    clipped (or hashed) globally, the ids this rank does not own become
    padding, the kernel bags the local rows, and the bags are summed over
    ``model``. The mean combiner's weights divide by the bag's global count
    of live ids, before the masking.
    """
    if cfg.compression == "qr":
        rows = table_lookup(cfg, params, torch.clamp_min(ids, 0), mesh)
        w = (torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
             if weights is None else weights)
        w = torch.where(ids >= 0, w, 0.0).float()
        if combiner == "mean":
            count = torch.sum((ids >= 0).float(), dim=1, keepdim=True)
            w = w / torch.clamp_min(count, 1.0)
        return torch.einsum("bld,bl->bd", rows.float(), w)
    if mesh is None:
        if cfg.compression == "hash":
            ids = torch.where(ids >= 0, hash_ids(ids.long(), cfg.stored_rows),
                              -1)
        return embedding_bag(params["table"], ids, weights,
                             combiner=combiner, clip_ids=True)
    from repro_torch.distrib.collectives import AllReduceSum
    from repro_torch.distrib.shardings import MODEL_AXIS, axis_index

    live = ids >= 0
    wide = ids.long()
    rows = (hash_ids(wide, cfg.stored_rows) if cfg.compression == "hash"
            else torch.clamp(wide, 0, cfg.stored_rows - 1))
    if combiner == "mean":
        count = torch.sum(live.float(), dim=1, keepdim=True)
        if weights is None:
            weights = torch.ones(ids.shape, dtype=torch.float32,
                                 device=ids.device)
        weights = weights / torch.clamp_min(count, 1.0)
    elif combiner != "sum":
        raise ValueError(f"unknown combiner {combiner!r}")
    shard = params["table"]
    local = rows - axis_index(mesh, MODEL_AXIS) * shard.shape[0]
    owned = live & (local >= 0) & (local < shard.shape[0])
    local = torch.where(owned, local, -1)
    if ids.dtype == torch.int32:  # the kernel's int32 variant, as off a mesh
        local = local.int()
    return AllReduceSum.apply(embedding_bag(shard, local, weights),
                              mesh.get_group(MODEL_AXIS))


def table_spec(cfg: TableConfig) -> Dict:
    """Row-sharded over 'model' (both QR components too)."""
    from repro_torch.distrib.shardings import P

    if cfg.compression == "qr":
        return {"quotient": P("model", None), "remainder": P("model", None)}
    return {"table": P("model", None)}
