"""Shared huge-table embedding substrate for the recsys models.

Port of ``repro.models.recsys.embedding`` (``table_spec``, the row-sharding
rule, waits for the distributed slice): one unified table that fields
reach through disjoint id ranges, with optional hashing-trick or
quotient-remainder compression. A table's parameters are a mapping of
tensors keyed as in the JAX tree (``table``, or ``quotient`` and
``remainder``), e.g. a ``torch.nn.ParameterDict``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

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


def table_lookup(cfg: TableConfig, params: Mapping[str, torch.Tensor],
                 ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) -> embeddings (..., dim)."""
    ids = ids.long()
    if cfg.compression == "hash":
        return params["table"][hash_ids(ids, cfg.stored_rows)]
    if cfg.compression == "qr":
        q = params["quotient"][(ids // cfg.qr_rem_rows) % cfg.qr_quot_rows]
        r = params["remainder"][ids % cfg.qr_rem_rows]
        return q * r
    return params["table"][torch.clamp(ids, 0, cfg.stored_rows - 1)]


def bag_lookup(cfg: TableConfig, params: Mapping[str, torch.Tensor],
               ids: torch.Tensor, weights: Optional[torch.Tensor] = None,
               combiner: str = "sum") -> torch.Tensor:
    """Fused bag reduction: out[b] = reduce_l w[b,l] * table[ids[b,l]].

    Routes through the ``embedding_bag`` kernel (ids < 0 are padding). An
    uncompressed table's ids are handed over untouched: the kernel reads an
    id >= ``stored_rows`` as the last row, which is the clip that JAX's
    ``bag_lookup`` applies. QR-compressed tables have no materialized row
    table to gather from, so they take lookup + reduce.
    """
    if cfg.compression == "qr":
        rows = table_lookup(cfg, params, torch.clamp_min(ids, 0))
        w = (torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
             if weights is None else weights)
        w = torch.where(ids >= 0, w, 0.0).float()
        if combiner == "mean":
            count = torch.sum((ids >= 0).float(), dim=1, keepdim=True)
            w = w / torch.clamp_min(count, 1.0)
        return torch.einsum("bld,bl->bd", rows.float(), w)
    if cfg.compression == "hash":
        ids = torch.where(ids >= 0, hash_ids(ids.long(), cfg.stored_rows), -1)
    return embedding_bag(params["table"], ids, weights, combiner=combiner)
