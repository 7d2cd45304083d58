"""DeepFM [Guo et al. 2017, arXiv:1703.04247]: FM + deep tower, shared
embeddings (port of ``repro.models.recsys.deepfm``).

logit = w0 + sum_f w[ids_f] + FM2(V[ids]) + MLP(flatten(V[ids]))

The first-order sum is the ``embedding_bag`` kernel over the (N, 1) table
and the second-order term the ``fm_interaction`` kernel. Parameters are
named as in the JAX tree: ``embedding.table``, ``first_order.table``,
``mlp.layer_i.{kernel,bias}`` and a 0-d ``bias``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from repro_torch.kernels import fm_interaction
from repro_torch.models.recsys.base import RecsysModel, make_generator
from repro_torch.models.recsys.embedding import (TableConfig, bag_lookup,
                                                 init_table, table_lookup)
from repro_torch.nn import MLP
from repro_torch.nn import init as initializers


@dataclasses.dataclass
class DeepFMConfig:
    name: str = "deepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    mlp: Sequence[int] = (400, 400, 400)
    table_rows: int = 80_000_000
    compression: str = "none"
    compression_ratio: float = 1.0

    @property
    def table(self) -> TableConfig:
        return TableConfig(self.table_rows, self.embed_dim, self.compression,
                           self.compression_ratio)

    @property
    def first_order_table(self) -> TableConfig:
        return TableConfig(self.table_rows, 1, self.compression,
                           self.compression_ratio)


class DeepFM(RecsysModel):
    TABLES = ("embedding", "first_order")

    def __init__(self, cfg: DeepFMConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(device, seed)
        self.embedding = torch.nn.ParameterDict(
            init_table(cfg.table, gen, device))
        self.first_order = torch.nn.ParameterDict(
            init_table(cfg.first_order_table, gen, device))
        self.mlp = MLP(cfg.n_sparse * cfg.embed_dim, list(cfg.mlp), 1, gen,
                       activation="relu", device=device)
        self.bias = torch.nn.Parameter(initializers.zeros((), device))

    def forward(self, batch: Dict[str, torch.Tensor], mesh=None
                ) -> torch.Tensor:
        """batch["field_ids"]: (B, n_sparse) global ids -> logits (B,)."""
        ids = batch["field_ids"]
        v = table_lookup(self.cfg.table, self.embedding, ids,
                         mesh)                                # (B, F, D)
        # First-order term as one fused bag reduction over the (N, 1) table:
        # sum_f w[ids_f] without a (B, F, 1) gather intermediate.
        first = bag_lookup(self.cfg.first_order_table, self.first_order,
                           ids, mesh=mesh)[..., 0]                  # (B,)
        fm = fm_interaction(v)                                      # (B,)
        deep = self.mlp(v.reshape(v.shape[0], -1))[..., 0]          # (B,)
        return self.bias + first + fm + deep
