"""AutoInt [Song et al. 2018, arXiv:1810.11921]: self-attention feature
interaction over field embeddings, with residual projections (port of
``repro.models.recsys.autoint``).

Each layer's attention over the F fields is the ``flash_attention``
kernel. Parameters are named as in the JAX tree: ``embedding.table``,
``attn_l.{wq,wk,wv,w_res}`` and ``head.{w,b}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.kernels import flash_attention
from repro_torch.models.recsys.base import RecsysModel, make_generator
from repro_torch.models.recsys.embedding import (TableConfig, init_table,
                                                 table_lookup)
from repro_torch.nn import init as initializers


@dataclasses.dataclass
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    table_rows: int = 80_000_000
    compression: str = "none"
    compression_ratio: float = 1.0

    @property
    def table(self) -> TableConfig:
        return TableConfig(self.table_rows, self.embed_dim, self.compression,
                           self.compression_ratio)


class AutoInt(RecsysModel):
    def __init__(self, cfg: AutoIntConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(device, seed)
        self.embedding = torch.nn.ParameterDict(
            init_table(cfg.table, gen, device))
        dims = self._layer_dims()
        for l in range(cfg.n_attn_layers):
            d_in, d_out = dims[l], dims[l + 1]
            normal = initializers.normal((1.0 / d_in) ** 0.5)
            self.add_module(f"attn_{l}", torch.nn.ParameterDict({
                name: normal((d_in, d_out), gen, device)
                for name in ("wq", "wk", "wv", "w_res")}))
        flat = cfg.n_sparse * dims[-1]
        self.head = torch.nn.ParameterDict({
            "w": initializers.normal((1.0 / flat) ** 0.5)((flat, 1), gen,
                                                          device),
            "b": initializers.zeros((1,), device)})

    def _layer_dims(self):
        return [self.cfg.embed_dim] + [self.cfg.d_attn] * self.cfg.n_attn_layers

    def forward(self, batch: Dict[str, torch.Tensor], mesh=None
                ) -> torch.Tensor:
        cfg = self.cfg
        h = table_lookup(cfg.table, self.embedding, batch["field_ids"], mesh)
        B, F, _ = h.shape
        for l in range(cfg.n_attn_layers):
            lp = getattr(self, f"attn_{l}")

            def heads(w):  # (B, F, d) -> (B, H, F, d / H), a view
                return (h @ w).reshape(B, F, cfg.n_heads, -1).transpose(1, 2)

            # The op takes the (B, F, H, d / H)-backed views as they are
            # and returns its output in the same layout, so neither side
            # of the attention is copied.
            attn = flash_attention(heads(lp["wq"]), heads(lp["wk"]),
                                   heads(lp["wv"]), causal=False)
            attn = attn.transpose(1, 2).reshape(B, F, -1)
            h = torch.relu(attn + h @ lp["w_res"])
        flat = h.reshape(B, -1)
        return (flat @ self.head["w"])[..., 0] + self.head["b"][0]
