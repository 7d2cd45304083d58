"""Behavior Sequence Transformer [Chen et al. 2019, arXiv:1905.06874]:
transformer block over the user's behavior sequence + target item, MLP head
(port of ``repro.models.recsys.bst``).

Each block's attention over the S = seq_len + 1 positions is the
``flash_attention`` kernel, and ``retrieval_score``'s mean-pooled history
is the ``embedding_bag`` kernel. Parameters are named as in the JAX tree:
``embedding.table``, ``pos_embed``, ``mlp.layer_i.{kernel,bias}`` and
``block_b.{wq,wk,wv,wo,ff1,ff2,ln1,ln2}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from repro_torch.kernels import flash_attention
from repro_torch.models.recsys.base import RecsysModel, make_generator
from repro_torch.models.recsys.embedding import (TableConfig, bag_lookup,
                                                 init_table, table_lookup)
from repro_torch.nn import MLP, layer_norm
from repro_torch.nn import init as initializers


@dataclasses.dataclass
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20            # behavior history length (target appended)
    n_blocks: int = 1
    n_heads: int = 8
    d_ff: int = 128
    mlp: Sequence[int] = (1024, 512, 256)
    item_vocab: int = 20_000_000
    compression: str = "none"
    compression_ratio: float = 1.0

    @property
    def table(self) -> TableConfig:
        return TableConfig(self.item_vocab, self.embed_dim, self.compression,
                           self.compression_ratio)

    @property
    def total_len(self) -> int:
        return self.seq_len + 1


class BST(RecsysModel):
    def __init__(self, cfg: BSTConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(device, seed)
        D = cfg.embed_dim
        self.embedding = torch.nn.ParameterDict(
            init_table(cfg.table, gen, device))
        self.pos_embed = torch.nn.Parameter(initializers.normal(0.02)(
            (cfg.total_len, D), gen, device))
        self.mlp = MLP(cfg.total_len * D, list(cfg.mlp), 1, gen,
                       activation="relu", device=device)
        normal = initializers.normal((1.0 / D) ** 0.5)
        for b in range(cfg.n_blocks):
            block = {name: normal((D, D), gen, device)
                     for name in ("wq", "wk", "wv", "wo")}
            block["ff1"] = normal((D, cfg.d_ff), gen, device)
            block["ff2"] = initializers.normal((1.0 / cfg.d_ff) ** 0.5)(
                (cfg.d_ff, D), gen, device)
            block["ln1"] = initializers.ones((D,), device)
            block["ln2"] = initializers.ones((D,), device)
            self.add_module(f"block_{b}", torch.nn.ParameterDict(block))

    @staticmethod
    def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """JAX's ``BST._ln``: population variance, eps 1e-6, no bias."""
        return layer_norm(x, scale).to(x.dtype)

    def encode(self, batch: Dict[str, torch.Tensor], mesh=None
               ) -> torch.Tensor:
        """history_ids (B, L) + target_ids (B,) -> (B, total_len, D)."""
        cfg = self.cfg
        seq_ids = torch.cat([batch["history_ids"],
                             batch["target_ids"][:, None]], dim=1)
        h = table_lookup(cfg.table, self.embedding, seq_ids, mesh)
        h = h + self.pos_embed[None]
        for b in range(cfg.n_blocks):
            bp = getattr(self, f"block_{b}")
            x = self._ln(h, bp["ln1"])
            B, S, D = x.shape

            def heads(w):  # (B, S, D) -> (B, H, S, D / H), a view
                return (x @ w).view(B, S, cfg.n_heads, -1).transpose(1, 2)

            # Three products, each handing the op the transpose(1, 2) view
            # of its own contiguous (B, S, H, Dh) tensor, which the kernel
            # reads as it is; its output comes back in that layout.
            a = flash_attention(heads(bp["wq"]), heads(bp["wk"]),
                                heads(bp["wv"]), causal=False)
            a = a.transpose(1, 2).reshape(B, S, D)
            h = h + a @ bp["wo"]
            x = self._ln(h, bp["ln2"])
            h = h + torch.relu(x @ bp["ff1"]) @ bp["ff2"]
        return h

    def forward(self, batch: Dict[str, torch.Tensor], mesh=None
                ) -> torch.Tensor:
        h = self.encode(batch, mesh)
        return self.mlp(h.reshape(h.shape[0], -1))[..., 0]

    def retrieval_score(self, batch: Dict[str, torch.Tensor], mesh=None
                        ) -> torch.Tensor:
        """Two-tower factorization for candidate scoring: the mean-pooled
        history (the ``embedding_bag`` kernel, mean combiner) plus the
        static positional mean, dotted against every candidate item's
        embedding in one product: history_ids (B, L), candidate_ids (C,)
        -> (B, C)."""
        cfg = self.cfg
        user_vec = (bag_lookup(cfg.table, self.embedding,
                               batch["history_ids"], combiner="mean",
                               mesh=mesh)
                    + torch.mean(self.pos_embed[:cfg.seq_len], dim=0))
        cand = table_lookup(cfg.table, self.embedding,
                            batch["candidate_ids"], mesh)        # (C, D)
        return user_vec @ cand.t()
