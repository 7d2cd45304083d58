"""MIND [Li et al. 2019, arXiv:1904.08030]: multi-interest extraction via
capsule dynamic (B2I) routing + label-aware attention (port of
``repro.models.recsys.mind``).

No kernel: the routing is plain products and softmaxes, as in JAX.
Parameters are named as in the JAX tree: ``embedding.table``,
``bilinear`` and ``routing_init``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.recsys.base import RecsysModel, make_generator
from repro_torch.models.recsys.embedding import (TableConfig, init_table,
                                                 table_lookup)
from repro_torch.nn import init as initializers


@dataclasses.dataclass
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    history_len: int = 50
    label_aware_pow: float = 2.0
    item_vocab: int = 10_000_000
    compression: str = "none"
    compression_ratio: float = 1.0

    @property
    def table(self) -> TableConfig:
        return TableConfig(self.item_vocab, self.embed_dim, self.compression,
                           self.compression_ratio)


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """|x|^2 / (1 + |x|^2) * x / |x|, finite (0) at x = 0."""
    norm2 = torch.sum(torch.square(x), dim=dim, keepdim=True)
    scale = norm2 / (1.0 + norm2) / torch.sqrt(norm2 + 1e-9)
    return scale * x


class MIND(RecsysModel):
    def __init__(self, cfg: MINDConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(device, seed)
        D = cfg.embed_dim
        self.embedding = torch.nn.ParameterDict(
            init_table(cfg.table, gen, device))
        self.bilinear = torch.nn.Parameter(initializers.normal(
            (1.0 / D) ** 0.5)((D, D), gen, device))
        # fixed (non-trained in-paper) routing-logit init, kept learnable
        self.routing_init = torch.nn.Parameter(initializers.normal(0.02)(
            (cfg.history_len, cfg.n_interests), gen, device))

    def interests(self, batch: Dict[str, torch.Tensor], mesh=None
                  ) -> torch.Tensor:
        """history_ids (B, L) [-1 = pad] -> interest capsules (B, K, D).
        Padding is masked twice, as in JAX: its id reads row 0, then its
        embedding and its routing weights are zeroed. The routing logits
        carry gradient through every iteration."""
        cfg = self.cfg
        ids = batch["history_ids"]
        mask = (ids >= 0)[..., None]
        e = table_lookup(cfg.table, self.embedding, torch.clamp_min(ids, 0),
                         mesh)
        e = torch.where(mask, e, 0.0)                            # (B, L, D)
        eh = e @ self.bilinear                                   # (B, L, D)
        b = self.routing_init[None].expand(ids.shape[0], -1, -1)
        u = None
        for _ in range(cfg.capsule_iters):
            w = torch.where(mask, torch.softmax(b, dim=-1), 0.0)  # (B, L, K)
            u = _squash(torch.einsum("blk,bld->bkd", w, eh))     # (B, K, D)
            b = b + torch.einsum("bkd,bld->blk", u, eh)
        return u

    def forward(self, batch: Dict[str, torch.Tensor], mesh=None
                ) -> torch.Tensor:
        """Label-aware scoring of target_ids (B,) -> logit (B,): the
        interests soft-selected by a softmax over K of pow * score."""
        u = self.interests(batch, mesh)                          # (B, K, D)
        t = table_lookup(self.cfg.table, self.embedding, batch["target_ids"],
                         mesh)
        scores = torch.einsum("bkd,bd->bk", u, t)                # (B, K)
        w = torch.softmax(self.cfg.label_aware_pow * scores, dim=-1)
        return torch.sum(w * scores, dim=-1)

    def retrieval_score(self, batch: Dict[str, torch.Tensor], mesh=None
                        ) -> torch.Tensor:
        """Multi-interest retrieval: the max over interests of each
        interest's dot with every candidate, in one (B, K, D) x (C, D)
        product: history_ids (B, L), candidate_ids (C,) -> (B, C)."""
        u = self.interests(batch, mesh)                          # (B, K, D)
        cand = table_lookup(self.cfg.table, self.embedding,
                            batch["candidate_ids"], mesh)        # (C, D)
        return torch.amax(u @ cand.t(), dim=1)
