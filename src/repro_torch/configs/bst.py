"""bst [recsys] embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256
interaction=transformer-seq — Behavior Sequence Transformer (Alibaba)
[arXiv:1905.06874; paper].

Port of ``repro.configs.bst``, plus :func:`make_model`, which
``chip_smoke.py`` drives.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.recsys_common import (  # noqa: F401
    SHAPES, build_recsys_cell, sequence_batch_factory)
from repro_torch.models.recsys import BST, BSTConfig

FULL = BSTConfig(name="bst", embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
                 d_ff=128, mlp=(1024, 512, 256), item_vocab=20_000_000)


def reduced() -> BSTConfig:
    return BSTConfig(name="bst-smoke", embed_dim=8, seq_len=6, n_blocks=1,
                     n_heads=2, d_ff=16, mlp=(32, 16), item_vocab=500)


def _flops_per_example(cfg: BSTConfig) -> float:
    S, D = cfg.total_len, cfg.embed_dim
    attn = cfg.n_blocks * (4 * 2.0 * S * D * D + 2 * 2.0 * S * S * D
                           + 2 * 2.0 * S * D * cfg.d_ff)
    dims = [S * D, *cfg.mlp, 1]
    mlp = sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return attn + mlp


def make_model(device="cuda", seed: int = 0,
               cfg: Optional[BSTConfig] = None) -> BST:
    """BST at ``cfg`` (default the published width, :data:`FULL`), with
    random weights drawn on ``device`` from ``seed``."""
    return BST(cfg or FULL, device=device, seed=seed)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    f = _flops_per_example(FULL)
    # retrieval path is the factorized dot: 2 * C * D
    return build_recsys_cell(
        BST(FULL, device="meta"), shape, mesh,
        batch_factory=sequence_batch_factory(FULL.seq_len),
        flops_per_example=f,
        retrieval_flops=2.0 * 1_000_000 * FULL.embed_dim,
        arch_name=FULL.name)
