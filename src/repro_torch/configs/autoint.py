"""autoint [recsys] n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn [arXiv:1810.11921; paper].

Port of ``repro.configs.autoint``, plus :func:`make_model`, which
``chip_smoke.py`` drives.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.recsys_common import (  # noqa: F401
    SHAPES, build_recsys_cell, tabular_batch_factory)
from repro_torch.models.recsys import AutoInt, AutoIntConfig

FULL = AutoIntConfig(name="autoint", n_sparse=39, embed_dim=16,
                     n_attn_layers=3, n_heads=2, d_attn=32,
                     table_rows=80_000_000)


def reduced() -> AutoIntConfig:
    return AutoIntConfig(name="autoint-smoke", n_sparse=8, embed_dim=8,
                         n_attn_layers=2, n_heads=2, d_attn=8,
                         table_rows=1000)


def _flops_per_example(cfg: AutoIntConfig) -> float:
    F = cfg.n_sparse
    dims = [cfg.embed_dim] + [cfg.d_attn] * cfg.n_attn_layers
    total = 0.0
    for l in range(cfg.n_attn_layers):
        d_in, d_out = dims[l], dims[l + 1]
        total += 4 * 2.0 * F * d_in * d_out          # q,k,v,res projections
        total += 2 * 2.0 * F * F * d_out             # scores + weighted sum
    total += 2.0 * F * dims[-1]                      # head
    return total


def make_model(device="cuda", seed: int = 0,
               cfg: Optional[AutoIntConfig] = None) -> AutoInt:
    """AutoInt at ``cfg`` (default the published width, :data:`FULL`), with
    random weights drawn on ``device`` from ``seed``."""
    return AutoInt(cfg or FULL, device=device, seed=seed)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    f = _flops_per_example(FULL)
    return build_recsys_cell(
        AutoInt(FULL, device="meta"), shape, mesh,
        batch_factory=tabular_batch_factory(FULL.n_sparse),
        flops_per_example=f,
        retrieval_flops=f * 1_000_000,
        arch_name=FULL.name)
