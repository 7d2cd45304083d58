"""deepfm [recsys] n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm
[arXiv:1703.04247; paper]. Criteo-scale unified table (8e7 rows).

Port of ``repro.configs.deepfm``, plus :func:`make_model`, which
``chip_smoke.py`` drives.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.recsys_common import (  # noqa: F401
    SHAPES, build_recsys_cell, tabular_batch_factory)
from repro_torch.models.recsys import DeepFM, DeepFMConfig

FULL = DeepFMConfig(name="deepfm", n_sparse=39, embed_dim=10,
                    mlp=(400, 400, 400), table_rows=80_000_000)


def reduced() -> DeepFMConfig:
    return DeepFMConfig(name="deepfm-smoke", n_sparse=8, embed_dim=4,
                        mlp=(16, 16), table_rows=1000)


def _flops_per_example(cfg: DeepFMConfig) -> float:
    mlp_in = cfg.n_sparse * cfg.embed_dim
    dims = [mlp_in, *cfg.mlp, 1]
    mlp = sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    fm = 3.0 * cfg.n_sparse * cfg.embed_dim
    return mlp + fm


def make_model(device="cuda", seed: int = 0,
               cfg: Optional[DeepFMConfig] = None) -> DeepFM:
    """DeepFM at ``cfg`` (default the published width, :data:`FULL`), with
    random weights drawn on ``device`` from ``seed``."""
    return DeepFM(cfg or FULL, device=device, seed=seed)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    f = _flops_per_example(FULL)
    return build_recsys_cell(
        DeepFM(FULL, device="meta"), shape, mesh,
        batch_factory=tabular_batch_factory(FULL.n_sparse),
        flops_per_example=f,
        retrieval_flops=f * 1_000_000,
        arch_name=FULL.name)
