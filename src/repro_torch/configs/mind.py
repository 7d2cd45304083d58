"""mind [recsys] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030; unverified].

Port of ``repro.configs.mind``, plus :func:`make_model`, which
``chip_smoke.py`` drives.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.recsys_common import (  # noqa: F401
    SHAPES, build_recsys_cell, sequence_batch_factory)
from repro_torch.models.recsys import MIND, MINDConfig

FULL = MINDConfig(name="mind", embed_dim=64, n_interests=4, capsule_iters=3,
                  history_len=50, item_vocab=10_000_000)


def reduced() -> MINDConfig:
    return MINDConfig(name="mind-smoke", embed_dim=8, n_interests=2,
                      capsule_iters=2, history_len=10, item_vocab=500)


def _flops_per_example(cfg: MINDConfig) -> float:
    L, D, K = cfg.history_len, cfg.embed_dim, cfg.n_interests
    bilinear = 2.0 * L * D * D
    routing = cfg.capsule_iters * (2 * 2.0 * L * K * D)
    label_aware = 2.0 * K * D
    return bilinear + routing + label_aware


def make_model(device="cuda", seed: int = 0,
               cfg: Optional[MINDConfig] = None) -> MIND:
    """MIND at ``cfg`` (default the published width, :data:`FULL`), with
    random weights drawn on ``device`` from ``seed``."""
    return MIND(cfg or FULL, device=device, seed=seed)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    f = _flops_per_example(FULL)
    return build_recsys_cell(
        MIND(FULL, device="meta"), shape, mesh,
        batch_factory=sequence_batch_factory(FULL.history_len),
        flops_per_example=f,
        retrieval_flops=f + 2.0 * 1_000_000 * FULL.n_interests
        * FULL.embed_dim,
        arch_name=FULL.name)
