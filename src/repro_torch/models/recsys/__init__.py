"""Tabular recsys models on the shared huge-table substrate (port of
``repro.models.recsys``: DeepFM and AutoInt; BST and MIND wait)."""
from repro_torch.models.recsys.autoint import AutoInt, AutoIntConfig
from repro_torch.models.recsys.deepfm import DeepFM, DeepFMConfig
from repro_torch.models.recsys.embedding import (TableConfig, bag_lookup,
                                                 init_table, table_lookup)

__all__ = [
    "AutoInt", "AutoIntConfig", "DeepFM", "DeepFMConfig", "TableConfig",
    "bag_lookup", "init_table", "table_lookup",
]
