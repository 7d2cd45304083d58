"""Recsys models on the shared huge-table substrate (port of
``repro.models.recsys``): the tabular DeepFM and AutoInt and the sequence
models BST and MIND."""
from repro_torch.models.recsys.autoint import AutoInt, AutoIntConfig
from repro_torch.models.recsys.bst import BST, BSTConfig
from repro_torch.models.recsys.deepfm import DeepFM, DeepFMConfig
from repro_torch.models.recsys.embedding import (TableConfig, bag_lookup,
                                                 init_table, table_lookup)
from repro_torch.models.recsys.mind import MIND, MINDConfig

__all__ = [
    "AutoInt", "AutoIntConfig", "BST", "BSTConfig", "DeepFM", "DeepFMConfig",
    "MIND", "MINDConfig", "TableConfig", "bag_lookup", "init_table",
    "table_lookup",
]
