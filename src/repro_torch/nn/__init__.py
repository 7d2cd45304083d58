"""Module base, initializers and dense layers (port of the parts of
``repro.nn`` that the click models and the tabular recsys models use)."""
from repro_torch.nn import init
from repro_torch.nn.layers import ACTIVATIONS, MLP, DeepCrossV2, Dense
from repro_torch.nn.module import Module

__all__ = ["ACTIVATIONS", "DeepCrossV2", "Dense", "MLP", "Module", "init"]
