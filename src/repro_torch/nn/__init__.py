"""Module base, initializers and layers (port of ``repro.nn``)."""
from repro_torch.nn import init
from repro_torch.nn.layers import (ACTIVATIONS, MLP, DeepCrossV2, Dense,
                                   Embedding, LayerNorm, RMSNorm, Scalar,
                                   Sequential, layer_norm)
from repro_torch.nn.module import Module

__all__ = ["ACTIVATIONS", "DeepCrossV2", "Dense", "Embedding", "LayerNorm",
           "MLP", "Module", "RMSNorm", "Scalar", "Sequential", "init",
           "layer_norm"]
