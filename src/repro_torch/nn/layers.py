"""Dense layers (port of ``Dense`` and ``MLP`` of ``repro.nn.layers``).

``kernel`` keeps the JAX layout (in, out), so ``y = x @ kernel + bias`` and
``repro_torch.convert`` copies a JAX tree without transposing. The products
are plain ``torch.matmul``, as the JAX package leaves them to XLA. MLP
layers are registered as ``layer_0 .. layer_{n-1}``, the keys of the JAX
tree. Only the JAX defaults are ported (lecun_normal kernels, a bias on
every layer, no final activation): DeepFM, the one caller, uses them.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.nn import init as initializers
from repro_torch.nn.module import Module

ACTIVATIONS = {
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


class Dense(Module):
    """y = x @ W + b."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.kernel = torch.nn.Parameter(initializers.lecun_normal()(
            (in_features, out_features), generator, device))
        self.bias = torch.nn.Parameter(
            initializers.zeros((out_features,), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class MLP(Module):
    """Multi-layer perceptron: ``activation`` after every layer but the
    last."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 out_features: int, generator: torch.Generator,
                 activation: str = "relu", device=None):
        super().__init__()
        dims = [in_features, *hidden, out_features]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", Dense(dims[i], dims[i + 1],
                                                generator, device=device))
        self.activation = ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x)
            if i < self.n_layers - 1:
                x = self.activation(x)
        return x
