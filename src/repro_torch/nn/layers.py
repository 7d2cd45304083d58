"""Dense layers (port of ``Dense``, ``MLP`` and ``DeepCrossV2`` of
``repro.nn.layers``).

``kernel`` keeps the JAX layout (in, out), so ``y = x @ kernel + bias`` and
``repro_torch.convert`` copies a JAX tree without transposing. The dense
products are plain ``torch.matmul``, as the JAX package leaves them to XLA;
DeepCrossV2's cross layers go through the ``dcn_cross`` kernel op. Layers
are registered under the keys of the JAX tree (``layer_0 ..``,
``cross_0 ..``, ``deep``, ``head``). Only the options some caller sets are
ported (lecun_normal kernels and a bias on every layer, as in JAX's
defaults).
"""
from __future__ import annotations

from typing import Optional, Sequence

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
    last, ``final_activation`` after the last."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 out_features: int, generator: torch.Generator,
                 activation: str = "relu", final_activation: str = "identity",
                 device=None):
        super().__init__()
        dims = [in_features, *hidden, out_features]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", Dense(dims[i], dims[i + 1],
                                                generator, device=device))
        self.activation = ACTIVATIONS[activation]
        self.final_activation = ACTIVATIONS[final_activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x)
            x = (self.activation(x) if i < self.n_layers - 1
                 else self.final_activation(x))
        return x


class DeepCrossV2(Module):
    """DCN-V2 [Wang et al. 2021]: explicit feature crosses + deep network.

    cross layer: x_{l+1} = x0 * (x_l W_l + b_l) + x_l, through the
    ``dcn_cross`` kernel op on a (rows, D) view of the input.
    combination: "stacked" (cross -> deep) or "parallel" (concat(cross,
    deep)); with ``deep_layers=0`` the head reads the cross output. A final
    projection to ``out_features``.
    """

    def __init__(self, in_features: int, generator: torch.Generator,
                 cross_layers: int = 2, deep_layers: int = 2,
                 deep_width: Optional[int] = None, out_features: int = 1,
                 combination: str = "stacked", device=None):
        super().__init__()
        if combination not in ("stacked", "parallel"):
            raise ValueError(f"unknown combination {combination!r}")
        self.cross_layers = cross_layers
        self.combination = combination
        deep_width = deep_width or in_features
        for i in range(cross_layers):
            self.add_module(f"cross_{i}", Dense(in_features, in_features,
                                                generator, device=device))
        self.deep = (MLP(in_features, [deep_width] * max(deep_layers - 1, 0),
                         deep_width, generator, final_activation="relu",
                         device=device) if deep_layers > 0 else None)
        if self.deep is None:
            head_in = in_features
        elif combination == "stacked":
            head_in = deep_width
        else:
            head_in = in_features + deep_width
        self.head = Dense(head_in, out_features, generator, device=device)

    def _cross_stack(self, x0: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import dcn_cross

        flat = x0.reshape(-1, x0.shape[-1])
        x = flat
        for i in range(self.cross_layers):
            layer = getattr(self, f"cross_{i}")
            x = dcn_cross(flat, x, layer.kernel, layer.bias)
        return x.reshape(x0.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        crossed = self._cross_stack(x)
        if self.deep is None:
            return self.head(crossed)
        if self.combination == "stacked":
            h = self.deep(crossed)
        else:
            h = torch.cat([crossed, self.deep(x)], dim=-1)
        return self.head(h)
