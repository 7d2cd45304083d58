"""Layers (port of ``repro.nn.layers``: ``Dense``, ``MLP``,
``DeepCrossV2``, ``Scalar``, ``Embedding``, ``LayerNorm``, ``RMSNorm`` and
``Sequential``).

``kernel`` keeps the JAX layout (in, out), so ``y = x @ kernel + bias`` and
``repro_torch.convert`` copies a JAX tree without transposing. The dense
products are plain ``torch.matmul``, as the JAX package leaves them to XLA;
DeepCrossV2's cross layers go through the ``dcn_cross`` kernel op. Layers
are registered under the keys of the JAX tree (``layer_0 ..``,
``cross_0 ..``, ``deep``, ``head``, ``mod_0 ..``) and parameters under its
leaf names (``kernel``, ``bias``, ``value``, ``table``, ``scale``). Only
the options some caller sets are ported (lecun_normal kernels and a bias
on every dense layer, the norms' float32 output, as in JAX's defaults).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

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


class Scalar(Module):
    """A single learnable scalar (or small vector) logit, e.g. GCTR's rho.
    ``init_fn`` is a constant initializer of ``repro_torch.nn.init``
    (``zeros`` by default)."""

    def __init__(self, shape=(), init_fn: Optional[Callable] = None,
                 device=None):
        super().__init__()
        init_fn = init_fn or initializers.zeros
        self.value = torch.nn.Parameter(init_fn(tuple(shape), device))

    def forward(self) -> torch.Tensor:
        return self.value


class Embedding(Module):
    """Plain dense embedding table: ids -> rows, drawn from normal(0.02)."""

    def __init__(self, num_embeddings: int, features: int,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.table = torch.nn.Parameter(initializers.normal(0.02)(
            (num_embeddings, features), generator, device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table[ids.long()]


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale (+ bias) over the last axis,
    in float32, with JAX's population variance (``jnp.var``, ddof 0; not
    ``torch.var``'s unbiased default) and its default eps of 1e-6 (not
    ``torch.nn.LayerNorm``'s 1e-5)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    return y if bias is None else y + bias.float()


class LayerNorm(Module):
    """:func:`layer_norm` with a learned ``scale`` (ones) and, with
    ``use_bias``, ``bias`` (zeros); float32 out."""

    def __init__(self, features: int, eps: float = 1e-6,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.scale = torch.nn.Parameter(initializers.ones((features,),
                                                          device))
        self.bias = (torch.nn.Parameter(initializers.zeros((features,),
                                                           device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class RMSNorm(Module):
    """x * rsqrt(mean(x^2) + eps) * scale over the last axis; float32 out."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = torch.nn.Parameter(initializers.ones((features,),
                                                          device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        return xf * torch.rsqrt(ms + self.eps) * self.scale.float()


class Sequential(Module):
    """The modules in order, registered as ``mod_0 ..``."""

    def __init__(self, modules: Sequence[torch.nn.Module]):
        super().__init__()
        self.n_modules = len(modules)
        for i, m in enumerate(modules):
            self.add_module(f"mod_{i}", m)

    def forward(self, x):
        for i in range(self.n_modules):
            x = getattr(self, f"mod_{i}")(x)
        return x
