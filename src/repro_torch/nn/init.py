"""Parameter initializers: (shape, device) -> float32 tensor factories.

Port of the constant initializers of ``repro.nn.init`` that the ported
parameter modules use. The JAX versions take an rng they ignore; these take
the device the tensor is made on instead.
"""
from __future__ import annotations

import torch


def zeros(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def constant(value: float):
    def _init(shape, device=None, dtype=torch.float32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=device)

    return _init
