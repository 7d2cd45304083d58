"""Parameter initializers: tensor factories over (shape, device).

Port of ``repro.nn.init``. The constant initializers take the device the
tensor is made on in place of the rng that the JAX versions ignore. The
random ones take an explicit ``torch.Generator`` on that device: from the
same seed they give other numbers than ``jax.random``, so parity tests
carry weights over with ``repro_torch.convert`` instead of re-drawing them.
On the ``meta`` device (no generator) they make shapes and types only.
"""
from __future__ import annotations

import math

import torch


def zeros(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def constant(value: float):
    def _init(shape, device=None, dtype=torch.float32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=device)

    return _init


def normal(stddev: float = 0.02):
    def _init(shape, generator: torch.Generator, device=None,
              dtype=torch.float32) -> torch.Tensor:
        out = torch.randn(shape, generator=generator, device=device)
        return (out * stddev).to(dtype)

    return _init


def _truncated_standard_normal(shape, generator, device) -> torch.Tensor:
    out = torch.empty(shape, device=device)
    if out.is_meta:  # shapes and types only: nothing to draw
        return out
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def truncated_normal(stddev: float = 0.02):
    """A standard normal truncated at +-2, times ``stddev`` (as
    ``jax.random.truncated_normal(rng, -2, 2) * stddev``: no variance
    correction)."""
    def _init(shape, generator: torch.Generator, device=None,
              dtype=torch.float32) -> torch.Tensor:
        out = _truncated_standard_normal(shape, generator, device)
        return (out * stddev).to(dtype)

    return _init


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return shape[-2] * receptive, shape[-1] * receptive


def lecun_normal():
    """A standard normal truncated at +-2, scaled by 1/sqrt(fan_in)."""
    def _init(shape, generator: torch.Generator, device=None,
              dtype=torch.float32) -> torch.Tensor:
        fan_in, _ = _fans(shape)
        std = (1.0 / max(fan_in, 1)) ** 0.5
        out = _truncated_standard_normal(shape, generator, device)
        return (out * std).to(dtype)

    return _init


def glorot_uniform():
    """Uniform on +-sqrt(6 / (fan_in + fan_out))."""
    def _init(shape, generator: torch.Generator, device=None,
              dtype=torch.float32) -> torch.Tensor:
        fan_in, fan_out = _fans(shape)
        limit = (6.0 / max(fan_in + fan_out, 1)) ** 0.5
        out = torch.rand(shape, generator=generator, device=device)
        return (out * (2.0 * limit) - limit).to(dtype)

    return _init


def logit_of_prob(p: float):
    """A constant with sigmoid(value) == p (CLAX's CTR-style init)."""
    return constant(math.log(p) - math.log1p(-p))
