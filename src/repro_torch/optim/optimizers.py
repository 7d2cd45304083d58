"""Gradient transformations in the optax style, port of the AdamW path of
``repro.optim.optimizers``.

A transformation is an ``(init, update)`` pair over a *list* of tensors (the
port's counterpart of a pytree: e.g. ``list(model.parameters())``):
``update(grads, state, params) -> (updates, state)``, then
:func:`apply_updates`. The arithmetic keeps the JAX version's order of
operations (bias correction as in ``scale_by_adam``, weight decay added
after the Adam scaling, then ``-lr``), so results agree with it to float32
rounding.

Unlike the JAX version, which is pure, the Adam moments are updated in place
with ``torch._foreach_*`` ops and :func:`apply_updates` writes into the
parameters: at the paper's width each moment is 1.7 GB, and in-place updates
keep one copy of each. The step count is a host integer, so bias correction
needs no device sync.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensors = List[torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Optional[Tensors]], Tuple[Tensors, Any]]


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place."""
    torch._foreach_add_(list(params), list(updates))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        return torch._foreach_mul(list(grads), factor), state

    return GradientTransformation(init, update)


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(0, [torch.zeros_like(p) for p in params],
                                [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        grads = list(grads)
        count = state.count + 1
        mu, nu = state.mu, state.nu
        # mu = b1 m + (1-b1) g ; nu = b2 v + (1-b2) g^2 (in place)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        # float32 bias corrections, as repro computes 1 - b ** count in f32
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(count))
        c2 = float(f32(1) - f32(b2) ** f32(count))
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(mu, c1)
        torch._foreach_div_(updates, denom)
        return updates, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def init(params):
        del params
        return ()

    @torch.no_grad()
    def update(grads, state, params=None):
        if weight_decay == 0.0 or params is None:
            return grads, state
        return torch._foreach_add(list(grads), torch._foreach_mul(
            list(params), weight_decay)), state

    return GradientTransformation(init, update)


def adamw(learning_rate: float, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=1e-4) -> GradientTransformation:
    """AdamW (decoupled weight decay), the paper's default optimizer."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale(-learning_rate))
