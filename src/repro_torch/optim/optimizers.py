"""Gradient transformations in the optax style, port of
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
keep one copy of each. Step counts and injected learning rates are 0-d
tensors on the parameters' device, as in JAX's state.

:func:`step` is the entry point of a training step: on CPU tensors it runs
``update`` and ``apply_updates``; on CUDA tensors it runs the
transformation's fused pass (``adam`` and ``adamw``: one launch of the
hand-written ``adamw`` kernel per tensor, ``kernels/csrc/adamw.cu``) and
raises for a transformation that has none. It never runs the chain on the
card: the chain is the kernel's plain version, which the CPU runs and the
chip smoke holds the kernel against.
"""
from __future__ import annotations

from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.tree import tree_map

Tensors = List[torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Optional[Tensors]], Tuple[Tensors, Any]]
    # fused(grads, state, params, pred) -> state: one pass on the card that
    # updates params and state in place (nothing where the bool 0-d device
    # tensor pred is False); None where there is none. fused(..., pred,
    # norm=True, apply=ok) -> (state, sumsq): see step.
    fused: Optional[Callable[..., Any]] = None


def _device(params: Sequence[torch.Tensor]) -> torch.device:
    return params[0].device if len(params) else torch.device("cpu")


def global_norm(tensors: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place."""
    params = list(params)
    if params:
        torch._foreach_add_(params, [u.to(p.dtype)
                                     for p, u in zip(params, updates)])


def _cloned(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


@torch.no_grad()
def step(transform: GradientTransformation, grads: Tensors, state: Any,
         params: Tensors, pred: Optional[torch.Tensor] = None, *,
         norm: bool = False, apply: Optional[torch.Tensor] = None) -> Any:
    """One optimizer step of ``params`` in place; returns the new state.

    CPU parameters take ``transform.update`` and :func:`apply_updates`. CUDA
    parameters take ``transform.fused``; a transformation without one (sgd,
    adagrad, a schedule, a clip, an accumulation) raises, since the chain
    would run some sixteen passes where the kernel runs one.

    ``pred``, a bool 0-d tensor on the parameters' device, is the step's
    predicate (JAX's ``_guarded_one_step`` / the sweep's active mask): where
    it is False the parameters and the state, step count included, keep
    their values. The CPU takes JAX's ``where(pred, new, old)`` per leaf;
    the fused pass reads the predicate on the device and writes nothing.

    ``norm=True`` (the engine's telemetry) returns ``(state, sumsq)``:
    ``sumsq`` is the float64 0-d sum of squares of the parameters the step
    *would* write under ``apply`` alone (the guard's ``ok``; None: always),
    the updated parameters where it holds and the parameters as they stand
    where it does not. The step is written under ``pred & apply``. JAX's
    vmapped step takes its ``param_norm`` after the guard and before a
    sweep's active mask, so a frozen replica reports the update it would
    have made and keeps its parameters and state to the bit. The fused
    pass sums in the same pass that reads each tensor once."""
    params, grads = list(params), list(grads)
    if apply is not None:
        if not norm:
            raise ValueError("optim.step: apply is the would-be step's "
                             "predicate, for norm=True only")
        pred = apply if pred is None else pred & apply
    if {p.device.type for p in params} <= {"cpu"}:
        if pred is None:
            updates, state = transform.update(grads, state, params)
            apply_updates(params, updates)
            return (state, _sumsq(params)) if norm else state
        old_params, old_state = _cloned(params), _cloned(state)
        updates, state = transform.update(grads, state, params)
        apply_updates(params, updates)
        if norm:
            sumsq = _sumsq(params if apply is None else
                           [torch.where(apply, p, old)
                            for p, old in zip(params, old_params)])
        for p, old in zip(params, old_params):
            p.copy_(torch.where(pred, p, old))
        state = tree_map(lambda new, old: torch.where(pred, new, old)
                         if isinstance(new, torch.Tensor) else new,
                         state, old_state)
        return (state, sumsq) if norm else state
    if transform.fused is None:
        raise ValueError(
            "optim.step: this transformation has no fused pass for "
            f"{_device(params)} (adam and adamw with a constant or injected "
            "lr have one); call update and apply_updates to run the chain")
    return transform.fused(grads, state, params, pred, norm=norm,
                           apply=apply)


def _sumsq(tensors: Tensors) -> torch.Tensor:
    return sum((torch.sum(torch.square(t.double())) for t in tensors),
               torch.zeros((), dtype=torch.float64))


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


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]
                      ) -> GradientTransformation:
    def init(params):
        return torch.zeros((), dtype=torch.int32, device=_device(params))

    @torch.no_grad()
    def update(grads, count, params=None):
        del params
        factor = schedule(count)
        return [g * factor for g in grads], count + 1

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        del params
        return ()

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        norm = global_norm(grads)
        # A tensor over a tensor: `max_norm / t` would multiply by t's
        # reciprocal and round differently from JAX's division.
        factor = torch.clamp(torch.full_like(norm, max_norm)
                             / (norm + 1e-12), max=1.0)
        return [g * factor for g in grads], state

    return GradientTransformation(init, update)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # int32 0-d, on the parameters' device
    mu: Tensors
    nu: Tensors


def _bias_corrections(b1, b2, count: torch.Tensor):
    """float32 ``1 - b ** count``, as repro computes them."""
    f32 = np.float32
    k = f32(int(count))
    return (float(f32(1) - f32(b1) ** k), float(f32(1) - f32(b2) ** k))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, moment_dtype=torch.float32
                  ) -> GradientTransformation:
    """Adam's scaling. ``moment_dtype=torch.bfloat16`` stores the moments in
    bfloat16; they are updated in float32 and the update is computed from
    the stored moments, as in JAX."""
    def init(params):
        return ScaleByAdamState(
            torch.zeros((), dtype=torch.int32, device=_device(params)),
            [torch.zeros_like(p, dtype=moment_dtype) for p in params],
            [torch.zeros_like(p, dtype=moment_dtype) for p in params])

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        grads = [g.float() for g in grads]
        count = state.count + 1
        mu, nu = state.mu, state.nu
        if moment_dtype == torch.float32:
            # mu = b1 m + (1-b1) g ; nu = b2 v + (1-b2) g^2 (in place)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
        else:
            for m, v, g in zip(mu, nu, grads):
                m.copy_(m.float() * b1 + g * (1 - b1))
                v.copy_(v.float() * b2 + (g * g) * (1 - b2))
        c1, c2 = _bias_corrections(b1, b2, count)
        denom = torch._foreach_div([v.float() for v in nu], c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div([m.float() for m in mu], c1)
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


def _fused_adam(b1, b2, eps, weight_decay, learning_rate, inject):
    """The fused pass of adam (``weight_decay=0``) and adamw: advance the
    step count on the device (by the predicate, when there is one), then
    one ``adamw`` kernel launch per tensor, which reads the count (and an
    injected lr, and the predicate) there. In norm mode (see
    :func:`step`) the launches read the would-be step's count,
    the count plus ``apply``, and the pass returns the state and the sum
    of their sums of squares."""
    from repro_torch.kernels.adamw import adamw_cuda

    def fused(grads, state, params, pred=None, norm=False, apply=None):
        adam_state = state[0]
        lr_tensor = state[-1].lr if inject else None
        count = adam_state.count
        if norm:
            count = count + (1 if apply is None else apply)
        adam_state.count.add_(1 if pred is None else pred)
        sums = [adamw_cuda(p.detach(), g, m, v, count, b1=b1, b2=b2,
                           eps=eps, weight_decay=weight_decay,
                           lr=0.0 if inject else learning_rate,
                           lr_tensor=lr_tensor, pred=pred, norm=norm,
                           apply=apply)
                for p, g, m, v in zip(params, grads, adam_state.mu,
                                      adam_state.nu)]
        if not norm:
            return state
        return state, sum(sums, torch.zeros((), dtype=torch.float64,
                                            device=count.device))

    return fused


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
         moment_dtype=torch.float32, inject_lr: bool = False
         ) -> GradientTransformation:
    init, update, _ = chain(scale_by_adam(b1, b2, eps, moment_dtype),
                            _scale_by_lr(learning_rate, inject=inject_lr))
    fused = (None if callable(learning_rate)
             else _fused_adam(b1, b2, eps, 0.0, learning_rate, inject_lr))
    return GradientTransformation(init, update, fused)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
          moment_dtype=torch.float32, inject_lr: bool = False
          ) -> GradientTransformation:
    """AdamW (decoupled weight decay), the paper's default optimizer.

    ``moment_dtype=torch.bfloat16`` halves optimizer-state memory (updates
    still computed in float32). ``inject_lr=True`` keeps the lr in the
    optimizer state (see :class:`InjectLRState`). A schedule for
    ``learning_rate`` runs the chain only: it has no fused pass."""
    init, update, _ = chain(scale_by_adam(b1, b2, eps, moment_dtype),
                            add_decayed_weights(weight_decay),
                            _scale_by_lr(learning_rate, inject=inject_lr))
    fused = (None if callable(learning_rate)
             else _fused_adam(b1, b2, eps, weight_decay, learning_rate,
                              inject_lr))
    return GradientTransformation(init, update, fused)


class ScaleByAdagradState(NamedTuple):
    accum: Tensors


def adagrad(learning_rate, eps=1e-10, initial_accumulator=0.1
            ) -> GradientTransformation:
    def init(params):
        return ScaleByAdagradState(
            [torch.full_like(p, initial_accumulator, dtype=torch.float32)
             for p in params])

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        grads = [g.float() for g in grads]
        accum = [a + g * g for a, g in zip(state.accum, grads)]
        updates = [g / (torch.sqrt(a) + eps) for g, a in zip(grads, accum)]
        return updates, ScaleByAdagradState(accum)

    return chain(GradientTransformation(init, update),
                 _scale_by_lr(learning_rate))


class TraceState(NamedTuple):
    trace: Tensors


def sgd(learning_rate, momentum: float = 0.0, nesterov: bool = False
        ) -> GradientTransformation:
    if momentum == 0.0:
        return _scale_by_lr(learning_rate)

    def init(params):
        return TraceState([torch.zeros_like(p, dtype=torch.float32)
                           for p in params])

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        grads = [g.float() for g in grads]
        trace = [t * momentum + g for t, g in zip(state.trace, grads)]
        if nesterov:
            updates = [t * momentum + g for t, g in zip(trace, grads)]
        else:
            updates = trace
        return updates, TraceState(trace)

    return chain(GradientTransformation(init, update),
                 _scale_by_lr(learning_rate))


class InjectLRState(NamedTuple):
    """Learning rate carried as optimizer *state* instead of a baked-in
    constant (optax.inject_hyperparams): a float32 0-d tensor on the
    parameters' device, which the fused ``adamw`` kernel reads there, so
    :func:`set_injected_lr` retunes a run between steps (captured ones
    too: it writes into this tensor)."""
    lr: torch.Tensor


def inject_lr(learning_rate: float) -> GradientTransformation:
    """Like ``scale(-learning_rate)`` but with the lr as a state leaf."""
    if callable(learning_rate):
        raise ValueError("inject_lr takes a constant, not a schedule — "
                         "compose scale_by_schedule for scheduled lrs")

    def init(params):
        return InjectLRState(lr=torch.full((), learning_rate,
                                           dtype=torch.float32,
                                           device=_device(params)))

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        neg = -state.lr
        return [g * neg for g in grads], state

    return GradientTransformation(init, update)


def _map_state(node, fn):
    """``node`` with ``fn`` applied to every InjectLRState in it (tuples,
    named tuples, lists and dicts are walked, dict keys in sorted order as
    JAX's tree utilities walk them)."""
    if isinstance(node, InjectLRState):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_state(node[k], fn) for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_state(x, fn) for x in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_map_state(x, fn) for x in node)
    return node


def set_injected_lr(opt_state, lr):
    """Write ``lr`` into every :class:`InjectLRState` of ``opt_state``, in
    place, and return ``opt_state``: a step captured in a CUDA graph reads
    the lr at the tensor's address, so the tensor is kept and refilled.

    Raises if the optimizer was not built with ``inject_lr=True``:
    silently returning the input would quietly train at the constructor
    lr."""
    found = []
    _map_state(opt_state, lambda node: found.append(node) or node)
    if not found:
        raise ValueError(
            "optimizer state has no InjectLRState — build the optimizer "
            "with inject_lr=True (e.g. optim.adamw(lr, inject_lr=True)) "
            "to set per-run learning rates")
    value = float(np.asarray(lr, np.float32))
    for node in found:
        node.lr.fill_(value)
    return opt_state


def get_injected_lr(opt_state):
    """The lr tensor of the first InjectLRState in ``opt_state``, or None."""
    found = []
    _map_state(opt_state, lambda node: found.append(node) or node)
    return found[0].lr if found else None


def _scale_by_lr(learning_rate, inject: bool = False
                 ) -> GradientTransformation:
    if inject:
        return inject_lr(learning_rate)
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


class AccumulatorState(NamedTuple):
    step: int          # microbatches seen, on the host
    acc: Tensors
    inner: Any


def accumulate_gradients(inner: GradientTransformation, every: int
                         ) -> GradientTransformation:
    """Gradient accumulation: apply ``inner`` once per ``every``
    microbatches, to their mean gradient. The microbatch count is a host
    integer, so the host picks the branch that JAX's ``lax.cond`` picks on
    the device; the other steps return zero updates."""
    def init(params):
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AccumulatorState(0, acc, inner.init(params))

    @torch.no_grad()
    def update(grads, state, params=None):
        acc = [a + g.float() for a, g in zip(state.acc, grads)]
        count = state.step + 1
        if count % every == 0:
            updates, inner_state = inner.update([a / every for a in acc],
                                                state.inner, params)
            return updates, AccumulatorState(
                count, [torch.zeros_like(a) for a in acc], inner_state)
        return ([torch.zeros_like(a) for a in acc],
                AccumulatorState(count, acc, state.inner))

    return GradientTransformation(init, update)
