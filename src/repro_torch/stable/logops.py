"""Numerically stable log-space primitives (paper §5), in PyTorch.

Counterpart of ``repro.stable.logops``: products become sums, complements
use the Mächler [2012] piecewise log1mexp, and logits map to
log-probabilities via stable log-sigmoid (Eq. 17). Every function keeps the
JAX version's formula and its NaN guards, so values and gradients agree
with it to float32 rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# exp(-13.8) ~= 1e-6: the floor for "impossible" events (Appendix A.5).
MIN_LOG_PROB = -13.815510557964274

_LOG2 = math.log(2.0)


# JAX's derivatives at kinks, which torch's clamp and abs do not share:
# d|x|/dx = +1 at x = 0 (torch: 0), and min/max split the gradient 1/2 at a
# tie (torch's clamp gives all of it to the input). Logits that start at
# exactly 0 (unbaselined tables) sit on these kinks, so the port uses these
# three wherever a gradient flows.

def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x|, with the derivative +1 at x = 0 as jnp.abs has."""
    return torch.where(x >= 0, x, -x)


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.minimum(x, c) for a constant c: half the gradient at a tie."""
    return torch.minimum(x, x.new_full((), c))


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c) for a constant c: half the gradient at a tie."""
    return torch.maximum(x, x.new_full((), c))


def log1mexp(a: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(a)) for a <= 0, Mächler's piecewise form (paper Eq. 18).

    Switches at -log(2); both branches see a guarded input, so neither
    produces a NaN that ``where`` would pass into the gradient.
    """
    a = minimum(a, 0.0)
    near_zero = a > -_LOG2
    b1 = torch.log(-torch.expm1(torch.where(near_zero, a, -_LOG2)))
    b2 = torch.log1p(-torch.exp(torch.where(near_zero, -_LOG2, a)))
    return torch.where(near_zero, b1, b2)


def log_expm1(a: torch.Tensor) -> torch.Tensor:
    """log(exp(a) - 1) for a > 0 (softplus inverse), stable for large a."""
    return a + log1mexp(-a)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x)) = -softplus(-x) (paper Eq. 17)."""
    return -F.softplus(-x)


def sigmoid_core(x: torch.Tensor):
    """(e, t, pos) with e = exp(-|x|), t = 1/(1+e), pos = x >= 0: the pieces
    every sigmoid-family quantity derives from."""
    e = torch.exp(-absolute(x))
    return e, 1.0 / (1.0 + e), x >= 0


def sigmoid_parts(x: torch.Tensor):
    """(sigma(x), sigma(-x), log sigma(x), log sigma(-x)) from one exp and
    one log1p; the complement is sigma(-x), never 1 - sigma(x)."""
    e, t, pos = sigmoid_core(x)
    p = torch.where(pos, t, e * t)
    p_not = torch.where(pos, e * t, t)
    l = torch.log1p(e)
    log_p = minimum(x, 0.0) - l
    log_p_not = -maximum(x, 0.0) - l
    return p, p_not, log_p, log_p_not


def log1m_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(1 - sigmoid(x)) = -softplus(x) (paper Eq. 17)."""
    return -F.softplus(x)


def logsumexp(a: torch.Tensor, axis=None, where=None,
              keepdims: bool = False) -> torch.Tensor:
    """Max-shifted, mask-aware log-sum-exp (paper Eq. 16).

    ``where=False`` entries contribute nothing. A fully masked reduction
    gives -inf with a zero (not NaN) gradient.
    """
    if where is not None:
        a = torch.where(where, a, -math.inf)
    dims = tuple(range(a.dim())) if axis is None else axis
    a_max = torch.amax(a, dim=dims, keepdim=True)
    shift = torch.where(torch.isfinite(a_max), a_max, 0.0)
    total = torch.sum(torch.exp(a - shift), dim=dims, keepdim=True)
    empty = total == 0.0
    out = torch.where(empty, -math.inf,
                      torch.log(torch.where(empty, 1.0, total)) + shift)
    if not keepdims:
        out = torch.squeeze(out, dim=dims) if dims != () else out
    return out


def _pos_inf_to_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == math.inf, 0.0, x)


class _LogAddExp(torch.autograd.Function):
    """jnp.logaddexp with its custom JVP (jax/_src/lax/other.py): d/da =
    exp(a - out) with +inf replaced by 0, so an impossible event (-inf) gets
    a zero gradient and +inf inputs stay finite. As in JAX, the gradient at
    (-inf, -inf) is NaN."""

    @staticmethod
    def forward(ctx, a, b):
        amax = torch.maximum(a, b)
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b,
                          amax + torch.log1p(torch.exp(-torch.abs(delta))))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        o = _pos_inf_to_zero(out)
        return (g * torch.exp(_pos_inf_to_zero(a) - o),
                g * torch.exp(_pos_inf_to_zero(b) - o))


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise log(exp(a) + exp(b)) with jnp.logaddexp's gradient."""
    a, b = torch.broadcast_tensors(a, b)
    return _LogAddExp.apply(a, b)


def exclusive_cumsum(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """out_k = sum_{m<k} a_m along ``axis``; out_0 is exactly 0."""
    incl = torch.cumsum(a, dim=axis)
    n = a.shape[axis]
    head = torch.zeros_like(incl.narrow(axis, 0, 1))
    return torch.cat([head, incl.narrow(axis, 0, n - 1)], dim=axis)


def log_cumsum(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Running log-sum-exp along ``axis``."""
    return torch.logcumsumexp(a, dim=axis)


def log_not(log_p: torch.Tensor) -> torch.Tensor:
    """log(1 - p) from log(p)."""
    return log1mexp(log_p)


def log_or(log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """log(p + q - p*q) for independent events."""
    return log1mexp(log1mexp(log_p) + log1mexp(log_q))


def log_bce(log_p: torch.Tensor, clicks: torch.Tensor) -> torch.Tensor:
    """Per-element Bernoulli NLL from log-probabilities:
    -[c log p + (1-c) log(1-p)], with log(1-p) via log1mexp."""
    clicks = clicks.to(log_p.dtype)
    return -(clicks * log_p + (1.0 - clicks) * log1mexp(log_p))


def logit_to_log_prob(x: torch.Tensor) -> torch.Tensor:
    """Alias of log_sigmoid."""
    return log_sigmoid(x)


def log_prob_to_logit(log_p: torch.Tensor) -> torch.Tensor:
    """Inverse sigmoid in log-space: logit = log_p - log(1-p)."""
    return log_p - log1mexp(log_p)
