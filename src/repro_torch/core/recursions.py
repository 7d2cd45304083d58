"""Vectorized log-space examination recursions for chain click models.

Port of ``repro.core.recursions`` (see its docstring for the derivation).
The marginal chain is an exclusive cumsum of per-position log continuation
factors; the conditional chain is one affine recurrence in death-odds space,
z_k = a_k z_{k-1} + b_k, saturated at ``ODDS_CAP``.

torch has no ``associative_scan``, so the plain solve is a Hillis-Steele
doubling scan (ceil(log2 K) rounds of tensor ops) with the capped combine of
the JAX version: ``(min(a1 a2, GROWTH_CAP), clamp(a2 b1 + b2))``. The caps
make every combination tree agree on saturated spans, and un-saturated spans
agree up to rounding. The saturating custom VJP becomes
:class:`_AffineScan`, a ``torch.autograd.Function``. UBM's marginal
(``ubm_marginal_clicks``) is one batched unit-triangular solve.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.stable import (exclusive_cumsum, maximum, minimum,
                                sigmoid_parts)

# Saturation bounds, identical to repro.core.recursions:81-83 (the bound
# derivation is documented there). The examination_nll kernels saturate
# with exactly these values.
ODDS_CAP = 1e9
ODDS_FLOOR = 1e-9
GROWTH_CAP = 1e28


def marginal_examination(log_cont: torch.Tensor) -> torch.Tensor:
    """(B, K) log eps from per-position log continuation factors
    (log eps_1 = 0)."""
    return exclusive_cumsum(log_cont, axis=1)


def affine_scan_plain(a: torch.Tensor, b: torch.Tensor,
                      signed_b: bool = False) -> torch.Tensor:
    """Capped inclusive solve of z_k = a_k z_{k-1} + b_k (z_{-1} = 0) along
    axis 1. ``a`` must be non-negative; ``b`` too unless ``signed_b`` (the
    reverse pass, whose cotangents saturate two-sided)."""
    k = a.shape[1]
    off = 1
    while off < k:
        # Each round folds the prefix `off` positions back; positions below
        # the offset combine with the identity (a=1, b=0).
        a_sh = F.pad(a[:, :k - off], (off, 0), value=1.0)
        b_sh = F.pad(b[:, :k - off], (off, 0), value=0.0)
        b = a * b_sh + b
        b = (torch.clamp(b, -ODDS_CAP, ODDS_CAP) if signed_b
             else torch.clamp_max(b, ODDS_CAP))
        a = torch.clamp_max(a * a_sh, GROWTH_CAP)
        off *= 2
    return b


class _AffineScan(torch.autograd.Function):
    """Capped affine recurrence with the saturating VJP of
    ``repro.core.recursions._affine_scan``: saturated outputs get a zero
    cotangent, and the reverse recurrence u_k = cot_k + a_{k+1} u_{k+1} runs
    through the same capped scan, so out-of-domain gradients stay finite."""

    @staticmethod
    def forward(ctx, a, b):
        z = affine_scan_plain(a, b)
        ctx.save_for_backward(a, z)
        return z

    @staticmethod
    def backward(ctx, cot):
        a, z = ctx.saved_tensors
        cot = torch.where(z >= ODDS_CAP, 0.0, cot)
        a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        u = affine_scan_plain(a_next.flip(1), cot.flip(1),
                              signed_b=True).flip(1)
        z_prev = F.pad(z[:, :-1], (1, 0))
        return u * z_prev, u


def conditional_examination(clicks, p_skip_survive, p_death, p_reset,
                            p_reset_not) -> torch.Tensor:
    """Closed-form log P(E_k=1 | c_<k) = -log1p(r_k) for generalized cascade
    chains; arguments (all (B, K)) are in probability space."""
    return -torch.log1p(conditional_examination_odds(
        clicks, p_skip_survive, p_death, p_reset, p_reset_not))


def conditional_examination_odds(clicks, p_skip_survive, p_death, p_reset,
                                 p_reset_not) -> torch.Tensor:
    """Death odds r_k = (1 - eps_k) / eps_k of ``conditional_examination``.

    after a skip at k:  r_{k+1} = (r_k + p_death_k) / p_skip_survive_k
    after a click at k: r_{k+1} = p_reset_not_k / p_reset_k
    """
    clicked = (clicks > 0).to(p_skip_survive.dtype)
    keep = 1.0 - clicked
    inv_s = keep / maximum(p_skip_survive, ODDS_FLOOR)
    reset_odds = p_reset_not / maximum(p_reset, ODDS_FLOOR)
    b = minimum(inv_s * p_death + clicked * reset_odds, ODDS_CAP)
    z = _AffineScan.apply(inv_s, b)
    # z_k = r_{k+1}: shift right once (r_0 = 0, the virtual sure-reset).
    return F.pad(z[:, :-1], (1, 0))


def ubm_marginal_clicks(attr_logits: torch.Tensor,
                        exam_logits: torch.Tensor) -> torch.Tensor:
    """Vectorized UBM Eq. 26: log P(C_r=1) marginalized over last-click
    paths.

    attr_logits: (B, K) attraction logits. exam_logits: (K, K) or (B, K, K)
    examination logits theta[rank, last click], column 0 = no previous
    click, column q+1 = last click at 0-based rank q. Returns (B, K) log
    click probabilities.
    """
    b, k = attr_logits.shape
    g, gn, log_attr, _ = sigmoid_parts(attr_logits)
    _, th_not, log_exam, _ = sigmoid_parts(exam_logits)
    if exam_logits.dim() == 2:
        th_not = th_not[None]
        log_exam = log_exam[None].expand(b, k, k)
    # log(1 - theta_{j,i} gamma_j) as the stable positive sum
    # (1-gamma) + gamma (1-theta).
    lg_no_click = torch.log(gn[:, :, None] + g[:, :, None] * th_not)
    # Exclusive cumulative sum over rank j as one strict-tril product.
    strict_tril = torch.tril(torch.ones(k, k, dtype=lg_no_click.dtype,
                                        device=lg_no_click.device), -1)
    ex_cs = torch.einsum("jm,bmi->bji", strict_tril, lg_no_click)

    # Source terms: no click before r, a skip run at column 0 from the top.
    log_t0 = ex_cs[:, :, 0] + log_exam[:, :, 0] + log_attr

    # Path weights W[r, q] (q < r): click at q, skip q+1..r-1 at column
    # q+1, then click at r. The skip run is ex_cs[r, q+1] - cs[q, q+1]; the
    # subtrahend is a diagonal of the inclusive sum ex_cs + lg, shifted one
    # column right.
    cs_diag = (torch.diagonal(ex_cs[:, :, 1:], dim1=1, dim2=2)
               + torch.diagonal(lg_no_click[:, :, 1:], dim1=1, dim2=2))
    cs_diag = F.pad(cs_diag, (0, 1))                              # (B, K)
    log_w = (ex_cs[:, :, 1:] - cs_diag[:, None, :-1]
             + log_exam[:, :, 1:] + log_attr[:, :, None])         # (B, K, K-1)
    log_w = F.pad(log_w, (0, 1), value=-math.inf)

    idx = torch.arange(k, device=attr_logits.device)
    tri = (idx[:, None] > idx[None, :])[None]                     # q < r
    # Both wheres stay: the inner one keeps exp's gradient out of the
    # masked entries (log_w is -inf or a difference of -infs there).
    w = torch.where(tri, torch.exp(torch.where(tri, log_w, -math.inf)), 0.0)

    # lu = T0 + W @ lu with strictly lower-triangular W: one batched
    # unit-triangular solve. It runs in probability space, so sessions past
    # float32's exp range saturate; flooring at tiny keeps the log finite
    # and its gradient zero.
    eye = torch.eye(k, dtype=w.dtype, device=w.device)[None]
    lu = torch.linalg.solve_triangular(eye - w, torch.exp(log_t0)[:, :, None],
                                       upper=False, unitriangular=True)
    return torch.log(maximum(lu[:, :, 0], torch.finfo(lu.dtype).tiny))
