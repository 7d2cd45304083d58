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
:class:`_AffineScan`, a ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.stable import exclusive_cumsum, maximum, minimum

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
