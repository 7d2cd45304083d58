"""Plain-torch oracles of the two ported loss kernels (port of
``repro.kernels.ref``: ``session_nll_ref`` and ``examination_nll_ref``).

Each is the literal composition the fused kernel replaces, with no
performance tricks. ``examination_nll_ref`` is also what the public
``examination_nll`` differentiates in its backward pass, so it goes through
the saturating ``_AffineScan`` autograd Function of ``core.recursions``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.recursions import conditional_examination_odds
from repro_torch.stable import absolute, log_bce, minimum


def session_nll_ref(logits, clicks, mask) -> torch.Tensor:
    """Masked-mean Bernoulli click NLL from logits, as the log_sigmoid ->
    log(1 - sigmoid) -> BCE -> masked-mean composition. fp32 scalar."""
    x = logits.float()
    c = clicks.float()
    m = mask.float()
    log_p = -F.softplus(-x)
    log_1mp = -F.softplus(x)
    nll = -(c * log_p + (1.0 - c) * log_1mp)
    return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)


def examination_nll_ref(attr_logits, clicks, mask, p_skip_survive, p_death,
                        p_reset, p_reset_not) -> torch.Tensor:
    """Masked-mean conditional click NLL of the examination-chain models:

        r     = conditional_examination_odds(clicks, ...)   (capped scan)
        log_p = min(x, 0) - log1p(r + e + r*e)              (e = exp(-|x|))
        nll   = log_bce(log_p, clicks);  loss = masked mean
    """
    x = attr_logits.float()
    c = clicks.float()
    m = mask.float()
    e = torch.exp(-absolute(x))
    r = conditional_examination_odds(c, p_skip_survive, p_death, p_reset,
                                     p_reset_not)
    log_p = minimum(x, 0.0) - torch.log1p(r + e + r * e)
    nll = log_bce(log_p, c)
    return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
