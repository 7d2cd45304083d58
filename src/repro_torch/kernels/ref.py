"""Plain-torch oracles of the ported kernels (port of ``repro.kernels.ref``:
``embedding_bag_ref``, ``fm_interaction_ref``, ``dcn_cross_ref``,
``flash_attention_ref``, ``session_nll_ref`` and ``examination_nll_ref``).

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


def embedding_bag_ref(table, ids, weights) -> torch.Tensor:
    """out[b] = sum_l weights[b,l] * table[ids[b,l]]; ids < 0 are padding.
    table (N, D), ids and weights (B, L) -> (B, D) float32."""
    gathered = table[torch.clamp_min(ids, 0).long()]          # (B, L, D)
    w = torch.where(ids >= 0, weights, 0.0).float()
    return torch.einsum("bld,bl->bd", gathered.float(), w)


def fm_interaction_ref(v) -> torch.Tensor:
    """0.5 * sum_d[(sum_f v)^2 - sum_f v^2]: (B, F, D) -> (B,) float32."""
    vf = v.float()
    sum_sq = torch.square(torch.sum(vf, dim=1))
    sq_sum = torch.sum(torch.square(vf), dim=1)
    return 0.5 * torch.sum(sum_sq - sq_sum, dim=-1)


def dcn_cross_ref(x0, x, w, b) -> torch.Tensor:
    """DCN-V2 cross layer y = x0 * (x @ W + b) + x. x0, x (B, D), w (D, D),
    b (D,) -> (B, D) float32."""
    xf = x.float()
    return x0.float() * (xf @ w.float() + b.float()) + xf


def flash_attention_ref(q, k, v, causal=False, scale=None) -> torch.Tensor:
    """Softmax attention with GQA head groups, K/V repeated per group.
    q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh) -> q's shape and type."""
    Dh = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    kq = torch.repeat_interleave(k, group, dim=1).float()
    vq = torch.repeat_interleave(v, group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    if causal:
        Sq, Skv = q.shape[2], k.shape[2]
        mask = torch.ones(Sq, Skv, dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vq).to(q.dtype)


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
