"""EM / MLE reference optimizers (the PyClick-style baselines of §3 & §7),
port of ``repro.core.em``.

These full-batch estimators are what CLAX replaces with SGD: correctness
oracles (gradient training must reach the same fit) and the speed baseline
of the paper's Figure 1. They consume flat padded arrays: positions (B, K)
1-based, doc ids (B, K), clicks (B, K), mask (B, K), as numpy arrays or
tensors (the result lies on the device of the tensors given). Fitted
probabilities go into the matching click model through the
``*_params_from_*`` injectors, which return the JAX-shaped parameter tree
that :func:`repro_torch.convert.load_jax_params` loads, so both pipelines
share evaluation code.

``jax.ops.segment_sum`` becomes ``index_add_`` (ids outside the segments
are dropped, as there). On CUDA ``index_add_`` sums with atomics, so a fit
on the card does not repeat its own bits; on the CPU it sums in order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

EPS = 1e-8


def to_logits(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, EPS, 1.0 - EPS)
    return torch.log(p) - torch.log1p(-p)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int):
    """``jax.ops.segment_sum(data, ids, num_segments=n)``: ids outside
    [0, n) contribute nothing."""
    inside = (ids >= 0) & (ids < n)
    out = torch.zeros(n, dtype=data.dtype, device=data.device)
    return out.index_add_(0, torch.where(inside, ids, 0),
                          torch.where(inside, data, 0.0))


def _flatten(batch):
    pos = _tensor(batch["positions"]).reshape(-1).long() - 1  # 0-based
    docs = _tensor(batch["query_doc_ids"]).reshape(-1).long()
    clicks = _tensor(batch["clicks"]).reshape(-1).float()
    mask = _tensor(batch["mask"]).reshape(-1).float()
    return pos, docs, clicks, mask


# ---------------------------------------------------------------------------
# MLE (counting) estimators for CTR models — PyClick's fast path.
# ---------------------------------------------------------------------------

def fit_gctr(batch) -> torch.Tensor:
    _, _, clicks, mask = _flatten(batch)
    return torch.sum(clicks * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def fit_rctr(batch, positions: int) -> torch.Tensor:
    pos, _, clicks, mask = _flatten(batch)
    num = _segment_sum(clicks * mask, pos, positions)
    den = _segment_sum(mask, pos, positions)
    return num / torch.clamp_min(den, 1.0)


def fit_dctr(batch, n_docs: int, prior: float = 0.5,
             prior_weight: float = 0.0) -> torch.Tensor:
    """Per-document CTR with optional Beta-prior smoothing."""
    _, docs, clicks, mask = _flatten(batch)
    num = _segment_sum(clicks * mask, docs, n_docs)
    den = _segment_sum(mask, docs, n_docs)
    return (num + prior * prior_weight) / torch.clamp_min(den + prior_weight,
                                                          EPS)


def fit_sdbn_mle(batch, n_docs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDBN MLE counting (PyClick's fast path): within each session, items at
    or before the LAST click are certainly examined, so
      attractiveness_d = clicks(d) / impressions-at-or-before-last-click(d)
      satisfaction_d   = last-clicks(d) / clicks(d).
    Returns (gamma[n_docs], sigma[n_docs])."""
    positions = _tensor(batch["positions"])
    clicks = _tensor(batch["clicks"]).float()
    mask = _tensor(batch["mask"]).float()
    docs = _tensor(batch["query_doc_ids"]).reshape(-1).long()
    clicked_rank = torch.where(clicks > 0, positions, 0)
    last_rank = torch.amax(clicked_rank, dim=1, keepdim=True)  # (B, 1)
    examined = ((positions <= last_rank) & (last_rank > 0)).float()
    examined = (examined * mask).reshape(-1)
    c = (clicks * mask).reshape(-1)
    is_last = ((clicked_rank == last_rank) & (clicks > 0)).float()
    is_last = (is_last * mask).reshape(-1)
    imp = _segment_sum(examined, docs, n_docs)
    clk = _segment_sum(c, docs, n_docs)
    lst = _segment_sum(is_last, docs, n_docs)
    return clk / torch.clamp_min(imp, 1.0), lst / torch.clamp_min(clk, 1.0)


def sdbn_params_from_mle(gamma, sigma) -> Dict:
    return {"attraction": {"table": to_logits(gamma)[:, None]},
            "satisfaction": {"table": to_logits(sigma)[:, None]}}


# ---------------------------------------------------------------------------
# PBM expectation-maximization (paper Eqs. 3-6).
# ---------------------------------------------------------------------------

def _em_posteriors(th, ga, clicks):
    """E-step (Eqs. 3-4): P(E=1 | c) and P(A=1 | c) of each item."""
    denom = torch.clamp_min(1.0 - th * ga, EPS)
    e_hat = clicks + (1.0 - clicks) * th * (1.0 - ga) / denom
    a_hat = clicks + (1.0 - clicks) * ga * (1.0 - th) / denom
    return e_hat, a_hat


def _pbm_em_iteration(theta, gamma, pos, docs, clicks, mask, positions,
                      n_docs):
    e_hat, a_hat = _em_posteriors(theta[pos], gamma[docs], clicks)
    # M-step (Eq. 6)
    theta_new = (_segment_sum(e_hat * mask, pos, positions)
                 / torch.clamp_min(_segment_sum(mask, pos, positions), EPS))
    gamma_new = (_segment_sum(a_hat * mask, docs, n_docs)
                 / torch.clamp_min(_segment_sum(mask, docs, n_docs), EPS))
    return theta_new, gamma_new


def fit_pbm_em(batch, positions: int, n_docs: int, n_iters: int = 50,
               init: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (theta[positions], gamma[n_docs]) in probability space."""
    pos, docs, clicks, mask = _flatten(batch)
    theta = torch.full((positions,), init, device=clicks.device)
    gamma = torch.full((n_docs,), init, device=clicks.device)
    for _ in range(n_iters):
        theta, gamma = _pbm_em_iteration(theta, gamma, pos, docs, clicks,
                                         mask, positions, n_docs)
    return theta, gamma


# ---------------------------------------------------------------------------
# UBM expectation-maximization. E-step conditions on the observed last click
# (standard Chuklin et al. derivation); theta is indexed by the pair
# (rank k, last-click rank k') with k' = 0 meaning "no previous click".
# ---------------------------------------------------------------------------

def _last_click_flat(batch):
    clicks = _tensor(batch["clicks"])
    positions = _tensor(batch["positions"])
    clicked_rank = torch.where(clicks > 0, positions, 0)
    cummax = torch.cummax(clicked_rank, dim=1).values
    exclusive = torch.cat([torch.zeros_like(cummax[:, :1]), cummax[:, :-1]],
                          dim=1)
    return exclusive.reshape(-1)  # 1-based rank of last click, 0 = none


def _ubm_em_iteration(theta, gamma, pair_idx, docs, clicks, mask, positions,
                      n_docs):
    e_hat, a_hat = _em_posteriors(theta.reshape(-1)[pair_idx], gamma[docs],
                                  clicks)
    n_pairs = positions * positions
    counts = _segment_sum(mask, pair_idx, n_pairs)
    theta_new = (_segment_sum(e_hat * mask, pair_idx, n_pairs)
                 / torch.clamp_min(counts, EPS))
    # Unobserved (k, k') pairs keep their previous value instead of collapsing.
    theta_new = torch.where(counts > 0, theta_new, theta.reshape(-1))
    gamma_new = (_segment_sum(a_hat * mask, docs, n_docs)
                 / torch.clamp_min(_segment_sum(mask, docs, n_docs), EPS))
    return theta_new.reshape(positions, positions), gamma_new


def fit_ubm_em(batch, positions: int, n_docs: int, n_iters: int = 50,
               init: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (theta[K, K] indexed [rank-1, last-click-rank], gamma[n_docs])."""
    pos, docs, clicks, mask = _flatten(batch)
    last = _last_click_flat(batch).long()
    pair_idx = pos * positions + torch.clamp(last, 0, positions - 1)
    theta = torch.full((positions, positions), init, device=clicks.device)
    gamma = torch.full((n_docs,), init, device=clicks.device)
    for _ in range(n_iters):
        theta, gamma = _ubm_em_iteration(theta, gamma, pair_idx, docs, clicks,
                                         mask, positions, n_docs)
    return theta, gamma


# ---------------------------------------------------------------------------
# Injection helpers: EM/MLE fits -> click-model parameter trees.
# ---------------------------------------------------------------------------

def pbm_params_from_em(theta, gamma) -> Dict:
    return {"attraction": {"table": to_logits(gamma)[:, None]},
            "examination": {"table": to_logits(theta)}}


def ubm_params_from_em(theta, gamma) -> Dict:
    return pbm_params_from_em(theta, gamma)


def dctr_params_from_mle(ctr) -> Dict:
    return {"attraction": {"table": to_logits(ctr)[:, None]}}


def rctr_params_from_mle(ctr) -> Dict:
    return {"theta": {"table": to_logits(ctr)}}


def gctr_params_from_mle(ctr) -> Dict:
    return {"rho": {"value": to_logits(ctr)}}
