"""Plain reference of the user browsing model (UBM; Dupret and Piwowarski
2008; CLAX paper Eq. 25-26), in probability space.

gamma_k = sigmoid(attraction row + baseline); theta[r, k'] =
sigmoid(examination logit) is the probability that rank r (1-based, row
r - 1) is examined when the last click above it was at rank k' (0: none).

* P(C_r = 1 | c_<r) = theta[r, k'] gamma_r, with k' the last clicked
  rank above r.
* P(C_r = 1) sums over every k' < r: P(the last click above r is at k')
  theta[r, k'] gamma_r, where that path's weight is P(C_k' = 1) (1 for
  k' = 0) times the product over the ranks j between k' and r of
  (1 - theta[j, k'] gamma_j).
"""
from __future__ import annotations

import torch


def _gamma(p):
    return torch.sigmoid(p["attraction/table"] + p["attraction/baseline"])


def conditional_nll(p, batch):
    gamma = _gamma(p)
    theta = torch.sigmoid(p["examination/table"])
    clicks = batch["clicks"].to(gamma.dtype)
    ranks = batch["positions"].long()
    last = torch.zeros_like(ranks[:, 0])
    ll = []
    for k in range(gamma.shape[1]):
        prob = theta[ranks[:, k] - 1, last] * gamma[:, k]
        c = clicks[:, k]
        ll.append(c * torch.log(prob) + (1 - c) * torch.log1p(-prob))
        last = torch.where(c > 0, ranks[:, k], last)
    mask = batch["mask"].to(gamma.dtype)
    return -(torch.stack(ll, dim=1) * mask).sum() / mask.sum().clamp_min(1)


def marginal_log_clicks(p, batch):
    gamma = _gamma(p)
    theta = torch.sigmoid(p["examination/table"])
    K = gamma.shape[1]
    clicked = []  # clicked[r] = P(C_{r+1} = 1), ranks 0-based here
    for r in range(K):
        total = torch.zeros_like(gamma[:, 0])
        for kp in range(r + 1):  # last click above at 1-based rank kp
            path = torch.ones_like(total) if kp == 0 else clicked[kp - 1]
            for j in range(kp, r):
                path = path * (1 - theta[j, kp] * gamma[:, j])
            total = total + path * theta[r, kp] * gamma[:, r]
        clicked.append(total)
    return torch.log(torch.stack(clicked, dim=1))
