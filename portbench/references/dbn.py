"""Plain reference of the dynamic Bayesian network (DBN; Chapelle and
Zhang 2009; CLAX paper Eq. 31-32), position by position in probability
space.

gamma_k = sigmoid(attraction row + baseline), sigma_k likewise from the
satisfaction table, lambda = sigmoid(continuation). With eps_k the
probability that rank k is examined given the clicks above it:

* P(C_k = 1 | c_<k) = eps_k gamma_k, eps_1 = 1;
* after a click: eps_{k+1} = lambda (1 - sigma_k);
* after a skip:  eps_{k+1} = lambda eps_k (1 - gamma_k) / (1 - eps_k gamma_k).

Unconditionally, eps_{k+1} = eps_k lambda (1 - gamma_k sigma_k).
"""
from __future__ import annotations

import torch


def _parts(p):
    gamma = torch.sigmoid(p["attraction/table"] + p["attraction/baseline"])
    sigma = torch.sigmoid(p["satisfaction/table"]
                          + p["satisfaction/baseline"])
    lam = torch.sigmoid(p["continuation/value"])
    return gamma, sigma, lam


def conditional_nll(p, batch):
    gamma, sigma, lam = _parts(p)
    clicks = batch["clicks"].to(gamma.dtype)
    eps = torch.ones_like(gamma[:, 0])
    ll = []
    for k in range(gamma.shape[1]):
        prob = eps * gamma[:, k]
        c = clicks[:, k]
        ll.append(c * torch.log(prob) + (1 - c) * torch.log1p(-prob))
        eps = torch.where(c > 0, lam * (1 - sigma[:, k]),
                          lam * eps * (1 - gamma[:, k]) / (1 - prob))
    mask = batch["mask"].to(gamma.dtype)
    return -(torch.stack(ll, dim=1) * mask).sum() / mask.sum().clamp_min(1)


def marginal_log_clicks(p, batch):
    gamma, sigma, lam = _parts(p)
    eps = torch.ones_like(gamma[:, 0])
    out = []
    for k in range(gamma.shape[1]):
        out.append(torch.log(eps * gamma[:, k]))
        eps = eps * lam * (1 - gamma[:, k] * sigma[:, k])
    return torch.stack(out, dim=1)
