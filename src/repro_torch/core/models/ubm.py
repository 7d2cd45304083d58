"""User browsing model (paper A.6): examination depends on (rank, last
click); port of ``repro.core.models.ubm``.

Conditional prediction is a table lookup (Eq. 25); unconditional prediction
marginalizes over all possible last-click positions (Eq. 26) with one
batched unit-triangular solve (``core.recursions.ubm_marginal_clicks``);
``predict_clicks_loop`` is the O(K^2) log-space recursion it replaced, kept
as its oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core.base import last_click_positions
from repro_torch.core.models.ctr import _bernoulli, _logit, _PartsModel
from repro_torch.core.parameterization import (EmbeddingParameterConfig,
                                               UBMExaminationParameter,
                                               build_parameter)
from repro_torch.core.recursions import ubm_marginal_clicks
from repro_torch.stable import log1mexp, log_sigmoid, logsumexp


class UserBrowsingModel(_PartsModel):
    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, examination=None, init_prob: float = 0.5,
                 device="cuda", seed: int = 0, **_):
        super().__init__()
        self.positions = positions
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=_logit(init_prob))
        if examination is None:
            examination = UBMExaminationParameter(positions, init_logit=2.0,
                                                  device=device)
        self.parts = torch.nn.ModuleDict({
            "attraction": build_parameter(attraction, device, seed),
            "examination": examination,
        })

    def _log_attr(self, batch):
        return log_sigmoid(self.parts["attraction"](batch))

    def predict_conditional_clicks(self, batch):
        """Eq. 25: log theta_{k,k'} + log gamma_d with the observed last
        click k'."""
        la = self._log_attr(batch)
        k_prime = last_click_positions(batch["clicks"], batch["positions"])
        logit_e = self.parts["examination"].logit(batch["positions"], k_prime)
        return log_sigmoid(logit_e) + la

    def predict_clicks(self, batch):
        """Eq. 26: marginalize over last-click paths."""
        return ubm_marginal_clicks(self.parts["attraction"](batch),
                                   self.parts["examination"].table)

    def predict_clicks_loop(self, batch):
        """The unrolled O(K^2) log-space recursion; the oracle of
        ``predict_clicks``."""
        la = self._log_attr(batch)                               # (B, K)
        lt = log_sigmoid(self.parts["examination"].table)        # (K, K)
        lt = lt[None].expand(la.shape[0], *lt.shape)   # [rank, last click]
        K = la.shape[1]
        # log(1 - theta_{j,i} gamma_j) for every (rank j, last-click i) pair
        lg_no_click = log1mexp(lt + la[:, :, None])              # (B, K, K)
        # cumulative over rank j (inclusive)
        cs = torch.cumsum(lg_no_click, dim=1)
        lu = []  # lu[r] = log P(C_r = 1)
        for r in range(K):
            # path i = 0: no click before r, a skip run at kp = 0
            run0 = cs[:, r - 1, 0] if r > 0 else torch.zeros_like(la[:, 0])
            terms = [run0 + lt[:, r, 0] + la[:, r]]
            # paths: last click at 0-based rank q (kp = q + 1)
            for q in range(r):
                kp = q + 1
                run = cs[:, r - 1, kp] - cs[:, q, kp]   # ranks q+1 .. r-1
                terms.append(lu[q] + run + lt[:, r, kp] + la[:, r])
            lu.append(logsumexp(torch.stack(terms, dim=-1), axis=-1))
        return torch.stack(lu, dim=1)

    def predict_relevance(self, batch):
        return self.parts["attraction"](batch)

    def sample(self, batch, generator):
        la = self._log_attr(batch)
        table_p = torch.exp(log_sigmoid(self.parts["examination"].table))
        attracted = _bernoulli(la, generator)
        exam_u = torch.rand(la.shape, generator=generator, device=la.device)
        B, K = la.shape
        last_click = torch.zeros(B, dtype=torch.int64, device=la.device)
        clicks, examined = [], []
        for r in range(K):
            e = (exam_u[:, r] < table_p[r][last_click]).float()
            c = e * attracted[:, r]
            last_click = torch.where(c > 0, r + 1, last_click)
            clicks.append(c)
            examined.append(e)
        clicks = torch.stack(clicks, dim=1) * batch["mask"].float()
        return {"clicks": clicks, "attraction": attracted,
                "examination": torch.stack(examined, dim=1)}
