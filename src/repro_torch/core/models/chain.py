"""Examination-chain models: DCM (A.7), CCM (A.8), DBN (A.9), SDBN; port of
``repro.core.models.chain``.

All share log P(C_k=1 | .) = log eps_k + log gamma_{d_k}. The marginal
chain eps is an exclusive cumsum of per-position log continuation factors;
the conditional chain is the capped death-odds recurrence of
``core.recursions``. ``compute_loss`` hands the raw attraction logits and
the probability-space factors to the fused ``examination_nll`` kernel.
The JAX ``*_scan`` oracles and ``sample`` stay on the JAX side.
"""
from __future__ import annotations

import torch

from repro_torch.core.models.ctr import _logit, _PartsModel
from repro_torch.core.parameterization import (EmbeddingParameterConfig,
                                               PositionParameter,
                                               ScalarParameter,
                                               ScalarParameterConfig,
                                               build_parameter)
from repro_torch.core.recursions import (conditional_examination_odds,
                                         marginal_examination)
from repro_torch.stable import (log_sigmoid, minimum, sigmoid_core,
                                sigmoid_parts)


class _ChainModel(_PartsModel):
    """Shared vectorized prediction plumbing. Subclasses provide
    ``_marginal_log_cont`` (log f_k of the marginal chain) and
    ``_conditional_terms`` (p_skip_survive, p_death, p_reset, p_reset_not);
    both receive attraction gamma (g) and 1-gamma (gn)."""

    def _attr_logits(self, batch):
        return self.parts["attraction"](batch)

    def _attraction_probs(self, x):
        e, t, pos = sigmoid_core(x)
        g = torch.where(pos, t, e * t)
        gn = torch.where(pos, e * t, t)
        return e, g, gn

    def _marginal_log_cont(self, batch, g, gn):
        raise NotImplementedError

    def _conditional_terms(self, batch, g, gn):
        raise NotImplementedError

    def predict_clicks(self, batch):
        g, gn, la, _ = sigmoid_parts(self._attr_logits(batch))
        return marginal_examination(self._marginal_log_cont(batch, g, gn)) + la

    def compute_loss(self, batch):
        from repro_torch.kernels import examination_nll

        x = self._attr_logits(batch)
        _, g, gn = self._attraction_probs(x)
        clicks = batch["clicks"].float()
        terms = self._conditional_terms(batch, g, gn)
        return examination_nll(x, clicks, batch["mask"], *terms)

    def predict_conditional_clicks(self, batch):
        x = self._attr_logits(batch)
        # log eps + log gamma = -log1p(r) + min(x,0) - log1p(e) folds into
        # min(x,0) - log1p(r + e + r*e): one log1p for the whole path.
        e, g, gn = self._attraction_probs(x)
        clicks = batch["clicks"].float()
        r = conditional_examination_odds(
            clicks, *self._conditional_terms(batch, g, gn))
        return minimum(x, 0.0) - torch.log1p(r + e + r * e)

    def predict_relevance(self, batch):
        return self.parts["attraction"](batch)


class DependentClickModel(_ChainModel):
    """DCM: after a click, continue browsing with rank-dependent lambda_k."""

    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, continuation=None, init_prob: float = 0.5,
                 device="cuda", **_):
        super().__init__()
        self.positions = positions
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=_logit(init_prob))
        if continuation is None:
            continuation = PositionParameter(positions, init_logit=0.0,
                                             device=device)
        self.parts = torch.nn.ModuleDict({
            "attraction": build_parameter(attraction, device),
            "continuation": build_parameter(continuation, device),
        })

    def _continuation_parts(self, batch):
        """(lambda, 1-lambda) per position; for the rank table the sigmoids
        run on the (K,) table and the results are gathered."""
        cont = self.parts["continuation"]
        if isinstance(cont, PositionParameter):
            lam_t, lam_not_t, _, _ = sigmoid_parts(cont.table)
            return cont.gather(lam_t, batch), cont.gather(lam_not_t, batch)
        lam, lam_not, _, _ = sigmoid_parts(cont(batch))
        return lam, lam_not

    def _marginal_log_cont(self, batch, g, gn):
        """Eq. 27: f_k = gamma*lambda + (1-gamma)."""
        lam, _ = self._continuation_parts(batch)
        return torch.log(g * lam + gn)

    def _conditional_terms(self, batch, g, gn):
        """Eq. 28: click -> eps = lambda_k; skip -> Bayes posterior."""
        lam, lam_not = self._continuation_parts(batch)
        return gn, torch.zeros_like(gn), lam, lam_not


class ClickChainModel(_ChainModel):
    """CCM: three continuation scenarios tau_1/2/3 (Eq. 29-30)."""

    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, init_prob: float = 0.5,
                 tau_init=(0.7, 0.4, 0.2), device="cuda", **_):
        super().__init__()
        self.positions = positions
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=_logit(init_prob))
        parts = {"attraction": build_parameter(attraction, device)}
        for i, p in enumerate(tau_init, start=1):
            parts[f"tau_{i}"] = ScalarParameter(
                ScalarParameterConfig(init_prob=p), device)
        self.parts = torch.nn.ModuleDict(parts)

    def _tau_logits_raw(self):
        """0-d tau logits: transcendentals run on the scalar, broadcasting
        happens after."""
        return tuple(self.parts[f"tau_{i}"].value for i in (1, 2, 3))

    def _marginal_log_cont(self, batch, g, gn):
        """f_k = gamma*((1-gamma)tau2 + gamma*tau3) + (1-gamma)*tau1."""
        x1, x2, x3 = self._tau_logits_raw()
        inner = gn * torch.sigmoid(x2) + g * torch.sigmoid(x3)
        return torch.log(g * inner + gn * torch.sigmoid(x1))

    def _conditional_terms(self, batch, g, gn):
        """Click -> restart with gamma*tau3 + (1-gamma)*tau2; skip ->
        continue with tau1 before the Bayes update."""
        x1, x2, x3 = self._tau_logits_raw()
        t1, t1n, _, _ = sigmoid_parts(x1)
        t2, t2n, _, _ = sigmoid_parts(x2)
        t3, t3n, _, _ = sigmoid_parts(x3)
        return (gn * t1, gn * t1n, g * t3 + gn * t2, g * t3n + gn * t2n)


class DynamicBayesianNetwork(_ChainModel):
    """DBN (Eq. 31-32): separate attraction and satisfaction, global lambda."""

    fixed_continuation = False  # SDBN overrides

    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, satisfaction=None, init_prob: float = 0.5,
                 lambda_init: float = 0.9, device="cuda", **_):
        super().__init__()
        self.positions = positions
        logit = _logit(init_prob)
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=logit)
        if satisfaction is None:
            satisfaction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                    init_logit=logit)
        parts = {"attraction": build_parameter(attraction, device),
                 "satisfaction": build_parameter(satisfaction, device)}
        if not self.fixed_continuation:
            parts["continuation"] = ScalarParameter(
                ScalarParameterConfig(init_prob=lambda_init), device)
        self.parts = torch.nn.ModuleDict(parts)

    def _lambda_logit_raw(self):
        """0-d lambda logit, or None for SDBN (lambda = 1)."""
        if self.fixed_continuation:
            return None
        return self.parts["continuation"].value

    def _marginal_log_cont(self, batch, g, gn):
        """Eq. 31: f_k = lambda * (1 - gamma*sigma)."""
        x_sat = self.parts["satisfaction"](batch)
        # 1 - gamma*sigma = (1-gamma) + gamma*(1-sigma): a stable positive sum.
        no_sat = gn + g * torch.sigmoid(-x_sat)
        lam = self._lambda_logit_raw()
        if lam is None:
            return torch.log(no_sat)
        return torch.log(torch.sigmoid(lam) * no_sat)

    def _conditional_terms(self, batch, g, gn):
        """Eq. 32: click -> restart with lambda*(1-sigma); skip -> continue
        with lambda before the Bayes update."""
        sat, no_sat, _, _ = sigmoid_parts(self.parts["satisfaction"](batch))
        lam = self._lambda_logit_raw()
        if lam is None:
            return gn, torch.zeros_like(gn), no_sat, sat
        c, c_not, _, _ = sigmoid_parts(lam)
        return gn * c, gn * c_not, c * no_sat, c_not + c * sat

    def predict_relevance(self, batch):
        """DBN ranks by attractiveness * satisfaction (paper §4.1)."""
        return (log_sigmoid(self.parts["attraction"](batch))
                + log_sigmoid(self.parts["satisfaction"](batch)))


class SimplifiedDBN(DynamicBayesianNetwork):
    """SDBN: DBN with lambda fixed at 1 (always continue unless satisfied)."""

    fixed_continuation = True
