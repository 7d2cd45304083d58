"""Examination-chain models: DCM (A.7), CCM (A.8), DBN (A.9), SDBN; port of
``repro.core.models.chain``.

All share log P(C_k=1 | .) = log eps_k + log gamma_{d_k}. The marginal
chain eps is an exclusive cumsum of per-position log continuation factors;
the conditional chain is the capped death-odds recurrence of
``core.recursions``. ``compute_loss`` hands the raw attraction logits and
the probability-space factors to the fused ``examination_nll`` kernel.
``predict_clicks_scan`` / ``predict_conditional_clicks_scan`` are the
sequential per-position recursions the vectorized paths replaced, kept as
their oracles, with JAX's steps op for op: a skip chain multiplies its
carry's gradient at every position, so the order in which autograd sums
the gradients shows in float32, and JAX's order agrees with float64.
``sample`` walks the positions in the same order.
"""
from __future__ import annotations

import torch

from repro_torch.core.models.ctr import _bernoulli, _logit, _PartsModel
from repro_torch.core.parameterization import (EmbeddingParameterConfig,
                                               PositionParameter,
                                               ScalarParameter,
                                               ScalarParameterConfig,
                                               build_parameter)
from repro_torch.core.recursions import (conditional_examination_odds,
                                         marginal_examination)
from repro_torch.stable import (log1mexp, log_add_exp, log_sigmoid, minimum,
                                sigmoid_core, sigmoid_parts)


def _scan_positions(step, init, *arrays):
    """Run ``step(carry, xs_k) -> (carry, y_k)`` over axis 1 of the given
    (B, K) tensors, as ``lax.scan`` does; y_k is a (B,) tensor or a tuple of
    them, and the result the (B, K) stack (or a tuple of stacks)."""
    carry, ys = init, []
    for k in range(arrays[0].shape[1]):
        carry, y = step(carry, tuple(a[:, k] for a in arrays))
        ys.append(y)
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(col, dim=1) for col in zip(*ys))
    return torch.stack(ys, dim=1)


class _ChainModel(_PartsModel):
    """Shared vectorized prediction plumbing. Subclasses provide
    ``_marginal_log_cont`` (log f_k of the marginal chain) and
    ``_conditional_terms`` (p_skip_survive, p_death, p_reset, p_reset_not);
    both receive attraction gamma (g) and 1-gamma (gn)."""

    def _attr_logits(self, batch):
        return self.parts["attraction"](batch)

    def _log_attr(self, batch):
        return log_sigmoid(self._attr_logits(batch))

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
                 device="cuda", seed: int = 0, **_):
        super().__init__()
        self.positions = positions
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=_logit(init_prob))
        if continuation is None:
            continuation = PositionParameter(positions, init_logit=0.0,
                                             device=device)
        self.parts = torch.nn.ModuleDict({
            "attraction": build_parameter(attraction, device, seed),
            "continuation": build_parameter(continuation, device, seed),
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

    def _log_terms(self, batch):
        return (self._log_attr(batch),
                log_sigmoid(self.parts["continuation"](batch)))

    def predict_clicks_scan(self, batch):
        la, ll = self._log_terms(batch)

        def step(log_eps, xs):
            la_k, ll_k = xs
            log_p = log_eps + la_k
            return log_eps + log_add_exp(la_k + ll_k, log1mexp(la_k)), log_p

        return _scan_positions(step, torch.zeros_like(la[:, 0]), la, ll)

    def predict_conditional_clicks_scan(self, batch):
        la, ll = self._log_terms(batch)

        def step(log_eps, xs):
            la_k, ll_k, c_k = xs
            log_p = log_eps + la_k
            skip = log1mexp(la_k) + log_eps - log1mexp(la_k + log_eps)
            return torch.where(c_k > 0, ll_k, skip), log_p

        return _scan_positions(step, torch.zeros_like(la[:, 0]), la, ll,
                               batch["clicks"].float())

    def sample(self, batch, generator):
        la, ll = self._log_terms(batch)
        attracted = _bernoulli(la, generator)
        cont_u = torch.rand(la.shape, generator=generator, device=la.device)

        def step(examining, xs):
            a_k, ll_k, u = xs
            click = examining * a_k
            keep = torch.where(click > 0, (u < torch.exp(ll_k)).float(), 1.0)
            return examining * keep, (click, examining)

        clicks, examined = _scan_positions(step, torch.ones_like(la[:, 0]),
                                           attracted, ll, cont_u)
        return {"clicks": clicks * batch["mask"].float(),
                "attraction": attracted, "examination": examined}


class ClickChainModel(_ChainModel):
    """CCM: three continuation scenarios tau_1/2/3 (Eq. 29-30)."""

    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, init_prob: float = 0.5,
                 tau_init=(0.7, 0.4, 0.2), device="cuda", seed: int = 0,
                 **_):
        super().__init__()
        self.positions = positions
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=_logit(init_prob))
        parts = {"attraction": build_parameter(attraction, device, seed)}
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

    def _log_terms(self, batch):
        return self._log_attr(batch), tuple(
            log_sigmoid(self.parts[f"tau_{i}"](batch)) for i in (1, 2, 3))

    def predict_clicks_scan(self, batch):
        la, (lt1, lt2, lt3) = self._log_terms(batch)

        def step(log_eps, xs):
            la_k, lt1_k, lt2_k, lt3_k = xs
            log_p = log_eps + la_k
            inner = log_add_exp(log1mexp(la_k) + lt2_k, la_k + lt3_k)
            cont = log_add_exp(la_k + inner, log1mexp(la_k) + lt1_k)
            return log_eps + cont, log_p

        return _scan_positions(step, torch.zeros_like(la[:, 0]), la, lt1,
                               lt2, lt3)

    def predict_conditional_clicks_scan(self, batch):
        la, (lt1, lt2, lt3) = self._log_terms(batch)

        def step(log_eps, xs):
            la_k, lt1_k, lt2_k, lt3_k, c_k = xs
            log_p = log_eps + la_k
            click = log_add_exp(la_k + lt3_k, log1mexp(la_k) + lt2_k)
            skip = (log1mexp(la_k) + log_eps + lt1_k
                    - log1mexp(la_k + log_eps))
            return torch.where(c_k > 0, click, skip), log_p

        return _scan_positions(step, torch.zeros_like(la[:, 0]), la, lt1,
                               lt2, lt3, batch["clicks"].float())

    def sample(self, batch, generator):
        la, (lt1, lt2, lt3) = self._log_terms(batch)
        attracted = _bernoulli(la, generator)
        satisfied = _bernoulli(la, generator)
        cont_u = torch.rand(la.shape, generator=generator, device=la.device)

        def step(examining, xs):
            a_k, s_k, lt1_k, lt2_k, lt3_k, u = xs
            click = examining * a_k
            log_cont = torch.where(click > 0,
                                   torch.where(s_k > 0, lt3_k, lt2_k), lt1_k)
            keep = (u < torch.exp(log_cont)).float()
            return examining * keep, (click, examining)

        clicks, examined = _scan_positions(
            step, torch.ones_like(la[:, 0]), attracted, satisfied, lt1, lt2,
            lt3, cont_u)
        return {"clicks": clicks * batch["mask"].float(),
                "attraction": attracted, "satisfaction": satisfied,
                "examination": examined}


class DynamicBayesianNetwork(_ChainModel):
    """DBN (Eq. 31-32): separate attraction and satisfaction, global lambda."""

    fixed_continuation = False  # SDBN overrides

    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, satisfaction=None, init_prob: float = 0.5,
                 lambda_init: float = 0.9, device="cuda", seed: int = 0,
                 **_):
        super().__init__()
        self.positions = positions
        logit = _logit(init_prob)
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=logit)
        if satisfaction is None:
            satisfaction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                    init_logit=logit)
        parts = {"attraction": build_parameter(attraction, device, seed),
                 "satisfaction": build_parameter(satisfaction, device,
                                                 seed)}
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

    def _log_terms(self, batch):
        la = self._log_attr(batch)
        ls = log_sigmoid(self.parts["satisfaction"](batch))
        lc = (torch.zeros_like(la) if self.fixed_continuation
              else log_sigmoid(self.parts["continuation"](batch)))
        return la, ls, lc

    def predict_clicks_scan(self, batch):
        la, ls, lc = self._log_terms(batch)

        def step(log_eps, xs):
            la_k, ls_k, lc_k = xs
            log_p = log_eps + la_k
            return log_eps + lc_k + log1mexp(la_k + ls_k), log_p

        return _scan_positions(step, torch.zeros_like(la[:, 0]), la, ls, lc)

    def predict_conditional_clicks_scan(self, batch):
        la, ls, lc = self._log_terms(batch)

        def step(log_eps, xs):
            la_k, ls_k, lc_k, c_k = xs
            log_p = log_eps + la_k
            skip = log1mexp(la_k) + log_eps - log1mexp(la_k + log_eps)
            return lc_k + torch.where(c_k > 0, log1mexp(ls_k), skip), log_p

        return _scan_positions(step, torch.zeros_like(la[:, 0]), la, ls, lc,
                               batch["clicks"].float())

    def sample(self, batch, generator):
        la, ls, lc = self._log_terms(batch)
        attracted = _bernoulli(la, generator)
        satisfied_draw = _bernoulli(ls, generator)
        cont_u = torch.rand(la.shape, generator=generator, device=la.device)

        def step(examining, xs):
            a_k, s_k, lc_k, u = xs
            click = examining * a_k
            satisfied = click * s_k
            cont = (u < torch.exp(lc_k)).float()
            return (examining * (1.0 - satisfied) * cont,
                    (click, examining, satisfied))

        clicks, examined, satisfied = _scan_positions(
            step, torch.ones_like(la[:, 0]), attracted, satisfied_draw, lc,
            cont_u)
        return {"clicks": clicks * batch["mask"].float(),
                "attraction": attracted, "satisfaction": satisfied,
                "examination": examined}

    def predict_relevance(self, batch):
        """DBN ranks by attractiveness * satisfaction (paper §4.1)."""
        return (log_sigmoid(self.parts["attraction"](batch))
                + log_sigmoid(self.parts["satisfaction"](batch)))


class SimplifiedDBN(DynamicBayesianNetwork):
    """SDBN: DBN with lambda fixed at 1 (always continue unless satisfied)."""

    fixed_continuation = True
