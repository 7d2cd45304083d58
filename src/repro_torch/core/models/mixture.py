"""Mixture meta-model (paper §4.3, Eq. 12); port of
``repro.core.models.mixture``.

Learns a prior P(m) over M click models; the session loss is the
temperature-scaled log-sum-exp of per-model session log-losses. Parameter
sharing between members (paper Listing 5) works by identity: a module that
two members hold is one set of parameters, stored once under the first
member's key. ``store`` holds each distinct module under the JAX tree's key
``m{i}_{slot}``, and ``prior_logits`` sits beside it, so ``named_parameters``
lists every parameter once and a shared module's gradient is the sum of its
uses. The members are kept as a plain list, not as submodules, so their
parameters are not registered a second time.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.base import ClickModel
from repro_torch.stable import exclusive_cumsum, log_bce, logsumexp


class MixtureModel(ClickModel):
    def __init__(self, models: Sequence[ClickModel], temperature: float = 1.0,
                 device="cuda"):
        super().__init__()
        self.models = list(models)
        self.temperature = temperature
        self.positions = max(m.positions for m in self.models)
        store, seen = {}, {}
        for i, model in enumerate(self.models):
            for slot, module in model.parts.items():
                if id(module) not in seen:
                    seen[id(module)] = f"m{i}_{slot}"
                    store[f"m{i}_{slot}"] = module
        self.store = torch.nn.ModuleDict(store)
        self.prior_logits = torch.nn.Parameter(
            torch.zeros(len(self.models), device=device))

    def _log_prior(self):
        return torch.log_softmax(self.prior_logits, dim=0)

    def session_losses(self, batch):
        """Per-model per-session NLL: (M, B)."""
        mask = batch["mask"].float()
        return torch.stack([
            torch.sum(log_bce(m.predict_conditional_clicks(batch),
                              batch["clicks"]) * mask, dim=1)
            for m in self.models])

    def compute_loss(self, batch):
        """Eq. 12, normalized per item so the scale matches the members."""
        nll = self.session_losses(batch)                            # (M, B)
        mix = -logsumexp(self._log_prior()[:, None] - nll / self.temperature,
                         axis=0)
        n_items = torch.clamp_min(torch.sum(batch["mask"].float()), 1.0)
        return torch.sum(mix) / n_items

    def predict_clicks(self, batch):
        """Prior-weighted mixture: log sum_m P(m) P_m(C=1|d,k)."""
        preds = torch.stack([m.predict_clicks(batch) for m in self.models])
        return logsumexp(self._log_prior()[:, None, None] + preds, axis=0)

    def predict_conditional_clicks(self, batch):
        """Posterior-weighted: w_m(k) ~ P(m) P_m(c_<k), strictly causal
        (uses the clicks before k only)."""
        mask = batch["mask"].float()
        cond, prefix = [], []
        for m in self.models:
            lp = m.predict_conditional_clicks(batch)
            cond.append(lp)
            ll = -log_bce(lp, batch["clicks"]) * mask   # per-item log-lik
            prefix.append(exclusive_cumsum(ll, axis=1))
        cond = torch.stack(cond)                                    # (M, B, K)
        log_w = (self._log_prior()[:, None, None]
                 + torch.stack(prefix) / self.temperature)
        log_w = log_w - logsumexp(log_w, axis=0, keepdims=True)
        return logsumexp(log_w + cond, axis=0)

    def predict_relevance(self, batch):
        scores = torch.stack([m.predict_relevance(batch)
                              for m in self.models])
        return torch.sum(torch.exp(self._log_prior())[:, None, None] * scores,
                         dim=0)

    def sample(self, batch, generator):
        b = batch["positions"].shape[0]
        choice = torch.multinomial(torch.exp(self._log_prior()), b,
                                   replacement=True, generator=generator)
        samples = torch.stack([m.sample(batch, generator)["clicks"]
                               for m in self.models])               # (M, B, K)
        clicks = torch.gather(samples, 0, choice[None, :, None].expand(
            1, b, samples.shape[2]))[0]
        return {"clicks": clicks, "model_choice": choice}
