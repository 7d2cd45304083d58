"""Cascade model (paper A.5): click the first attractive doc, then stop;
port of ``repro.core.models.cascade``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.base import clicks_before
from repro_torch.core.models.ctr import _bernoulli, _logit, _PartsModel
from repro_torch.core.parameterization import (EmbeddingParameterConfig,
                                               build_parameter)
from repro_torch.stable import (MIN_LOG_PROB, exclusive_cumsum, log1mexp,
                                log_sigmoid)


class CascadeModel(_PartsModel):
    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, init_prob: float = 0.5,
                 device="cuda", seed: int = 0, **_):
        super().__init__()
        self.positions = positions
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=_logit(init_prob))
        self.parts = torch.nn.ModuleDict(
            {"attraction": build_parameter(attraction, device, seed)})

    def _log_attr(self, batch):
        return log_sigmoid(self.parts["attraction"](batch))

    def predict_clicks(self, batch):
        """Eq. 23: log gamma_d + sum_{i<k} log(1 - gamma_{d_i})."""
        la = self._log_attr(batch)
        return la + exclusive_cumsum(log1mexp(la), axis=1)

    def predict_conditional_clicks(self, batch):
        """Eq. 24: gamma_d until the first click, MIN_LOG_PROB afterwards."""
        la = self._log_attr(batch)
        any_click_before = clicks_before(batch["clicks"]) > 0
        return torch.where(any_click_before, MIN_LOG_PROB, la)

    def predict_relevance(self, batch):
        return self.parts["attraction"](batch)

    def sample(self, batch, generator):
        attracted = _bernoulli(self._log_attr(batch), generator)
        # Browsing continues while nothing was attractive: examined at k iff
        # no attractive item above k; the first attractive one is clicked.
        examined = torch.cumprod(F.pad(1.0 - attracted[:, :-1], (1, 0),
                                       value=1.0), dim=1)
        clicks = examined * attracted * batch["mask"].float()
        return {"clicks": clicks, "attraction": attracted,
                "examination": examined}
