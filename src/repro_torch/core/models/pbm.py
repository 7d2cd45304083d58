"""Position-based model (paper §3, Eq. 22): P(C) = theta_k * gamma_d; port
of ``repro.core.models.pbm``."""
from __future__ import annotations

import torch

from repro_torch.core.models.ctr import _bernoulli, _logit, _PartsModel
from repro_torch.core.parameterization import (EmbeddingParameterConfig,
                                               PositionParameter,
                                               build_parameter)
from repro_torch.stable import log_sigmoid


class PositionBasedModel(_PartsModel):
    """PBM: two-tower in its neural form (paper Listing 4).

    attraction / examination accept any parameterization config or module;
    the defaults are the classic embedding table + rank table.
    """

    def __init__(self, query_doc_pairs: int = None, positions: int = 10,
                 attraction=None, examination=None, init_prob: float = 0.5,
                 device="cuda", seed: int = 0, **_):
        super().__init__()
        self.positions = positions
        if attraction is None:
            attraction = EmbeddingParameterConfig(parameters=query_doc_pairs,
                                                  init_logit=_logit(init_prob))
        if examination is None:
            examination = PositionParameter(positions, init_logit=2.0,
                                            device=device)
        self.parts = torch.nn.ModuleDict({
            "attraction": build_parameter(attraction, device, seed),
            "examination": build_parameter(examination, device, seed),
        })

    def _log_probs(self, batch):
        la = log_sigmoid(self.parts["attraction"](batch))
        le = log_sigmoid(self.parts["examination"](batch))
        return la, le

    def predict_clicks(self, batch):
        la, le = self._log_probs(batch)
        return la + le

    def predict_relevance(self, batch):
        return self.parts["attraction"](batch)

    def sample(self, batch, generator):
        la, le = self._log_probs(batch)
        attracted = _bernoulli(la, generator)
        examined = _bernoulli(le, generator)
        clicks = attracted * examined * batch["mask"].float()
        return {"clicks": clicks, "attraction": attracted,
                "examination": examined}
