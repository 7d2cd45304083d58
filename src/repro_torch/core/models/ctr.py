"""CTR baselines: GCTR (A.1), RCTR (A.2), DCTR (A.3); port of
``repro.core.models.ctr``."""
from __future__ import annotations

import math

import torch

from repro_torch.core.base import ClickModel
from repro_torch.core.parameterization import (EmbeddingParameterConfig,
                                               PositionParameter,
                                               ScalarParameter,
                                               ScalarParameterConfig,
                                               build_parameter)
from repro_torch.stable import log_sigmoid


def _logit(p: float) -> float:
    return math.log(p) - math.log1p(-p)


def _bernoulli(log_p: torch.Tensor, generator: torch.Generator
               ) -> torch.Tensor:
    """1.0 where a uniform draw falls below exp(log_p), else 0.0."""
    u = torch.rand(log_p.shape, generator=generator, device=log_p.device)
    return (u < torch.exp(log_p)).float()


class _PartsModel(ClickModel):
    """Shared plumbing: the model's variables live in ``self.parts``, an
    ``nn.ModuleDict`` keyed like the JAX ``parts`` dict. ``sample`` draws
    one Bernoulli per item from the marginal click probabilities, which is
    the CTR family's sampler; the other models override it."""

    def sample(self, batch, generator):
        clicks = _bernoulli(self.predict_clicks(batch), generator)
        return {"clicks": clicks * batch["mask"].float()}


class GlobalCTR(_PartsModel):
    """log P(C=1|d,k) = log rho (paper Eq. 19)."""

    def __init__(self, positions: int = 10, init_prob: float = 0.5,
                 device="cuda", **_):
        super().__init__()
        self.positions = positions
        self.parts = torch.nn.ModuleDict({"rho": ScalarParameter(
            ScalarParameterConfig(init_prob=init_prob), device)})

    def predict_clicks(self, batch):
        return log_sigmoid(self.parts["rho"](batch))

    def predict_conditional_logits(self, batch):
        return self.parts["rho"](batch)

    def predict_relevance(self, batch):
        return self.predict_clicks(batch)


class RankCTR(_PartsModel):
    """log P(C=1|d,k) = log theta_k (paper Eq. 20)."""

    def __init__(self, positions: int = 10, init_prob: float = 0.5,
                 device="cuda", **_):
        super().__init__()
        self.positions = positions
        self.parts = torch.nn.ModuleDict({"theta": PositionParameter(
            positions, init_logit=_logit(init_prob), device=device)})

    def predict_clicks(self, batch):
        return log_sigmoid(self.parts["theta"](batch))

    def predict_conditional_logits(self, batch):
        return self.parts["theta"](batch)

    def predict_relevance(self, batch):
        # rank-only model: no document signal; all docs tie.
        return torch.zeros(batch["positions"].shape, dtype=torch.float32,
                           device=batch["positions"].device)


class DocumentCTR(_PartsModel):
    """log P(C=1|d,k) = log gamma_d (paper Eq. 21)."""

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

    def predict_clicks(self, batch):
        return log_sigmoid(self.parts["attraction"](batch))

    def predict_conditional_logits(self, batch):
        return self.parts["attraction"](batch)

    def predict_relevance(self, batch):
        return self.parts["attraction"](batch)
