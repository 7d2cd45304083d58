"""ClickModel base API (paper §4.1, Listing 2), port of ``repro.core.base``.

A model is a module that owns its parameters; every method takes a padded
batch dict of (B, K) tensors on the model's device:

  * ``compute_loss(batch)``               masked mean NLL of observed clicks.
  * ``predict_clicks(batch)``             log P(C=1 | d, k).
  * ``predict_conditional_clicks(batch)`` log P(C=1 | d, k, c_<k).
  * ``predict_relevance(batch)``          ranking scores (log-space).

Batch layout: positions int (1-based), query_doc_ids int, clicks float,
mask bool (True = real item).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.nn.module import Module
from repro_torch.stable import log_bce

Batch = Dict[str, torch.Tensor]

REQUIRED_KEYS = ("positions", "clicks", "mask")


def validate_batch(batch: Batch) -> None:
    for key in REQUIRED_KEYS:
        if key not in batch:
            raise ValueError(f"batch missing required key {key!r}")
    shape = tuple(batch["positions"].shape)
    if len(shape) != 2:
        raise ValueError(f"batch arrays must be 2D (batch, positions), got {shape}")
    for key, arr in batch.items():
        if tuple(arr.shape[:2]) != shape:
            raise ValueError(f"batch[{key!r}] leading shape "
                             f"{tuple(arr.shape[:2])} != {shape}")


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp_min(torch.sum(mask), 1.0)


class ClickModel(Module):
    """Base class: loss defaults to BCE over conditional click log-probs."""

    positions: int = 10

    def compute_loss(self, batch: Batch) -> torch.Tensor:
        logits = self.predict_conditional_logits(batch)
        if logits is not None:
            # CTR family: one fused kernel from raw logits to the scalar loss.
            from repro_torch.kernels import session_nll

            return session_nll(logits, batch["clicks"], batch["mask"])
        log_probs = self.predict_conditional_clicks(batch)
        return masked_mean(log_bce(log_probs, batch["clicks"]), batch["mask"])

    def predict_conditional_logits(self, batch: Batch):
        """Raw logits x with log P(C=1 | d, k, c_<k) = log sigmoid(x), or
        None. The CTR family overrides it to route ``compute_loss`` through
        the fused ``session_nll`` kernel."""
        del batch
        return None

    def predict_clicks(self, batch: Batch) -> torch.Tensor:
        raise NotImplementedError

    def predict_conditional_clicks(self, batch: Batch) -> torch.Tensor:
        return self.predict_clicks(batch)  # position-independent default

    def predict_relevance(self, batch: Batch) -> torch.Tensor:
        raise NotImplementedError
