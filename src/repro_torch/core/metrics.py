"""Click-prediction metrics (paper §4.4), port of the streaming click
metrics of ``repro.core.metrics``.

Streaming accumulators: ``state = metric.init_state(K, device)``,
``state = metric.update(state, **outputs)``, ``metric.compute(state)``.
State stays on the device; ``compute`` returns 0-d tensors, so a caller
reads every metric with one host transfer. The per-rank sums are float32:
the JAX version switches them to float64 only under jax x64, which the
port does not mirror.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.stable import log1mexp

LOG2 = 0.6931471805599453


def _bce_bits(log_probs, clicks):
    """Per-item log2-loss: -[c log2 p + (1-c) log2 (1-p)]."""
    clicks = clicks.to(log_probs.dtype)
    ll = clicks * log_probs + (1.0 - clicks) * log1mexp(log_probs)
    return -ll / LOG2


class _StreamingMetric:
    """Accumulates per-rank (sum, count) for global and per-rank views."""

    requires = ("log_probs", "clicks", "where")

    def init_state(self, positions: int, device=None):
        return {"sum": torch.zeros(positions, device=device),
                "count": torch.zeros(positions, device=device)}

    def _values(self, **kwargs):
        raise NotImplementedError

    def update(self, state, **kwargs):
        where = kwargs.get("where")
        values = self._values(**kwargs)
        if where is None:
            where = torch.ones_like(values, dtype=torch.bool)
        w = where.to(values.dtype)
        return {"sum": state["sum"] + torch.sum(values * w, dim=0),
                "count": state["count"] + torch.sum(w, dim=0)}

    def compute(self, state):
        mean = (torch.sum(state["sum"])
                / torch.clamp_min(torch.sum(state["count"]), 1.0))
        return self._finalize(mean)

    def compute_per_rank(self, state):
        return self._finalize(state["sum"]
                              / torch.clamp_min(state["count"], 1.0))

    def _finalize(self, mean):
        return mean


class LogLikelihood(_StreamingMetric):
    """Eq. 13: mean conditional log-likelihood (higher = better)."""

    requires = ("conditional_log_probs", "clicks", "where")

    def _values(self, conditional_log_probs=None, clicks=None, **_):
        clicks = clicks.to(conditional_log_probs.dtype)
        return (clicks * conditional_log_probs
                + (1.0 - clicks) * log1mexp(conditional_log_probs))


class Perplexity(_StreamingMetric):
    """Eq. 14 with unconditional click predictions."""

    requires = ("log_probs", "clicks", "where")

    def _values(self, log_probs=None, clicks=None, **_):
        return _bce_bits(log_probs, clicks)

    def _finalize(self, mean):
        return torch.exp2(mean)


class ConditionalPerplexity(_StreamingMetric):
    """Eq. 14 with conditional click predictions."""

    requires = ("conditional_log_probs", "clicks", "where")

    def _values(self, conditional_log_probs=None, clicks=None, **_):
        return _bce_bits(conditional_log_probs, clicks)

    def _finalize(self, mean):
        return torch.exp2(mean)


class MultiMetric:
    """Bundle of named metrics with automatic input routing (Listing 6)."""

    def __init__(self, metrics: Dict[str, object]):
        self.metrics = dict(metrics)

    def init_state(self, positions: int, device=None):
        return {name: m.init_state(positions, device)
                for name, m in self.metrics.items()}

    def update(self, state, **kwargs):
        out = {}
        for name, metric in self.metrics.items():
            routed = {k: v for k, v in kwargs.items() if k in metric.requires}
            out[name] = metric.update(state[name], **routed)
        return out

    def compute(self, state):
        return {name: m.compute(state[name]) for name, m in self.metrics.items()}

    def compute_per_rank(self, state):
        return {name: m.compute_per_rank(state[name])
                for name, m in self.metrics.items()}
