"""Click-prediction and ranking metrics (paper §4.4), port of
``repro.core.metrics``: the streaming click metrics, the ranking functions
(DCG, nDCG, MRR, AP) and the Listing-7 ``RaxMetric`` adapter.

Streaming accumulators: ``state = metric.init_state(K, device)``,
``state = metric.update(state, **outputs)``, ``metric.compute(state)``.
State stays on the device; ``compute`` returns 0-d tensors, so a caller
reads every metric with one host transfer. The per-rank sums are float32:
the JAX version switches them to float64 only under jax x64, which the
port does not mirror.
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# Ranking metrics (Rax-style pure functions).
# ---------------------------------------------------------------------------

def _rank_by_score(scores, where):
    """Ranks (1-based) of each item sorted by descending score; ties keep
    item order, and items outside ``where`` rank last."""
    scores = torch.where(where, scores, -math.inf)
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True) + 1


def _gains_and_discounts(scores, labels, where, top_n):
    ranks = _rank_by_score(scores, where)
    gains = (torch.exp2(labels.float()) - 1.0) * where
    discounts = 1.0 / torch.log2(1.0 + ranks.float())
    if top_n is not None:
        discounts = torch.where(ranks <= top_n, discounts, 0.0)
    return gains, discounts


def dcg_metric(scores, labels, where=None, top_n=None):
    """DCG@top_n = sum gain / log2(1 + rank); gain = 2^label - 1."""
    if where is None:
        where = torch.ones_like(scores, dtype=torch.bool)
    gains, discounts = _gains_and_discounts(scores, labels, where, top_n)
    return torch.mean(torch.sum(gains * discounts, dim=-1))


def ndcg_metric(scores, labels, where=None, top_n=None):
    """DCG over the DCG of the ideal order (by label); lists with no gain
    score 0."""
    if where is None:
        where = torch.ones_like(scores, dtype=torch.bool)
    gains, discounts = _gains_and_discounts(scores, labels, where, top_n)
    dcg = torch.sum(gains * discounts, dim=-1)
    _, ideal = _gains_and_discounts(labels.float(), labels, where, top_n)
    idcg = torch.sum(gains * ideal, dim=-1)
    return torch.mean(torch.where(idcg > 0,
                                  dcg / torch.clamp_min(idcg, 1e-12), 0.0))


def mrr_metric(scores, labels, where=None, top_n=None):
    """Mean reciprocal rank of the first relevant (label > 0) item."""
    if where is None:
        where = torch.ones_like(scores, dtype=torch.bool)
    ranks = _rank_by_score(scores, where)
    relevant = (labels > 0) & where
    rr = torch.where(relevant, 1.0 / ranks.float(), 0.0)
    if top_n is not None:
        rr = torch.where(ranks <= top_n, rr, 0.0)
    return torch.mean(torch.amax(rr, dim=-1))


def average_precision_metric(scores, labels, where=None, top_n=None):
    """AP = mean over relevant items of precision@rank. Ties keep item
    order, as ``jnp.argsort`` (stable) does."""
    if where is None:
        where = torch.ones_like(scores, dtype=torch.bool)
    relevant = ((labels > 0) & where).float()
    K = scores.shape[-1]
    # rel_sorted[b, r] = is the item ranked (r+1) relevant?
    order = torch.argsort(torch.where(where, -scores, math.inf), dim=-1,
                          stable=True)
    rel_sorted = torch.gather(relevant, -1, order)
    ranks = torch.arange(1, K + 1, dtype=torch.float32, device=scores.device)
    contrib = torch.cumsum(rel_sorted, dim=-1) / ranks * rel_sorted
    if top_n is not None:
        contrib = torch.where(ranks <= top_n, contrib, 0.0)
    n_rel = torch.clamp_min(torch.sum(relevant, dim=-1), 1.0)
    return torch.mean(torch.sum(contrib, dim=-1) / n_rel)


class RaxMetric:
    """Adapter matching the paper's Listing 7 RaxMetric(fn, top_n=...)."""

    requires = ("scores", "labels", "where")

    def __init__(self, fn, top_n=None):
        self.fn = fn
        self.top_n = top_n

    def init_state(self, positions: int, device=None):
        del positions
        return {"sum": torch.zeros((), device=device),
                "count": torch.zeros((), device=device)}

    def update(self, state, scores=None, labels=None, where=None, **_):
        value = self.fn(scores, labels, where=where, top_n=self.top_n)
        return {"sum": state["sum"] + value, "count": state["count"] + 1.0}

    def compute(self, state):
        return state["sum"] / torch.clamp_min(state["count"], 1.0)

    def compute_per_rank(self, state):
        return self.compute(state)
