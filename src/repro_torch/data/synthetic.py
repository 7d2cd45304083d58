"""Synthetic click-log simulator, copied from ``repro.data.synthetic``
(the whole-log path; the chunked streaming generators wait for the store
slice).

Generates WSCD/Baidu-ULTR-shaped interaction logs by sampling clicks from a
ground-truth click model (PBM / DBN / UBM / cascade / mixture): Zipf-long-tailed
query frequencies, position bias from a noisy logging ranker, multi-click
sessions, and optional feature vectors correlated with true attractiveness.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticConfig:
    n_sessions: int = 100_000
    n_queries: int = 1_000
    docs_per_query: int = 20
    positions: int = 10
    behavior: str = "pbm"  # pbm | dbn | ubm | cascade | mixture
    zipf_exponent: float = 1.1  # query frequency long tail
    attr_alpha: float = 1.0  # Beta prior on attractiveness
    attr_beta: float = 5.0   # mean CTR ~ alpha/(alpha+beta) ~ 1/6
    exam_decay: float = 0.85  # theta_k = decay^(k-1) position bias
    continuation: float = 0.9  # DBN lambda
    ranker_noise: float = 1.0  # Gumbel noise scale of the logging ranker
    n_features: int = 0  # if > 0, emit query_doc_features
    feature_noise: float = 0.3
    seed: int = 0

    @property
    def n_query_doc_pairs(self) -> int:
        return self.n_queries * self.docs_per_query


def _ground_truth(cfg: SyntheticConfig, rng: np.random.Generator):
    gamma = rng.beta(cfg.attr_alpha, cfg.attr_beta,
                     size=(cfg.n_queries, cfg.docs_per_query)).astype(np.float32)
    theta = cfg.exam_decay ** np.arange(cfg.positions, dtype=np.float32)
    sigma = rng.beta(cfg.attr_alpha, cfg.attr_beta,
                     size=(cfg.n_queries, cfg.docs_per_query)).astype(np.float32)
    return gamma, theta, sigma


def _sample_clicks(cfg: SyntheticConfig, behavior: str, gamma_s, theta, sigma_s,
                   rng: np.random.Generator):
    """Vectorized numpy click sampling for (S, K) attractiveness arrays."""
    S, K = gamma_s.shape
    attracted = rng.random((S, K)) < gamma_s
    if behavior == "pbm":
        examined = rng.random((S, K)) < theta[None, :]
        return (attracted & examined).astype(np.float32)
    if behavior == "cascade":
        clicks = np.zeros((S, K), np.float32)
        browsing = np.ones(S, bool)
        for k in range(K):
            click = browsing & attracted[:, k]
            clicks[:, k] = click
            browsing = browsing & ~click
        return clicks
    if behavior == "dbn":
        satisfied_draw = rng.random((S, K)) < sigma_s
        cont_draw = rng.random((S, K)) < cfg.continuation
        clicks = np.zeros((S, K), np.float32)
        examining = np.ones(S, bool)
        for k in range(K):
            click = examining & attracted[:, k]
            clicks[:, k] = click
            satisfied = click & satisfied_draw[:, k]
            examining = examining & ~satisfied & cont_draw[:, k]
        return clicks
    if behavior == "ubm":
        # theta_{k,k'} = base_k * recency boost for clicks close to k
        clicks = np.zeros((S, K), np.float32)
        last = np.zeros(S, np.int64)  # 0 = no click yet, else 1-based rank
        for k in range(K):
            dist = np.where(last == 0, k + 1, k + 1 - last)
            th = theta[k] * (0.95 ** (dist - 1))
            examined = rng.random(S) < th
            click = examined & attracted[:, k]
            clicks[:, k] = click
            last = np.where(click, k + 1, last)
        return clicks
    raise ValueError(f"unknown behavior {behavior!r}")


def _query_probs(cfg: SyntheticConfig) -> np.ndarray:
    # Zipf query sampling (bounded), long tail like WSCD.
    ranks = np.arange(1, cfg.n_queries + 1, dtype=np.float64)
    q_probs = ranks ** (-cfg.zipf_exponent)
    return q_probs / q_probs.sum()


def _generate_sessions(cfg: SyntheticConfig, n_sessions: int,
                       gamma: np.ndarray, theta: np.ndarray, sigma: np.ndarray,
                       q_probs: np.ndarray,
                       rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Sample ``n_sessions`` sessions against fixed ground-truth parameters."""
    queries = rng.choice(cfg.n_queries, size=n_sessions, p=q_probs)

    # Logging ranker: order docs by noisy attractiveness (selection bias),
    # show top-K.
    S, K = n_sessions, cfg.positions
    noise = rng.gumbel(scale=cfg.ranker_noise,
                       size=(S, cfg.docs_per_query)).astype(np.float32)
    scores = np.log(np.maximum(gamma[queries], 1e-6)) + noise
    top_docs = np.argsort(-scores, axis=1)[:, :K].astype(np.int64)

    gamma_s = np.take_along_axis(gamma[queries], top_docs, axis=1)
    sigma_s = np.take_along_axis(sigma[queries], top_docs, axis=1)

    if cfg.behavior == "mixture":
        # Half the population browses PBM-style, half cascade-style.
        pick = rng.random(S) < 0.5
        clicks = np.where(
            pick[:, None],
            _sample_clicks(cfg, "pbm", gamma_s, theta, sigma_s, rng),
            _sample_clicks(cfg, "cascade", gamma_s, theta, sigma_s, rng))
    else:
        clicks = _sample_clicks(cfg, cfg.behavior, gamma_s, theta, sigma_s, rng)

    query_doc_ids = (queries[:, None] * cfg.docs_per_query + top_docs).astype(np.int64)
    data = {
        "positions": np.broadcast_to(np.arange(1, K + 1, dtype=np.int32),
                                     (S, K)).copy(),
        "query_doc_ids": query_doc_ids,
        "clicks": clicks.astype(np.float32),
        "mask": np.ones((S, K), bool),
        # ground truth for evaluation (NOT model inputs):
        "true_attractiveness": gamma_s,
        "true_satisfaction": sigma_s,
    }
    if cfg.n_features > 0:
        data["query_doc_features"] = make_features(
            gamma_s, cfg.n_features, cfg.feature_noise, rng)
    return data


def generate_click_log(cfg: SyntheticConfig) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    gamma, theta, sigma = _ground_truth(cfg, rng)
    data = _generate_sessions(cfg, cfg.n_sessions, gamma, theta, sigma,
                              _query_probs(cfg), rng)
    meta = {
        "theta": theta,
        "gamma": gamma.reshape(-1),
        "sigma": sigma.reshape(-1),
        "n_query_doc_pairs": cfg.n_query_doc_pairs,
    }
    return data, meta


def make_features(gamma_s: np.ndarray, n_features: int, noise: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Feature vectors carrying attractiveness signal + distractor dims."""
    S, K = gamma_s.shape
    logit = np.log(np.maximum(gamma_s, 1e-6)) - np.log(np.maximum(1 - gamma_s, 1e-6))
    feats = rng.normal(scale=1.0, size=(S, K, n_features)).astype(np.float32)
    # first few dims carry signal with varying SNR
    n_signal = max(n_features // 4, 1)
    for i in range(n_signal):
        feats[:, :, i] = logit * (1.0 / (i + 1)) + rng.normal(
            scale=noise, size=(S, K)).astype(np.float32)
    return feats
