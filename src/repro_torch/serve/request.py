"""Request/response records for the serving engine.

Copied from ``repro.serve.request`` (numpy only).

A :class:`ServeRequest` is one session to score: a (K,) ranking for one
model, plus a latency budget. The engine answers every submitted request
with exactly one :class:`ServeResult` — answered, rejected (failed
validation / draining), or shed (admission control / unmeetable deadline).
"Zero dropped requests" is checked by matching result ids against
submitted ids, so results are the unit of every serving guarantee.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Result statuses.
OK = "ok"              # answered (possibly on a degraded tier)
REJECTED = "rejected"  # failed validation, unknown model, or draining
SHED = "shed"          # admission control or unmeetable deadline

# Degradation ladder tiers, best first.
TIERS = ("primary", "int8", "prior")


@dataclasses.dataclass
class ServeRequest:
    """One session to score. Arrays are host numpy, shape (K,)."""

    request_id: int
    model: str
    positions: np.ndarray       # int, 1-based ranks
    query_doc_ids: np.ndarray   # int, in [0, query_doc_pairs)
    mask: np.ndarray            # bool, True = real item
    features: Optional[np.ndarray] = None   # (K, F) for neural towers
    deadline_s: float = 0.2     # latency budget relative to arrival
    arrival_s: float = 0.0      # trace timestamp (engine clock domain)

    # stamped by the engine at admission
    admit_s: Optional[float] = None

    def deadline_abs(self) -> float:
        # The budget starts at *arrival*, not admission: time spent queued
        # behind a busy engine counts against the deadline.
        return self.arrival_s + self.deadline_s


@dataclasses.dataclass
class ServeResult:
    request_id: int
    model: str
    status: str                    # OK | REJECTED | SHED
    reason: Optional[str] = None   # set when status != OK
    tier: Optional[str] = None     # which ladder tier answered
    log_ctr: Optional[np.ndarray] = None  # (K,) log P(click) when OK
    latency_s: float = 0.0
    deadline_hit: bool = False

    @property
    def answered(self) -> bool:
        return self.status == OK

    @property
    def degraded(self) -> bool:
        return self.status == OK and self.tier != "primary"


def make_request(request_id: int, model: str, positions_k: int, rng,
                 n_pairs: int, deadline_s: float = 0.2,
                 arrival_s: float = 0.0) -> ServeRequest:
    """A well-formed random request (trace generators, warmup, tests)."""
    return ServeRequest(
        request_id=request_id,
        model=model,
        positions=np.arange(1, positions_k + 1, dtype=np.int32),
        query_doc_ids=rng.integers(0, n_pairs, positions_k).astype(np.int32),
        mask=np.ones(positions_k, dtype=bool),
        deadline_s=deadline_s,
        arrival_s=arrival_s,
    )


def poisson_trace(n_requests: int, qps: float, models, positions_k: int,
                  n_pairs: int, deadline_s: float = 0.2, seed: int = 0):
    """Seeded Poisson arrival trace: exponential interarrivals at ``qps``,
    models drawn round-robin-free (uniform) from ``models``. Deterministic
    in (seed, qps, n_requests)."""
    rng = np.random.default_rng(seed)
    models = list(models)
    t = 0.0
    trace = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / qps))
        model = models[int(rng.integers(0, len(models)))]
        trace.append(make_request(i, model, positions_k, rng, n_pairs,
                                  deadline_s=deadline_s, arrival_s=t))
    return trace
