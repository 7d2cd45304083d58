"""Per-model circuit breakers and the graceful-degradation ladder.

Copied from ``repro.serve.breaker`` (numpy only).

Each model serves through a ladder of tiers — ``primary`` (f32 params) →
``int8`` (quantized embedding-table copy) → ``prior`` (constant CTR
fallback, host-side, cannot fail). The two upper tiers are each guarded by
a :class:`CircuitBreaker` driven by *batch* outcomes, where a batch counts
as failed if the model raised or any of its requests missed its deadline:

* **closed** — healthy; failures accumulate in a sliding outcome window.
  When the window's failure rate crosses ``threshold`` (with at least
  ``min_samples`` outcomes) the breaker opens.
* **open** — the tier is skipped; traffic flows to the next rung. Every
  dispatch of this model that bypasses the tier ticks the cooldown; after
  ``cooldown`` ticks the breaker goes half-open.
* **half-open** — exactly one probe batch is allowed back through the
  guarded tier. Success closes the breaker (window reset); failure
  re-opens it for another cooldown.

The API keeps *observation* and *mutation* apart so the engine's planner
can ask "which tier would serve now?" without perturbing breaker state:
:meth:`CircuitBreaker.available` is pure; :meth:`note_skipped` (cooldown
tick), :meth:`begin` (probe claim) and :meth:`record` (outcome) mutate,
and are called exactly once per executed dispatch. Because all of them
are driven by dispatch counts, not wall time, a seeded chaos drill trips
and recovers deterministically.

All transitions are counted (``serve.breaker_transitions``) and emitted as
``breaker_transition`` events so a degraded fleet is visible in telemetry.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

from repro_torch.serve.request import TIERS

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, name: str, window: int = 16,
                 threshold: float = 0.5, min_samples: int = 4,
                 cooldown: int = 8, recorder=None):
        self.name = name
        self.window = int(window)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.cooldown = int(cooldown)
        self.recorder = recorder
        self.state = CLOSED
        self.transitions = 0
        self._outcomes = collections.deque(maxlen=self.window)
        self._cooldown_ticks = 0
        self._probe_in_flight = False

    def _transition(self, new_state: str) -> None:
        if new_state == self.state:
            return
        old, self.state = self.state, new_state
        self.transitions += 1
        rec = self.recorder
        if rec is not None:
            rec.add("serve.breaker_transitions")
            rec.event("breaker_transition",
                      data={"breaker": self.name, "from": old,
                            "to": new_state})

    # -- observation (pure) --------------------------------------------------
    def available(self) -> bool:
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            return False
        return not self._probe_in_flight  # half-open: one probe at a time

    # -- mutation (once per executed dispatch) -------------------------------
    def note_skipped(self) -> None:
        """A dispatch of this model bypassed the guarded tier."""
        if self.state == OPEN:
            self._cooldown_ticks += 1
            if self._cooldown_ticks >= self.cooldown:
                self._transition(HALF_OPEN)
                self._probe_in_flight = False

    def begin(self) -> None:
        """A dispatch is about to run on the guarded tier."""
        if self.state == HALF_OPEN:
            self._probe_in_flight = True

    def record(self, ok: bool) -> None:
        """Feed one batch outcome for the guarded tier."""
        if self.state == HALF_OPEN:
            self._probe_in_flight = False
            if ok:
                self._outcomes.clear()
                self._transition(CLOSED)
            else:
                self._cooldown_ticks = 0
                self._transition(OPEN)
            return
        self._outcomes.append(bool(ok))
        if self.state == CLOSED and len(self._outcomes) >= self.min_samples:
            failure_rate = 1.0 - sum(self._outcomes) / len(self._outcomes)
            if failure_rate >= self.threshold:
                self._cooldown_ticks = 0
                self._transition(OPEN)


class DegradationLadder:
    """Routes one model's traffic down TIERS as its breakers open."""

    def __init__(self, model: str, recorder=None, breaker_kwargs=None):
        kw = dict(breaker_kwargs or {})
        self.model = model
        # The terminal tier has no breaker: the prior fallback is pure
        # host-side numpy and must always be available.
        self.breakers: Dict[str, CircuitBreaker] = {
            tier: CircuitBreaker(f"{model}/{tier}", recorder=recorder, **kw)
            for tier in TIERS[:-1]
        }

    def select(self, force_tier: Optional[str] = None) -> str:
        """The tier a dispatch would use right now (pure)."""
        if force_tier is not None:
            return force_tier
        for tier in TIERS[:-1]:
            if self.breakers[tier].available():
                return tier
        return TIERS[-1]

    def walk_from(self, tier: str) -> List[str]:
        """Fallback attempt order for a dispatch starting at ``tier``:
        the tier itself, then every *available* lower rung, then the
        terminal rung (which cannot fail)."""
        start = TIERS.index(tier)
        out = [tier]
        for t in TIERS[start + 1:-1]:
            if self.breakers[t].available():
                out.append(t)
        if TIERS[-1] != tier:
            out.append(TIERS[-1])
        return out

    def begin_attempt(self, tier: str) -> None:
        breaker = self.breakers.get(tier)
        if breaker is not None:
            breaker.begin()

    def record(self, tier: str, ok: bool) -> None:
        breaker = self.breakers.get(tier)
        if breaker is not None:
            breaker.record(ok)

    def finish_dispatch(self, answered_tier: str, attempted) -> None:
        """Tick the cooldown of every guarded tier the dispatch bypassed
        (above the answering tier and not attempted)."""
        limit = TIERS.index(answered_tier)
        for i, tier in enumerate(TIERS[:-1]):
            if i < limit and tier not in attempted:
                self.breakers[tier].note_skipped()

    def state(self) -> Dict[str, str]:
        return {tier: b.state for tier, b in self.breakers.items()}
