"""Time sources for the serving engine.

Copied from ``repro.serve.clock`` (numpy only).

The engine is an event loop over (arrival time, request) pairs; everything
time-dependent — admission, batch dispatch timing, deadline accounting,
breaker trips — goes through one clock object, which comes in two flavors:

* :class:`WallClock` — real time. ``advance_to`` sleeps until the next
  arrival, ``charge`` is a no-op (real work already took real time). This
  is what production serving and ``chip_smoke.py``'s ``serve_engine``
  phase use.
* :class:`VirtualClock` — simulated time. ``advance_to`` jumps, ``charge``
  adds the model's *modeled* service time (see :class:`ServiceModel`).
  Model execution still really runs (predictions are real); only the
  latency bookkeeping is simulated, so a chaos drill's shed/degrade/miss
  counters are bit-deterministic across runs and platforms.

The split is the serving counterpart of the data plane's seeded fault
injectors: chaos tests pin exact counter values, the wall benchmark
measures real percentiles.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple


class WallClock:
    virtual = False

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance_to(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            time.sleep(delta)

    def charge(self, seconds: float) -> None:
        del seconds  # real execution already advanced the wall clock


class VirtualClock:
    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t > self._now:
            self._now = float(t)

    def charge(self, seconds: float) -> None:
        if seconds > 0:
            self._now += float(seconds)


class ServiceModel:
    """Modeled service time per (tier, bucket): ``base + per_item * bucket``.

    Used by :class:`VirtualClock` runs as both the batcher's estimate and
    the charged execution time (exact, hence deterministic). The defaults
    encode the ladder's *intent* — the int8 tier moves 4x fewer table bytes
    so it is modeled faster, the prior tier is a constant lookup — which is
    what lets a drill's breaker trip on a slow primary and recover on a
    degraded tier.

    The costs are *modeled*, not measured: no chip ever timed them, and they
    say nothing of how fast any tier runs. The deterministic drills need
    them exactly as they are.
    """

    DEFAULT: Dict[str, Tuple[float, float]] = {
        "primary": (2.0e-3, 2.0e-5),
        "int8": (1.2e-3, 1.2e-5),
        "prior": (5.0e-5, 0.0),
    }

    def __init__(self, costs: Dict[str, Tuple[float, float]] = None):
        self.costs = dict(self.DEFAULT)
        if costs:
            self.costs.update(costs)

    def __call__(self, tier: str, bucket: int) -> float:
        base, per_item = self.costs[tier]
        return base + per_item * int(bucket)
