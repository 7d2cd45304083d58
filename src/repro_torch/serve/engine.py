"""The serving engine: one event loop tying every resilience layer together.

Copied from ``repro.serve.engine`` (numpy only), importing only the port: its
drain on ``repro_torch.train.fault_tolerance.PreemptionHandler``, its
recorder from ``repro_torch.obs``.

Request lifecycle::

    trace ──► admission ──► queue ──► batcher ──► ladder ──► result
              │  validation   │  watermarks │ deadline-aware │ breakers
              │  (fail closed)│  shed/back- │ bucket padding │ primary→int8
              │               │  pressure   │ pre-compiled   │ →prior
              SIGTERM ════════╪═ drain: stop admitting, flush in-flight ═►

Guarantees (each pinned in tests/test_torch_serve.py):

* every submitted request gets exactly one :class:`ServeResult` — under
  overload, poison floods, injected model failures, and SIGTERM drain;
* a request that fails validation is rejected alone; its would-be
  batch-mates are answered normally;
* traffic never triggers a capture (JAX: a compile) after
  :meth:`ModelRegistry.warmup`;
* model errors and deadline-miss storms trip the per-model breaker down
  the degradation ladder instead of surfacing to callers — the ``prior``
  rung cannot fail, so the engine never crashes and never returns an
  unvalidated answer;
* under a :class:`~repro_torch.serve.clock.VirtualClock` the full outcome
  stream (statuses, tiers, counters) is bit-deterministic.

Telemetry rides the existing :class:`~repro_torch.obs.recorder.Recorder`
schema: counters ``serve.requests / answered / shed / deadline_miss /
degraded / rejected_invalid / backpressure / breaker_transitions``, the
``serve.queue_depth`` gauge, per-dispatch ``serve_batch`` spans,
per-request ``serve_latency_ms`` metrics, and ``breaker_transition`` /
``drain_start`` events.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.serve.batcher import BatchPlan, DeadlineBatcher
from repro_torch.serve.breaker import DegradationLadder
from repro_torch.serve.clock import VirtualClock, WallClock
from repro_torch.serve.queue import (ADMIT, ADMIT_BACKPRESSURE, AdmissionQueue,
                               SHED_OVERLOAD, SHED_QUEUE_FULL)
from repro_torch.serve.registry import ModelRegistry, pad_batch
from repro_torch.serve.request import (OK, REJECTED, SHED, ServeRequest,
                                 ServeResult, TIERS)
from repro_torch.serve.validation import validate_request
from repro_torch.train.fault_tolerance import PreemptionHandler

_SHED_REASONS = {SHED_OVERLOAD: "shed_overload",
                 SHED_QUEUE_FULL: "shed_queue_full"}


class ServeEngine:
    def __init__(self, registry: ModelRegistry,
                 queue: Optional[AdmissionQueue] = None,
                 batcher: Optional[DeadlineBatcher] = None,
                 clock=None, recorder=None,
                 faults: Iterable = (),
                 force_tier: Optional[str] = None,
                 breaker_kwargs: Optional[Dict] = None,
                 log_fn=None):
        if force_tier is not None and force_tier not in TIERS:
            raise ValueError(f"force_tier must be one of {TIERS}")
        self.registry = registry
        self.queue = queue if queue is not None else AdmissionQueue()
        self.batcher = batcher if batcher is not None \
            else DeadlineBatcher(registry)
        self.clock = clock if clock is not None else WallClock()
        if recorder is None:
            from repro_torch.obs import get_recorder

            recorder = get_recorder()
        self.recorder = recorder
        self.faults = list(faults)
        self.force_tier = force_tier
        self.log_fn = log_fn or (lambda *_: None)
        self.ladders: Dict[str, DegradationLadder] = {
            name: DegradationLadder(name, recorder=recorder,
                                    breaker_kwargs=breaker_kwargs)
            for name in registry.entries
        }
        self.stats = collections.Counter()
        self.draining = False
        self._admit_index = 0
        # Engine-local per-model dispatch indices: fault hooks key on these,
        # so a drill replays identically even on a registry warmed by
        # earlier runs (entry.dispatches keeps the lifetime health count).
        self._dispatch_counts = collections.Counter()

    # -- admission -----------------------------------------------------------
    def _finish(self, results: List[ServeResult], req: ServeRequest,
                status: str, reason: Optional[str] = None,
                tier: Optional[str] = None, log_ctr=None,
                latency_s: float = 0.0, deadline_hit: bool = False) -> None:
        results.append(ServeResult(
            request_id=req.request_id, model=req.model, status=status,
            reason=reason, tier=tier, log_ctr=log_ctr, latency_s=latency_s,
            deadline_hit=deadline_hit))

    def _count(self, key: str, amount: int = 1) -> None:
        self.stats[key] += amount
        self.recorder.add(key, amount)

    def _gauge_depth(self) -> None:
        self.recorder.gauge("serve.queue_depth", self.queue.depth)

    def _admit(self, req: ServeRequest, now: float,
               results: List[ServeResult]) -> None:
        index = self._admit_index
        self._admit_index += 1
        for fault in self.faults:
            on_admit = getattr(fault, "on_admit", None)
            if on_admit is not None:
                on_admit(index, req)
        self._count("serve.requests")
        if self.draining:
            self._count("serve.rejected_draining")
            self._finish(results, req, REJECTED, "draining")
            return
        if req.model not in self.registry:
            self._count("serve.rejected_invalid")
            self._finish(results, req, REJECTED, "unknown_model")
            return
        entry = self.registry[req.model]
        reason = validate_request(req, positions=entry.positions,
                                  n_pairs=entry.n_pairs,
                                  feature_dim=entry.feature_dim)
        if reason is not None:
            self._count("serve.rejected_invalid")
            self._finish(results, req, REJECTED, reason)
            return
        outcome = self.queue.offer(req, now)
        if outcome in _SHED_REASONS:
            self._count("serve.shed")
            self._finish(results, req, SHED, _SHED_REASONS[outcome])
        else:
            if outcome == ADMIT_BACKPRESSURE:
                self._count("serve.backpressure")
            assert outcome in (ADMIT, ADMIT_BACKPRESSURE)
        self._gauge_depth()

    # -- dispatch ------------------------------------------------------------
    def _consult_faults(self, model: str, tier: str, bucket: int,
                        dispatch_index: int):
        extra, err = 0.0, None
        for fault in self.faults:
            on_dispatch = getattr(fault, "on_dispatch", None)
            if on_dispatch is None:
                continue
            f_extra, f_err = on_dispatch(model, tier, bucket, dispatch_index)
            extra += f_extra
            err = err or f_err
        return extra, err

    def _execute(self, plan: BatchPlan, results: List[ServeResult]) -> None:
        entry = self.registry[plan.model]
        ladder = self.ladders[plan.model]
        dispatch_index = self._dispatch_counts[plan.model]
        self._dispatch_counts[plan.model] += 1
        entry.dispatches += 1
        batch = pad_batch(plan.requests, plan.bucket, entry)
        out, answered_tier = None, None
        attempted = set()
        for tier in ladder.walk_from(plan.tier):
            attempted.add(tier)
            ladder.begin_attempt(tier)
            extra_s, injected_err = self._consult_faults(
                plan.model, tier, plan.bucket, dispatch_index)
            wall0 = time.perf_counter()
            try:
                if injected_err is not None:
                    raise injected_err
                with self.recorder.span("serve_batch", model=plan.model,
                                        tier=tier, bucket=plan.bucket,
                                        n=len(plan.requests)):
                    out = entry.run(tier, batch)
                ran_ok = True
            except Exception as e:  # fail closed: fall down the ladder
                ran_ok = False
                entry.errors += 1
                self._count("serve.model_errors")
                self.recorder.event(
                    "model_error", data={"model": plan.model, "tier": tier,
                                         "error": type(e).__name__})
                self.log_fn(f"[serve] {plan.model}/{tier} failed "
                            f"({type(e).__name__}: {e}); degrading")
            if self.clock.virtual:
                self.clock.charge(entry.estimate(tier, plan.bucket) + extra_s)
            else:
                if extra_s > 0:
                    time.sleep(extra_s)
                entry.observe(tier, plan.bucket,
                              time.perf_counter() - wall0 + extra_s)
            if ran_ok:
                answered_tier = tier
                break
            ladder.record(tier, ok=False)

        completion = self.clock.now()
        if answered_tier is not None:
            ladder.finish_dispatch(answered_tier, attempted)
        if answered_tier is None:
            # Even the prior rung raised (only reachable via injected
            # faults on "prior"): fail closed per request, never crash.
            for req in plan.requests:
                self._count("serve.shed")
                self._finish(results, req, SHED, "model_failure")
            return
        misses = 0
        for i, req in enumerate(plan.requests):
            latency = completion - req.arrival_s
            hit = completion <= req.deadline_abs()
            misses += 0 if hit else 1
            self._count("serve.answered")
            if not hit:
                self._count("serve.deadline_miss")
            if answered_tier != TIERS[0]:
                self._count("serve.degraded")
            self.recorder.metric("serve_latency_ms", latency * 1e3,
                                 step=req.request_id,
                                 model=req.model, tier=answered_tier)
            self._finish(results, req, OK, tier=answered_tier,
                         log_ctr=out[i], latency_s=latency,
                         deadline_hit=hit)
        ladder.record(answered_tier, ok=(misses == 0))
        self._gauge_depth()

    def _dispatch_due(self, now: float, results: List[ServeResult]) -> bool:
        """Reap unmeetable requests and run every due batch; True if any
        batch was dispatched (time advanced)."""
        dispatched = False
        for model in self.queue.models():
            tier = self.ladders[model].select(self.force_tier)
            for req in self.batcher.reap_unmeetable(
                    self.queue, model, tier, now):
                self._count("serve.shed")
                self._count("serve.deadline_miss")
                self._finish(results, req, SHED, "deadline_unmeetable")
            plan = self.batcher.plan(self.queue, model, tier, now,
                                    flush=self.draining)
            if plan is not None:
                self._execute(plan, results)
                dispatched = True
        if dispatched:
            self._gauge_depth()
        return dispatched

    # -- the event loop ------------------------------------------------------
    def run_trace(self, trace: Iterable[ServeRequest],
                  handle_signals: bool = True) -> List[ServeResult]:
        """Serve a time-ordered arrival trace to completion (or drain).

        ``trace`` yields requests with monotone ``arrival_s``. With
        ``handle_signals`` a :class:`PreemptionHandler` converts
        SIGTERM/SIGINT into a drain: admission stops (remaining arrivals
        are rejected with ``"draining"``), queued requests are flushed
        through the batcher, and the loop exits with zero in-flight drops.
        """
        results: List[ServeResult] = []
        it = iter(trace)
        nxt = next(it, None)
        handler = PreemptionHandler() if handle_signals else None
        try:
            while True:
                now = self.clock.now()
                if (handler is not None and handler.should_stop
                        and not self.draining):
                    self._start_drain(now)
                if self.draining and nxt is not None:
                    # reject the rest of the trace immediately
                    while nxt is not None:
                        self._admit(nxt, now, results)
                        nxt = next(it, None)
                while nxt is not None and nxt.arrival_s <= now:
                    self._admit(nxt, now, results)
                    nxt = next(it, None)
                    if (handler is not None and handler.should_stop
                            and not self.draining):
                        self._start_drain(now)
                        break
                if self._dispatch_due(now, results):
                    continue
                if self.queue.depth == 0:
                    if nxt is None:
                        break
                    self.clock.advance_to(nxt.arrival_s)
                    continue
                candidates = []
                if nxt is not None:
                    candidates.append(nxt.arrival_s)
                for model in self.queue.models():
                    tier = self.ladders[model].select(self.force_tier)
                    t = self.batcher.next_decision_time(
                        self.queue, model, tier, now)
                    if t is not None:
                        candidates.append(t)
                self.clock.advance_to(min(candidates))
        finally:
            if handler is not None:
                handler.restore()
        self.recorder.flush_counters()
        return results

    def _start_drain(self, now: float) -> None:
        self.draining = True
        self._count("serve.drains")
        self.recorder.event("drain_start",
                            data={"queue_depth": self.queue.depth,
                                  "t": float(now)})
        self.log_fn(f"[serve] drain: admission stopped, "
                    f"{self.queue.depth} in flight")

    # -- reporting -----------------------------------------------------------
    def health(self) -> Dict[str, Dict]:
        return {name: dict(self.registry[name].health(),
                           breakers=self.ladders[name].state(),
                           tier=self.ladders[name].select(self.force_tier))
                for name in self.registry.entries}

    def summary(self, results: List[ServeResult]) -> Dict:
        answered = [r for r in results if r.answered]
        lat_ms = np.asarray([r.latency_s * 1e3 for r in answered])
        hits = sum(r.deadline_hit for r in answered)
        return {
            "requests": len(results),
            "answered": len(answered),
            "shed": sum(r.status == SHED for r in results),
            "rejected": sum(r.status == REJECTED for r in results),
            "degraded": sum(r.degraded for r in results),
            "deadline_hit_rate": (hits / len(answered)) if answered else 0.0,
            "p50_ms": float(np.percentile(lat_ms, 50)) if answered else None,
            "p99_ms": float(np.percentile(lat_ms, 99)) if answered else None,
        }
