"""Deadline-aware dynamic batching policy.

Copied from ``repro.serve.batcher`` (numpy only).

The batcher answers one question per model per loop iteration: *dispatch
now, or wait for more batch-mates — and if waiting, until when?* Three
dispatch triggers:

1. **Slack exhausted** — the oldest queued request's remaining slack is
   down to the estimated service time of the bucket we would use (plus a
   safety margin): waiting any longer risks its deadline. This is the
   invariant behind the deadline-hit guarantee: a batch is never
   dispatched so late that its *oldest* member cannot be answered in time
   (to the accuracy of the service-time estimate; exact under a
   :class:`~repro_torch.serve.clock.VirtualClock`).
2. **Full batch** — the queue holds a max-bucket's worth of requests;
   waiting buys nothing.
3. **Max wait** — a light-traffic bound so a lone request is never held
   hostage for batch-mates that aren't coming.

Requests whose deadline cannot be met *even if dispatched alone right
now* are reaped before planning and shed with ``deadline_unmeetable`` —
running a batch we already know is late would only make every later
request later.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.serve.queue import AdmissionQueue
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.request import ServeRequest


@dataclasses.dataclass
class BatchPlan:
    model: str
    tier: str
    bucket: int
    requests: List[ServeRequest]


class DeadlineBatcher:
    def __init__(self, registry: ModelRegistry, max_wait_s: float = 0.005,
                 slack_margin_s: float = 0.001):
        self.registry = registry
        self.max_wait_s = float(max_wait_s)
        self.slack_margin_s = float(slack_margin_s)

    # -- deadline reaping ----------------------------------------------------
    def reap_unmeetable(self, queue: AdmissionQueue, model: str, tier: str,
                        now: float) -> List[ServeRequest]:
        """Remove queued requests that cannot meet their deadline even in
        the smallest bucket dispatched immediately."""
        floor = self.registry[model].estimate(tier, self.registry.buckets[0])
        return queue.remove_if(
            model, lambda r: r.deadline_abs() - now < floor)

    # -- dispatch decision ---------------------------------------------------
    def plan(self, queue: AdmissionQueue, model: str, tier: str, now: float,
             flush: bool = False) -> Optional[BatchPlan]:
        """A BatchPlan if ``model`` should dispatch now, else ``None``.
        ``flush`` (drain mode) dispatches whatever is queued immediately."""
        depth = queue.depth_of(model)
        if depth == 0:
            return None
        entry = self.registry[model]
        n = min(depth, self.registry.max_bucket)
        bucket = self.registry.choose_bucket(n)
        oldest = queue.peek(model)
        est = entry.estimate(tier, bucket)
        # Trigger times are computed with the *same expressions* as
        # next_decision_time so that advancing the clock to a returned
        # decision time always fires (float addition is not associative:
        # (admit + wait) - admit can round below wait).
        slack_trigger = oldest.deadline_abs() - est - self.slack_margin_s
        wait_trigger = oldest.admit_s + self.max_wait_s
        if (flush
                or depth >= self.registry.max_bucket
                or now >= slack_trigger
                or now >= wait_trigger):
            return BatchPlan(model=model, tier=tier, bucket=bucket,
                             requests=queue.pop(model, n))
        return None

    def next_decision_time(self, queue: AdmissionQueue, model: str,
                           tier: str, now: float) -> Optional[float]:
        """Earliest future time at which :meth:`plan` would fire for
        ``model`` with no further arrivals (the event loop's sleep bound)."""
        depth = queue.depth_of(model)
        if depth == 0:
            return None
        entry = self.registry[model]
        bucket = self.registry.choose_bucket(
            min(depth, self.registry.max_bucket))
        oldest = queue.peek(model)
        est = entry.estimate(tier, bucket)
        slack_trigger = oldest.deadline_abs() - est - self.slack_margin_s
        wait_trigger = oldest.admit_s + self.max_wait_s
        return max(now, min(slack_trigger, wait_trigger))
