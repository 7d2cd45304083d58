"""Bounded admission queue with load shedding and backpressure.

Copied from ``repro.serve.queue`` (numpy only).

Admission control is the first line of overload defense: above the shed
watermark new requests are rejected immediately with a reason (cheap,
explicit, and keeps queueing delay bounded — a deep queue just converts
overload into deadline misses); between the backpressure watermark and the
shed watermark requests are admitted but flagged, which a closed-loop
client uses to slow its offered rate. Depth is tracked globally (one
process, one memory budget) while requests queue per model so the batcher
can form single-model batches.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, Optional

from repro_torch.serve.request import ServeRequest

ADMIT = "admit"
ADMIT_BACKPRESSURE = "admit_backpressure"
SHED_OVERLOAD = "shed_overload"
SHED_QUEUE_FULL = "shed_queue_full"


class AdmissionQueue:
    def __init__(self, capacity: int = 256,
                 shed_watermark: Optional[int] = None,
                 backpressure_watermark: Optional[int] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.shed_watermark = int(shed_watermark if shed_watermark is not None
                                  else max(1, (capacity * 3) // 4))
        self.backpressure_watermark = int(
            backpressure_watermark if backpressure_watermark is not None
            else max(1, capacity // 2))
        if not (self.backpressure_watermark <= self.shed_watermark
                <= self.capacity):
            raise ValueError("watermarks must satisfy backpressure <= shed "
                             "<= capacity")
        self._queues: Dict[str, Deque[ServeRequest]] = {}
        self._depth = 0

    # -- admission -----------------------------------------------------------
    def offer(self, req: ServeRequest, now: float) -> str:
        """Admit or shed. Returns one of the ADMIT_*/SHED_* outcomes; on
        admit the request is stamped with ``admit_s = now`` and enqueued."""
        if self._depth >= self.capacity:
            return SHED_QUEUE_FULL
        if self._depth >= self.shed_watermark:
            return SHED_OVERLOAD
        req.admit_s = now
        self._queues.setdefault(req.model, collections.deque()).append(req)
        self._depth += 1
        if self._depth > self.backpressure_watermark:
            return ADMIT_BACKPRESSURE
        return ADMIT

    # -- consumption (batcher side) ------------------------------------------
    @property
    def depth(self) -> int:
        return self._depth

    def models(self):
        """Model names with queued requests, in insertion order."""
        return [m for m, q in self._queues.items() if q]

    def peek(self, model: str) -> Optional[ServeRequest]:
        q = self._queues.get(model)
        return q[0] if q else None

    def depth_of(self, model: str) -> int:
        return len(self._queues.get(model, ()))

    def pop(self, model: str, n: int):
        """Pop up to ``n`` oldest requests for ``model`` (FIFO)."""
        q = self._queues.get(model)
        out = []
        while q and len(out) < n:
            out.append(q.popleft())
        self._depth -= len(out)
        return out

    def remove_if(self, model: str, predicate):
        """Remove and return every queued request of ``model`` matching
        ``predicate`` (deadline reaping), preserving FIFO order of the
        survivors."""
        q = self._queues.get(model)
        if not q:
            return []
        removed = [r for r in q if predicate(r)]
        if removed:
            kept = [r for r in q if not predicate(r)]
            q.clear()
            q.extend(kept)
            self._depth -= len(removed)
        return removed
