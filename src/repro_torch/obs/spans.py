"""Nested wall-time spans with a bounded ring buffer and Chrome-trace export.

Copied from ``repro.obs.spans``.

``SpanTracer.span("epoch")`` is a context manager timing host wall-clock
only — no device syncs, no ``torch.cuda.synchronize`` — so wrapping the train
loop in spans cannot serialize the dispatch pipeline it is measuring. What a
span *sees* is therefore host-side time: an epoch span covers dispatch +
drain, not device busy time (use the ``torch.profiler`` window in
:mod:`repro_torch.obs.profiler` for device timelines).

Completed spans land in a ``deque(maxlen=capacity)`` ring buffer (old spans
fall off; a week-long run cannot OOM on its own telemetry) and are
exportable as Chrome-trace JSON (``chrome://tracing`` / Perfetto's
"Open trace file").
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    t_start: float        # wall-clock seconds (time.time epoch)
    duration: float       # seconds, from perf_counter
    thread_id: int
    tags: Dict[str, Any]


class SpanTracer:
    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self.spans: deque = deque(maxlen=self.capacity)
        self._depth = threading.local()

    @contextmanager
    def span(self, name: str, on_close=None, **tags):
        """Time a block; record a :class:`Span` on exit (even on error).

        ``on_close(span)`` lets the recorder forward the completed span to
        its sinks without this module depending on them.
        """
        depth = getattr(self._depth, "d", 0)
        self._depth.d = depth + 1
        t_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self._depth.d = depth
            s = Span(name=name, t_start=t_wall, duration=dur,
                     thread_id=threading.get_ident(), tags=dict(tags))
            self.spans.append(s)
            if on_close is not None:
                on_close(s)

    def clear(self):
        self.spans.clear()

    def chrome_trace(self) -> Dict[str, Any]:
        """The ring buffer as a Chrome-trace/Perfetto ``traceEvents`` dict.

        Complete events (``"ph": "X"``) with microsecond timestamps; the
        recording thread becomes the trace ``tid``, so loader read-ahead
        spans land on their own track next to the train loop's.
        """
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for s in list(self.spans):
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": s.thread_id,
                "ts": s.t_start * 1e6, "dur": s.duration * 1e6,
                "cat": "clax", "args": s.tags,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> int:
        """Write the Chrome-trace JSON to ``path``; returns #events."""
        trace = self.chrome_trace()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])
