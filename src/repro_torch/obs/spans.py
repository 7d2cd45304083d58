"""Nested host spans with a bounded ring buffer, parent ids, Chrome-trace
export and a mirror into ``torch.profiler``.

Adapted from ``repro.obs.spans``.

``SpanTracer.span("epoch")`` is a context manager timing host time only —
no device syncs, no ``torch.cuda.synchronize`` — so wrapping the train
loop in spans cannot serialize the dispatch pipeline it is measuring. What
a span *sees* is therefore host-side time: an epoch span covers dispatch +
drain, not device busy time. While a ``torch.profiler`` is collecting,
each span also opens a ``record_function`` range of its name on its
thread, so it lands in the profiler's trace on the profiler's clock,
beside the device activity; with no profiler, no range is made.

A span's start and length come from one monotonic clock
(``time.perf_counter``); the export turns starts into epoch microseconds
with one offset taken when the tracer is made, so spans of different
threads order as they ran. Each span has an id and its parent's (the span
open around it on its thread). A *detail* span (one per call, chunk or
item) is marked as such, takes its parent's request tags
(:data:`REQUEST_TAGS`) where it sets none, and is kept out of the
recorder's sinks; the others keep their tags as given.

Completed spans land in a ``deque(maxlen=capacity)`` ring buffer (old spans
fall off; a week-long run cannot OOM on its own telemetry) and are
exportable as Chrome-trace JSON (``chrome://tracing`` / Perfetto's
"Open trace file").
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: Tags that name the request a span serves: a serving call, a training
#: chunk, a prefetched item.
REQUEST_TAGS = ("call", "chunk", "item")

_profiler_enabled = torch._C._autograd._profiler_enabled


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` is collecting. The Python flag holds on
    every thread, also where the profiler's state is global
    (``profile_all_threads``) and the thread-local check reads false."""
    return _autograd_profiler._is_profiler_enabled or _profiler_enabled()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    t_start: float        # seconds on the tracer's clock (perf_counter)
    duration: float       # seconds, the same clock
    thread_id: int
    tags: Dict[str, Any]
    span_id: int = 0
    parent_id: Optional[int] = None  # the span open around it, same thread
    detail: bool = False


class _Open:
    """One span while it is open (what ``SpanTracer.span`` returns)."""

    __slots__ = ("tracer", "name", "tags", "on_close", "detail", "span_id",
                 "parent_id", "t0", "_range")

    def __init__(self, tracer, name, tags, on_close, detail):
        self.tracer = tracer
        self.name = name
        self.tags = tags
        self.on_close = on_close
        self.detail = detail
        self._range = None

    def __enter__(self) -> "_Open":
        stack = self.tracer._stack()
        if stack:
            parent = stack[-1]
            self.parent_id = parent.span_id
            if self.detail:
                for key in REQUEST_TAGS:
                    if key in parent.tags and key not in self.tags:
                        self.tags[key] = parent.tags[key]
        else:
            self.parent_id = None
        self.span_id = next(self.tracer._ids)
        stack.append(self)
        if profiler_active():
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        duration = time.perf_counter() - self.t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.tracer._stack().pop()
        s = Span(self.name, self.t0, duration, threading.get_ident(),
                 self.tags, self.span_id, self.parent_id, self.detail)
        self.tracer.spans.append(s)
        if self.on_close is not None:
            self.on_close(s)
        return False


class SpanTracer:
    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self.spans: deque = deque(maxlen=self.capacity)
        #: epoch seconds minus the tracer's clock, taken once
        self.epoch_offset = time.time() - time.perf_counter()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[_Open]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, on_close=None, detail: bool = False,
             **tags) -> _Open:
        """Time a block; record a :class:`Span` on exit (even on error).

        ``on_close(span)`` lets the recorder forward the completed span to
        its sinks without this module depending on them. Entering gives the
        open span, whose ``tags`` may still be added to.
        """
        return _Open(self, name, tags, on_close, detail)

    def wall(self, t: float) -> float:
        """A time on the tracer's clock in epoch seconds."""
        return t + self.epoch_offset

    def clear(self):
        self.spans.clear()

    def chrome_trace(self) -> Dict[str, Any]:
        """The ring buffer as a Chrome-trace/Perfetto ``traceEvents`` dict.

        Complete events (``"ph": "X"``) with epoch-microsecond timestamps;
        the recording thread becomes the trace ``tid``, so the staging
        thread's spans land on their own track next to the train loop's.
        ``args`` holds the tags with ``span_id`` and ``parent_id``.
        """
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for s in list(self.spans):
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": s.thread_id,
                "ts": self.wall(s.t_start) * 1e6, "dur": s.duration * 1e6,
                "cat": "clax.detail" if s.detail else "clax",
                "args": {**s.tags, "span_id": s.span_id,
                         "parent_id": s.parent_id},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> int:
        """Write the Chrome-trace JSON to ``path``; returns #events."""
        return write_chrome_trace(self.chrome_trace(), path)


def write_chrome_trace(trace: Dict[str, Any], path: str) -> int:
    """Write a ``traceEvents`` dict to ``path`` as JSON; returns #events."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
