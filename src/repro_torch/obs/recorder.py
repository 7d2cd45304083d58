"""The Recorder: one object tying sinks, spans, counters, and gauges together.

Port of ``repro.obs.recorder``; :meth:`Recorder.process_stats` reads the
CUDA device's memory through ``torch.cuda`` under the JAX version's keys.

Design rules (the "zero-sync" contract):

* A recorder with no sinks is **disabled**: ``emit`` is a no-op, spans only
  touch the host ring buffer, counters are plain float adds. Nothing in the
  default configuration can slow a hot path by more than a dict lookup.
* Every span is also a ``record_function`` range while a
  ``torch.profiler`` is collecting, and nothing more while none is.
* *Detail* spans and counters (``detail=True``: one per serving call,
  training chunk or prefetched item) are kept in the ring and in
  :attr:`Recorder.detail_counters` but never reach the sinks, so the event
  stream does not grow with every call. ``--trace-out`` exports both.
* Recorders only ever see host values. Device telemetry is drained by the
  training loop on its own schedule (once per chunk, from pinned host
  memory, one chunk behind — see
  :class:`repro_torch.obs.telemetry.TelemetryDrain`); the recorder is
  handed numpy, never a live CUDA tensor.
* Everything is thread-safe: the streaming loader's read-ahead producer
  emits from its own thread.

A process-global default recorder (``get_recorder()``/``configure(...)``)
lets deep layers (the streaming loader, the watchdog) emit without
plumbing a recorder argument through every constructor; tests inject their
own recorder + :class:`~repro_torch.obs.sinks.MemorySink` instead.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable

import torch

from repro_torch.obs.events import make_event
from repro_torch.obs.sinks import MetricsSink
from repro_torch.obs.spans import SpanTracer, write_chrome_trace


class Recorder:
    def __init__(self, sinks: Iterable[MetricsSink] = (),
                 span_capacity: int = 8192):
        self.sinks = list(sinks)
        self.tracer = SpanTracer(capacity=span_capacity)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.detail_counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    # -- emission ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self.sinks)

    def emit(self, event: Dict[str, Any]) -> None:
        for sink in self.sinks:
            sink.emit(event)

    def metric(self, name: str, value, **fields) -> None:
        if self.sinks:
            self.emit(make_event("metric", name, value, **fields))

    def event(self, name: str, value=None, **fields) -> None:
        if self.sinks:
            self.emit(make_event("event", name, value, **fields))

    # -- spans -------------------------------------------------------------
    def span(self, name: str, *, detail: bool = False, **tags):
        """Time a block on the host (see :class:`SpanTracer`). Always
        recorded in the ring buffer; unless ``detail``, forwarded to sinks
        as a ``span`` event (value = seconds) when any are attached."""
        on_close = self._span_to_sinks if self.sinks and not detail else None
        return self.tracer.span(name, on_close=on_close, detail=detail,
                                **tags)

    def _span_to_sinks(self, s):
        self.emit(make_event("span", s.name, s.duration,
                             t=self.tracer.wall(s.t_start), **s.tags))

    def chrome_trace(self) -> Dict[str, Any]:
        """The ring's spans, then every counter, gauge and detail counter
        as a counter event (``"ph": "C"``) at the time of the call."""
        trace = self.tracer.chrome_trace()
        pid, ts = os.getpid(), self.tracer.wall(time.perf_counter()) * 1e6
        values = {**self.counters_snapshot(), **self.detail_snapshot()}
        trace["traceEvents"] += [
            {"name": k, "ph": "C", "pid": pid, "ts": ts, "cat": "clax",
             "args": {"value": v}} for k, v in sorted(values.items())]
        return trace

    def export_chrome_trace(self, path: str) -> int:
        return write_chrome_trace(self.chrome_trace(), path)

    # -- counters / gauges ---------------------------------------------------
    def add(self, counter: str, amount=1, *, detail: bool = False) -> None:
        """Accumulate a monotone counter (bytes read, retries, ...); a
        ``detail`` one into :attr:`detail_counters`, which no
        :meth:`flush_counters` emits."""
        with self._lock:
            into = self.detail_counters if detail else self.counters
            into[counter] = into.get(counter, 0) + amount

    def gauge(self, name: str, value) -> None:
        """Record the last observed value (queue depth, ...)."""
        with self._lock:
            self.gauges[name] = value

    def counters_snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            out.update({f"{k}:gauge": v for k, v in self.gauges.items()})
        return out

    def detail_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.detail_counters)

    def flush_counters(self, name: str = "counters", **fields) -> None:
        """Emit one ``counters`` event with the current snapshot."""
        if self.sinks:
            snap = self.counters_snapshot()
            if snap:
                self.emit(make_event("counters", name, data=snap, **fields))

    # -- process stats -------------------------------------------------------
    def process_stats(self, name: str = "process", emit: bool = True,
                      **fields) -> Dict[str, Any]:
        """Host RSS + the current CUDA device's memory (``device_bytes_in_use``,
        ``device_peak_bytes_in_use``, ``device_bytes_limit``: the caching
        allocator's allocated and peak allocated bytes, and the card's
        total memory). Without a CUDA device, host RSS only, as JAX's
        CPU backend reports no device stats."""
        stats: Dict[str, Any] = {"rss_bytes": _rss_bytes()}
        stats.update(_cuda_memory())
        if emit and self.sinks:
            self.emit(make_event("process", name, data=stats, **fields))
        return stats

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


def _cuda_memory() -> Dict[str, int]:
    """The current CUDA device's memory under JAX's ``memory_stats`` keys;
    empty where this process has not initialized CUDA (no context is made
    here). Reads allocator counters and the device's properties: no device
    sync."""
    if not torch.cuda.is_initialized():
        return {}
    index = torch.cuda.current_device()
    return {"device_bytes_in_use": int(torch.cuda.memory_allocated(index)),
            "device_peak_bytes_in_use":
                int(torch.cuda.max_memory_allocated(index)),
            "device_bytes_limit":
                int(torch.cuda.get_device_properties(index).total_memory)}


def _rss_bytes() -> int:
    """Resident set size; /proc on Linux, ru_maxrss (peak) as the fallback."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# -- the process-global default recorder -------------------------------------
_global_recorder = Recorder()


def get_recorder() -> Recorder:
    return _global_recorder


def set_recorder(recorder: Recorder) -> Recorder:
    global _global_recorder
    _global_recorder = recorder
    return recorder


def configure(sinks: Iterable[MetricsSink] = (),
              span_capacity: int = 8192) -> Recorder:
    """Replace the global recorder (e.g. from a CLI's ``--metrics-out``)."""
    return set_recorder(Recorder(sinks=sinks, span_capacity=span_capacity))


def span(name: str, **tags):
    """Module-level convenience: a span on the current global recorder."""
    return get_recorder().span(name, **tags)
