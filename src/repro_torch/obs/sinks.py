"""Pluggable event sinks: where telemetry events land.

Copied from ``repro.obs.sinks``.

All sinks speak one method, ``emit(event_dict)``, and are safe to call from
multiple threads (the streaming loader's read-ahead producer emits from its
own thread). None of them ever touch a device buffer — events are built
from values the caller already drained to host, which is what keeps the
whole observability layer zero-sync by construction.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.events import validate_event


class MetricsSink:
    """Base sink: ``emit`` one structured event; ``close`` flushes/releases."""

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class MemorySink(MetricsSink):
    """Collects events in a list — the test sink."""

    def __init__(self, validate: bool = True):
        self.events: List[Dict[str, Any]] = []
        self.validate = validate
        self._lock = threading.Lock()

    def emit(self, event):
        if self.validate:
            validate_event(event)
        with self._lock:
            self.events.append(event)

    # -- query helpers (tests) --------------------------------------------
    def by_kind(self, kind: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events if e["kind"] == kind]

    def by_name(self, name: str, kind: Optional[str] = None):
        with self._lock:
            return [e for e in self.events if e["name"] == name
                    and (kind is None or e["kind"] == kind)]

    def series(self, name: str, replica: Optional[int] = None) -> List[float]:
        """The ``value`` sequence of a metric series, in emission order."""
        return [e["value"] for e in self.by_name(name, kind="metric")
                if replica is None or e.get("replica") == replica]

    def __len__(self):
        return len(self.events)


class JsonlSink(MetricsSink):
    """One JSON line per event, appended to ``path``.

    Lines are flushed every ``flush_every`` events (and on ``close``), so a
    crashed run still leaves a usable stream behind — the observability
    analogue of the checkpoint story.
    """

    def __init__(self, path: str, flush_every: int = 64,
                 validate: bool = False):
        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self.validate = validate
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._since_flush = 0

    def emit(self, event):
        if self.validate:
            validate_event(event)
        line = json.dumps(event, separators=(",", ":"))
        with self._lock:
            if self._f.closed:
                return  # late emit after close (daemon reader thread)
            self._f.write(line + "\n")
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._f.flush()
                self._since_flush = 0

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def read_jsonl(path: str, validate: bool = True) -> List[Dict[str, Any]]:
    """Load (and by default schema-check) a JSONL event stream."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            e = json.loads(line)
            if validate:
                validate_event(e)
            out.append(e)
    return out


class ConsoleReporter(MetricsSink):
    """Human-readable periodic reporter.

    Prints every non-metric event as it happens, and one line per
    ``every`` metric samples of each series (per-step metrics at full rate
    would drown a terminal).
    """

    def __init__(self, log_fn: Callable[[str], None] = print,
                 every: int = 100):
        self.log_fn = log_fn
        self.every = max(int(every), 1)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def emit(self, event):
        kind, name = event["kind"], event["name"]
        if kind == "metric":
            with self._lock:
                n = self._counts.get(name, 0)
                self._counts[name] = n + 1
            if n % self.every:
                return
        where = "".join(f" {k}={event[k]}" for k in ("step", "epoch",
                                                     "replica")
                        if k in event)
        value = (f" {event['value']:.6g}" if "value" in event else "")
        data = f" {event['data']}" if "data" in event else ""
        self.log_fn(f"[obs] {kind}/{name}{where}{value}{data}")
