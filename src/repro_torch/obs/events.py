"""Structured telemetry events: the one record type every sink speaks.

Copied from ``repro.obs.events``.

An event is a flat JSON-able dict. Required fields:

* ``kind`` — one of :data:`EVENT_KINDS`:
    - ``"metric"``   — one numeric sample (``value``) of a named series,
      e.g. per-step loss/grad-norm drained from the engine;
    - ``"span"``     — a completed wall-time span (``value`` = seconds);
    - ``"event"``    — a discrete occurrence (quarantine, watchdog restart,
      watchdog violation, profiler window open/close);
    - ``"counters"`` — a snapshot of monotonically accumulated counters and
      last-value gauges (``data``);
    - ``"process"``  — host/device process stats (RSS, device memory);
    - ``"roofline"`` — static HLO cost of a compiled program (``data``);
    - ``"epoch"``    — one trainer epoch record (``data`` mirrors history).
* ``name`` — the series/span/occurrence name (``"train_step"``,
  ``"shard_read"``, ...).
* ``t`` — host wall-clock seconds (``time.time()``).

Optional, uniform across kinds so downstream tooling can group/filter:
``value`` (float), ``step``/``epoch``/``replica`` (ints — the engine's
global step, the trainer epoch, the sweep replica index), ``data`` (a
JSON-able dict payload), plus free-form scalar ``tags``.

``validate_event`` is the schema contract: tests and the CI obs-smoke job
run every JSONL line through it.
"""
from __future__ import annotations

import numbers
import time
from typing import Any, Dict, Optional

EVENT_KINDS = ("metric", "span", "event", "counters", "process", "roofline",
               "epoch")

_INT_FIELDS = ("step", "epoch", "replica")


def make_event(kind: str, name: str, value: Optional[float] = None, *,
               step: Optional[int] = None, epoch: Optional[int] = None,
               replica: Optional[int] = None,
               data: Optional[Dict[str, Any]] = None,
               t: Optional[float] = None, **tags) -> Dict[str, Any]:
    """Build a schema-valid event dict (unset optional fields are omitted)."""
    e: Dict[str, Any] = {"kind": kind, "name": name,
                         "t": time.time() if t is None else float(t)}
    if value is not None:
        e["value"] = float(value)
    for field, v in (("step", step), ("epoch", epoch), ("replica", replica)):
        if v is not None:
            e[field] = int(v)
    if data is not None:
        e["data"] = data
    if tags:
        e["tags"] = {k: _scalarize(v) for k, v in tags.items()}
    return e


def _scalarize(v):
    """Coerce numpy scalars etc. into JSON-able python scalars."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    return str(v)


def validate_event(e: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ``ValueError`` unless ``e`` is a schema-valid event; returns it."""
    if not isinstance(e, dict):
        raise ValueError(f"event must be a dict, got {type(e).__name__}")
    for field in ("kind", "name", "t"):
        if field not in e:
            raise ValueError(f"event missing required field {field!r}: {e}")
    if e["kind"] not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {e['kind']!r} "
                         f"(expected one of {EVENT_KINDS})")
    if not isinstance(e["name"], str) or not e["name"]:
        raise ValueError(f"event name must be a non-empty string: {e}")
    if not isinstance(e["t"], numbers.Real):
        raise ValueError(f"event t must be a number: {e}")
    if "value" in e and not isinstance(e["value"], numbers.Real):
        raise ValueError(f"event value must be a number: {e}")
    for field in _INT_FIELDS:
        if field in e and not isinstance(e[field], numbers.Integral):
            raise ValueError(f"event {field} must be an int: {e}")
    if "data" in e and not isinstance(e["data"], dict):
        raise ValueError(f"event data must be a dict: {e}")
    if "tags" in e and not isinstance(e["tags"], dict):
        raise ValueError(f"event tags must be a dict: {e}")
    return e
