"""``repro_torch.obs`` — observability with no host sync: on-device metrics
drained with the loss stream, host wall-time spans with Chrome-trace
export, pluggable event sinks, counters/gauges, process stats, and
programmatic profiler windows (port of ``repro.obs``)."""
from repro_torch.obs.events import EVENT_KINDS, make_event, validate_event
from repro_torch.obs.profiler import ProfileWindow, parse_profile_steps
from repro_torch.obs.recorder import (Recorder, configure, get_recorder,
                                      set_recorder, span)
from repro_torch.obs.sinks import (ConsoleReporter, JsonlSink, MemorySink,
                                   MetricsSink, read_jsonl)
from repro_torch.obs.spans import Span, SpanTracer
from repro_torch.obs.telemetry import TelemetryDrain

__all__ = [
    "EVENT_KINDS",
    "make_event",
    "validate_event",
    "Recorder",
    "configure",
    "get_recorder",
    "set_recorder",
    "span",
    "MetricsSink",
    "MemorySink",
    "JsonlSink",
    "ConsoleReporter",
    "read_jsonl",
    "Span",
    "SpanTracer",
    "TelemetryDrain",
    "ProfileWindow",
    "parse_profile_steps",
]
