"""The share of the traced serving sub-window in which the device is idle
while the program's ``serve_bulk`` span is open on the driving thread;
the rest of ``device_idle_pct.serve`` falls between calls, in the
caller."""
from yardstick import spans


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    calls = spans.spans(trace, "serve_bulk", trace.main_thread)
    if not len(calls):
        return None
    open_s = float((calls[:, 1] - calls[:, 0]).sum())
    idle_s = open_s - spans.overlap_s(calls, trace.busy_intervals())
    return 100.0 * idle_s / trace.window_s
