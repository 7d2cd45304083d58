"""The share of the traced scoring sub-window in which no kernel, copy or
set ran on the device."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
