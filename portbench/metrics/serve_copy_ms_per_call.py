"""Device ms a serving call spends copying between host and device (and
setting memory), from the trace of ``calls_traced`` whole calls."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    seconds = trace.copy_s()
    if seconds <= 0:
        return None
    return seconds / ctx["calls_traced"] * 1e3
