"""Device ms a serving call spends in kernels, from the trace of
``calls_traced`` whole calls."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    seconds = trace.kernel_s()
    if seconds <= 0:
        return None
    return seconds / ctx["calls_traced"] * 1e3
