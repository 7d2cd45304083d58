"""Device ms a scoring call spends in the kernels launched inside the
program's ``lm.attention`` spans (every layer's MLA sublayer), from the
profiler's events of ``calls_traced`` whole calls."""


def read(ctx):
    seconds = ctx.get("span_device_s", {}).get("lm.attention", 0.0)
    if seconds <= 0 or not ctx.get("calls_traced"):
        return None
    return seconds / ctx["calls_traced"] * 1e3
