"""Device ms a scoring call spends in the kernels launched inside the
program's ``lm.moe`` spans (every MoE layer's router, dispatch, grouped
GEMMs, combine and shared experts), from the profiler's events of
``calls_traced`` whole calls."""


def read(ctx):
    seconds = ctx.get("span_device_s", {}).get("lm.moe", 0.0)
    if seconds <= 0 or not ctx.get("calls_traced"):
        return None
    return seconds / ctx["calls_traced"] * 1e3
