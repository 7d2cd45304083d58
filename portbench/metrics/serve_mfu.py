"""The whole serving call's share of one H100's peak: the call's least
time by the frozen arithmetic (the batch in, the answer out, each 32-byte
table sector its rows lie in read once) over the measured host time a
call in the window, the profiler's own start and stop taken out."""


def read(ctx):
    if not ctx.get("calls") or "bound_s" not in ctx:
        return None
    per_call = (ctx["window_s"] - ctx["overhead_s"]) / ctx["calls"]
    return 100.0 * ctx["bound_s"]["call"] / per_call
