"""The whole training step's share of one H100's peak: the step's least
time by the frozen arithmetic (every parameter's p, m and v read and
written once, the batch read once; against 3.35 TB/s and 67 TFLOP/s
float32) over the measured host time a step in the window, the
profiler's own start and stop taken out."""


def read(ctx):
    if not ctx.get("steps"):
        return None
    per_step = (ctx["window_s"] - ctx["overhead_s"]) / ctx["steps"]
    return 100.0 * ctx["bound_s"]["step"] / per_step
