"""The ``examination_nll`` kernel's share of its roofline: its frozen
bound (six float32 inputs and the mask read once) over its traced device
time a launch."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    n, seconds = trace.kernels(r"examination_nll_kernel")
    if not n:
        return None
    per_step = seconds / n * ctx["launches_per_step"]["examination_nll"]
    return 100.0 * ctx["bound_s"]["examination_nll"] / per_step
