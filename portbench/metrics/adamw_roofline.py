"""The ``adamw`` kernels' share of their roofline: a step's frozen bound
(28 bytes an element) over their traced device time a step (their time
over their launches, times the launches a step)."""

PATTERN = r"(?<!sparse_)adamw_kernel"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    n, seconds = trace.kernels(PATTERN)
    if not n:
        return None
    per_step = seconds / n * ctx["launches_per_step"]["adamw"]
    return 100.0 * ctx["bound_s"]["adamw"] / per_step
