"""The grouped GEMM's share of its roofline: its frozen bound a call (each
grouped product's operations at the bf16 peak, against every expert's
weights and the routed rows in and out at 3.35 TB/s;
``yardstick/lm_cost.py``) over the device time a call of the kernels that
compute it, found in the trace by name (``torch._grouped_mm``'s CUTLASS
kernel over a ``GroupProblemShape``, and any kernel of its that names a
grouped GEMM), over ``calls_traced`` whole calls."""

#: The names of the grouped GEMM's kernels.
KERNELS = r"GroupProblemShape|(?i:grouped_?(gemm|mm))"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "bound_s" not in ctx or not ctx.get("calls_traced"):
        return None
    n, seconds = trace.kernels(KERNELS)
    if not n or seconds <= 0:
        return None
    return 100.0 * ctx["bound_s"]["grouped_mm"] / (
        seconds / ctx["calls_traced"])
