"""The whole scoring call's share of one H100's bf16 peak: the call's least
time by the frozen arithmetic (``yardstick/lm_cost.py``: every token
through every layer, the causal attention's scores, the head over the
scored positions, at 989 TFLOP/s, or the weights read once at 3.35 TB/s)
over the measured host time a call in the window, the profiler's own
start and stop taken out."""


def read(ctx):
    if not ctx.get("calls") or "bound_s" not in ctx:
        return None
    per_call = (ctx["window_s"] - ctx["overhead_s"]) / ctx["calls"]
    return 100.0 * ctx["bound_s"]["call"] / per_call
