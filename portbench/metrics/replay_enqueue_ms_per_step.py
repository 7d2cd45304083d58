"""Host ms a step spent launching the chunks' CUDA graphs: the traced
``cudaGraphLaunch`` calls, over the steps they launched."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    n, seconds = trace.host_calls("cudaGraphLaunch")
    if not n:
        return None
    return seconds / (n * ctx["chunk"]) * 1e3
