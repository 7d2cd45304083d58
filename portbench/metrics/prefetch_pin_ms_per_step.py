"""Host ms a step the prefetcher's staging thread spent taking a pinned
slot and stacking a chunk into it (the program's ``prefetch.pin`` spans,
one an item of ``chunk`` batches, wholly inside the traced window). None
where the trace holds no other thread's ranges."""
from yardstick import spans


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    pins = spans.spans(trace, "prefetch.pin")
    if not len(pins):
        return None
    return float((pins[:, 1] - pins[:, 0]).mean()) / ctx["chunk"] * 1e3
