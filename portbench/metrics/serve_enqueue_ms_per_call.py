"""Host ms a traced serving call spends enqueueing ``predict_clicks`` (the
program's ``serve_bulk.predict`` spans on the driving thread)."""
from yardstick import spans


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    found = spans.spans(trace, "serve_bulk.predict", trace.main_thread)
    if not len(found):
        return None
    return float((found[:, 1] - found[:, 0]).mean()) * 1e3
