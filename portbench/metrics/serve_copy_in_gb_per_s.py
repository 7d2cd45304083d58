"""The rate of a serving call's copy in: the bytes a call copies to the
device (the program's detail counters ``serve_bulk.bytes_in`` over
``serve_bulk.calls``) over the mean host length of the traced
``serve_bulk.copy_in`` spans on the driving thread."""
from yardstick import spans


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    found = spans.spans(trace, "serve_bulk.copy_in", trace.main_thread)
    if not len(found):
        return None
    from repro_torch.obs import get_recorder

    counters = getattr(get_recorder(), "detail_counters", {})
    calls = counters.get("serve_bulk.calls")
    if not calls:
        return None
    per_call = counters["serve_bulk.bytes_in"] / calls
    return per_call / float((found[:, 1] - found[:, 0]).mean()) / 1e9
