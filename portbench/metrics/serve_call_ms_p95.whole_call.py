"""The 95th percentile of the window's host-timed serving calls, in ms,
every call counted, the traced ones among them. A per-layer metric: from
run to run it swings with the host's stalls too widely to hold a bound
end to end (PERF.md section 2)."""
import numpy as np


def read(ctx):
    calls = ctx.get("call_s")
    if not calls:
        return None
    return float(np.percentile(calls, 95)) * 1e3
