"""The program's own spans in a traced window: the host events that the
port's detail spans put into the profiler's trace (``record_function``
ranges of the same names), reduced to what the per-layer metrics read.
Times are seconds on the trace's clock, as in :class:`trace.Trace`."""
from __future__ import annotations

import numpy as np


def spans(trace, name: str, thread=None) -> np.ndarray:
    """``(n, 2)`` starts and ends of the host events named ``name`` that lie
    wholly inside the window, on ``thread`` where given, by start."""
    w0, w1 = trace.window
    out = sorted((s, t) for n, s, t, th in trace.host
                 if n == name and w0 <= s and t <= w1
                 and (thread is None or th == thread))
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def overlap_s(a: np.ndarray, b: np.ndarray) -> float:
    """Seconds of ``a`` that ``b`` covers; each a set of disjoint
    intervals."""
    if not len(a) or not len(b):
        return 0.0
    total = 0.0
    for s, t in a:
        cut = np.minimum(b[:, 1], t) - np.maximum(b[:, 0], s)
        total += float(cut[cut > 0].sum())
    return total


def inside_s(inner: np.ndarray, outer: np.ndarray) -> float:
    """Seconds of the ``inner`` intervals that lie within ``outer``'s
    (disjoint) intervals."""
    return sum(overlap_s(inner[i:i + 1], outer) for i in range(len(inner)))


def step_chunks(trace) -> np.ndarray:
    """The driving thread's ``train.chunk`` spans that ran whole inside the
    window and ran a step: each one's ``train.step`` is inside it, and the
    next chunk began inside the window too (a range still open when the
    profiler stops is closed at the stop, so the last is left out)."""
    w0, w1 = trace.window
    main = trace.main_thread
    starts = sorted((s, t) for n, s, t, th in trace.host
                    if n == "train.chunk" and th == main and s >= w0)
    whole = [c for c, nxt in zip(starts, starts[1:]) if nxt[0] <= w1]
    steps = spans(trace, "train.step", main)
    out = [(s, t) for s, t in whole
           if ((steps[:, 0] >= s) & (steps[:, 1] <= t)).any()]
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def per_step_ms(ctx, name: str):
    """Host ms a step that the driving thread spent in ``name`` spans inside
    the window's whole chunks (:func:`step_chunks`), or None."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    chunks = step_chunks(trace)
    if not len(chunks):
        return None
    inner = spans(trace, name, trace.main_thread)
    return inside_s(inner, chunks) / (len(chunks) * ctx["chunk"]) * 1e3
