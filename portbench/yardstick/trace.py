"""The traced sub-window: ``torch.profiler`` opened and closed by the
benchmark on the thread that drives the card, and its reduction to what
the per-layer metrics read.

The window is marked by a ``portbench.traced`` annotation opened right
after the profiler starts and closed right before it stops, so its bounds
are in the trace's own clock. Device activity (kernels, copies, sets) is
clipped to it; ``busy_s`` is the union of that activity, ``window_s`` the
annotation's length. Host work is every CPU-side event of the trace (ops,
the CUDA runtime's calls, the benchmark's own ``portbench.*`` spans) with
its thread.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

MARK = "portbench.traced"
#: Entries of each list in ``breakdown``.
TOP = 10
#: Longest names kept in ``breakdown``.
NAME_CHARS = 100


class Profiled:
    """A profiler window the caller opens with :meth:`start` and closes
    with :meth:`stop`, on one thread; ``overhead_s`` is the host time the
    two took, which the caller may take out of its own clock."""

    def __init__(self):
        self.prof = None
        self._mark = None
        self.overhead_s = 0.0
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        t0 = time.perf_counter()
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:  # every thread's host events, the staging thread's too
            from torch._C._profiler import _ExperimentalConfig

            self.prof = profile(activities=activities,
                                experimental_config=_ExperimentalConfig(
                                    profile_all_threads=True))
        except (ImportError, TypeError):
            self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self.overhead_s += time.perf_counter() - t0

    def stop(self) -> None:
        t0 = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = True
        self.overhead_s += time.perf_counter() - t0

    def trace(self) -> Optional["Trace"]:
        return Trace.from_profiler(self.prof) if self.done else None


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _union(spans: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering ``spans`` ((n, 2) array)."""
    if not len(spans):
        return spans.reshape(0, 2)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    out = [list(spans[0])]
    for s, e in spans[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


class Trace:
    """Seconds on the trace's clock. ``device``: (name, start, end, is_copy)
    clipped to the window; ``host``: (name, start, end, thread)."""

    def __init__(self, device: List[Tuple[str, float, float, bool]],
                 host: List[Tuple[str, float, float, int]],
                 window: Tuple[float, float], main_thread: int):
        self.device = device
        self.host = host
        self.window = window
        self.main_thread = main_thread

    @classmethod
    def from_profiler(cls, prof) -> Optional["Trace"]:
        from torch.autograd import DeviceType

        events = prof.events()
        marks = [e for e in events
                 if e.name == MARK and e.device_type == DeviceType.CPU]
        if not marks:
            return None
        w0 = marks[0].time_range.start * 1e-6
        w1 = marks[0].time_range.end * 1e-6
        device, host = [], []
        for e in events:
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or \
                        e.name.startswith("portbench."):
                    continue  # a span's shadow on the device, no work
                s, t = max(s, w0), min(t, w1)
                if t > s:
                    copy = e.name.startswith(("Memcpy", "Memset"))
                    device.append((e.name, s, t, copy))
            elif e.name != MARK:
                host.append((e.name, s, t, e.thread))
        return cls(device, host, (w0, w1), marks[0].thread)

    # -- totals ------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> np.ndarray:
        return _union(np.asarray([(s, t) for _, s, t, _ in self.device],
                                 dtype=np.float64).reshape(-1, 2))

    def busy_s(self) -> float:
        u = self.busy_intervals()
        return float((u[:, 1] - u[:, 0]).sum()) if len(u) else 0.0

    def kernels(self, pattern: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [t - s for name, s, t, copy in self.device
                if not copy and rx.search(name)]
        return len(hits), float(sum(hits))

    def kernel_s(self) -> float:
        return float(sum(t - s for _, s, t, copy in self.device if not copy))

    def copy_s(self) -> float:
        return float(sum(t - s for _, s, t, copy in self.device if copy))

    def host_calls(self, name: str) -> Tuple[int, float]:
        """(calls, host seconds) of the host events whose name starts with
        ``name`` (a runtime call may carry a version suffix)."""
        hits = [t - s for n, s, t, _ in self.host if n.startswith(name)]
        return len(hits), float(sum(hits))

    # -- breakdown ---------------------------------------------------------
    def device_ops(self) -> List[List]:
        """The device operations that took the most time: [name, s]."""
        total: Dict[str, float] = {}
        for name, s, t, _ in self.device:
            total[name] = total.get(name, 0.0) + (t - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[_short(n), v] for n, v in top]

    def idle_gaps(self) -> List[List]:
        """The device's idle time in the window, by what the host was
        doing at each gap's middle: the innermost host event there on the
        driving thread, else on another thread, else none. [name, s]."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = np.concatenate([[w0], busy.reshape(-1), [w1]])
        starts, ends = edges[0::2], edges[1::2]
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        if not len(starts):
            return []
        mids = (starts + ends) / 2
        order = np.argsort(mids)
        mids_sorted = mids[order]
        label = np.full(len(mids), -1, dtype=np.int64)
        # later writes win: other threads first, then the driving thread,
        # longest first, so the innermost event on the driving thread stays
        ranked = sorted(range(len(self.host)), key=lambda i: (
            self.host[i][3] == self.main_thread,
            -(self.host[i][2] - self.host[i][1])))
        for i in ranked:
            _, s, t, _ = self.host[i]
            a = np.searchsorted(mids_sorted, s, side="left")
            b = np.searchsorted(mids_sorted, t, side="right")
            if b > a:
                label[order[a:b]] = i
        total: Dict[str, float] = {}
        for j, (s, t) in enumerate(zip(starts, ends)):
            i = label[j]
            if i < 0:
                name = "no host op traced"
            else:
                name, _, _, thread = self.host[i]
                if thread != self.main_thread:
                    name = "other thread: " + name
            total[name] = total.get(name, 0.0) + float(t - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[_short(n), v] for n, v in top]
