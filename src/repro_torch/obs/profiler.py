"""Programmatic ``torch.profiler`` windows keyed on the global step counter,
port of ``repro.obs.profiler``.

``--profile-steps A:B`` opens a profiler trace just before the chunk that
contains global step A and closes it after the first chunk boundary at or
past B, so the steady-state steps asked for are profiled instead of
hand-timed around the warm-up and the first capture. The trace lands in
``log_dir`` as Chrome-trace JSON (``trace_steps_<A>_<B>.json``, for
Perfetto or ``chrome://tracing``).

The window rides the train loop's chunk boundaries: it adds no host sync
and no dispatch of its own. It traces the host (CPU activity) and, where
CUDA is initialized, the card (CUDA activity, through CUPTI). Nothing
counts from its trace: launch counts come from the kernels' wrappers and
the graphs' kernel nodes. Where the runtime cannot profile, the window
emits its open/close events only and never ends the run.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from repro_torch.obs.recorder import Recorder, get_recorder


def parse_profile_steps(spec: str) -> Tuple[int, int]:
    """``"A:B"`` -> (A, B), validated (0 <= A < B)."""
    try:
        a_txt, b_txt = spec.split(":")
        a, b = int(a_txt), int(b_txt)
    except ValueError:
        raise ValueError(
            f"--profile-steps wants 'START:STOP' (global steps), got {spec!r}")
    if a < 0 or b <= a:
        raise ValueError(
            f"--profile-steps needs 0 <= START < STOP, got {spec!r}")
    return a, b


class ProfileWindow:
    """Open a ``torch.profiler`` trace around chosen chunks.

    The trainer calls :meth:`before_chunk` with the global step the next
    chunk starts at, and :meth:`after_chunk` with the step it ended at; the
    window starts the trace at the first chunk containing ``start_step``
    and stops it at the first boundary >= ``stop_step`` (or on ``close``,
    so a window spanning the end of training still writes its trace).
    ``path`` is the trace file once written.
    """

    def __init__(self, start_step: int, stop_step: int, log_dir: str,
                 recorder: Optional[Recorder] = None):
        if not 0 <= start_step < stop_step:
            raise ValueError(f"need 0 <= start < stop, got "
                             f"({start_step}, {stop_step})")
        self.start_step = int(start_step)
        self.stop_step = int(stop_step)
        self.log_dir = log_dir
        self.recorder = recorder
        self.active = False
        self.done = False
        self.path: Optional[str] = None
        self._prof = None

    def _rec(self) -> Recorder:
        return self.recorder if self.recorder is not None else get_recorder()

    def before_chunk(self, next_step: int) -> None:
        if self.done or self.active or next_step < self.start_step:
            return
        self.active = True
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
            self._prof = prof
        except Exception as e:  # no profiler in this runtime — degrade
            self._prof = None
            self._rec().event("profile_unavailable", step=next_step,
                              error=repr(e))
        self._rec().event("profile_start", step=next_step,
                          log_dir=self.log_dir)

    def after_chunk(self, reached_step: int) -> None:
        if not self.active or reached_step < self.stop_step:
            return
        self._stop(reached_step)

    def close(self, reached_step: Optional[int] = None) -> None:
        """Stop a still-open trace (training ended inside the window)."""
        if self.active:
            self._stop(self.stop_step if reached_step is None
                       else reached_step)

    def _stop(self, step: int) -> None:
        self.active = False
        self.done = True
        prof, self._prof = self._prof, None
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(self.log_dir, exist_ok=True)
                path = os.path.join(
                    self.log_dir,
                    f"trace_steps_{self.start_step}_{self.stop_step}.json")
                prof.export_chrome_trace(path)
                self.path = path
            except Exception as e:
                self._rec().event("profile_stop_failed", step=step,
                                  error=repr(e))
                return
        self._rec().event("profile_stop", step=step, log_dir=self.log_dir)
