"""Fault tolerance: preemption handling, restarts, straggler mitigation,
port of ``repro.train.fault_tolerance``.

1. **Preemption / process loss** — frequent atomic checkpoints (parameters,
   optimizer state, loader state) and resume on restart. The
   :class:`PreemptionHandler` turns SIGTERM/SIGINT into a final checkpoint
   and a clean exit; :func:`run_with_restarts` is the outer supervisor that
   relaunches a crashed training process so it resumes from its newest
   valid checkpoint (``repro_torch.launch.train --max-restarts``).
2. **Stragglers** — :func:`drop_slowest_aggregate` averages the gradients
   of the replicas that met the step deadline; :class:`StepWatchdog` flags
   steps that blow a wall-clock budget (the Trainer's
   ``step_budget_seconds``). Its violations are counted, logged and
   emitted as ``watchdog_violation`` events on the recorder.
"""
from __future__ import annotations

import signal
import subprocess
from typing import Callable, Optional, Sequence

from repro_torch.obs import get_recorder
from repro_torch.tree import tree_map


class PreemptionHandler:
    """Converts SIGTERM/SIGINT into a ``should_stop`` flag the train loop
    polls. A context manager, so the previous signal handlers are restored
    even when the loop raises:

        with PreemptionHandler() as handler:
            for batch in loader:
                ...
                if handler.should_stop:   # checkpoint + exit cleanly
                    ckpt.save(step, state); break
    """

    def __init__(self,
                 signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT),
                 group=None):
        self.should_stop = False
        self.group = group
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        del signum, frame
        self.should_stop = True

    def stop_requested(self) -> bool:
        """Whether any rank was signalled: ``should_stop`` reduced with a
        max over ``group`` (a host-side gloo group; every rank calls this
        at the same step, so all of them stop at that step and none waits
        in a collective the others left). Without a group, this process's
        own flag."""
        if self.group is None:
            return self.should_stop
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(self.should_stop)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        self.should_stop = bool(flag.item())
        return self.should_stop

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.restore()
        return False


def run_with_restarts(argv: Sequence[str], max_restarts: int,
                      log_fn: Callable = print, env=None) -> int:
    """Supervise a training subprocess, relaunching it after crashes.

    Runs ``argv`` (e.g. ``[sys.executable, "-m",
    "repro_torch.launch.train", ...]``); a non-zero exit — killed by the
    OOM killer, preempted, segfaulted — triggers a relaunch with the *same*
    argv, up to ``max_restarts`` times. The child resumes from its
    checkpoint directory (``--ckpt-dir`` does this), which is what makes a
    blind relaunch correct: every attempt converges on the same
    deterministic run. Exit code 0 stops the loop; the final attempt's code
    is returned either way.
    """
    attempt = 0
    while True:
        proc = subprocess.run(list(argv), env=env)
        if proc.returncode == 0:
            if attempt:
                log_fn(f"[restarts] completed after {attempt} restart(s)")
            return 0
        if attempt >= max_restarts:
            log_fn(f"[restarts] attempt {attempt + 1} exited with code "
                   f"{proc.returncode}; restart budget ({max_restarts}) "
                   f"exhausted")
            return proc.returncode
        attempt += 1
        log_fn(f"[restarts] child exited with code {proc.returncode}; "
               f"relaunching (attempt {attempt + 1}/{max_restarts + 1})")


def drop_slowest_aggregate(replica_grads: Sequence, arrived: Sequence[bool]):
    """Aggregate gradient trees from the replicas that met the step
    deadline: their mean (``arrived[i]`` marks replica i on time). Raises if
    no replica arrived."""
    n_arrived = sum(bool(a) for a in arrived)
    if n_arrived == 0:
        raise RuntimeError("no replica gradients arrived before deadline")
    picked = [g for g, a in zip(replica_grads, arrived) if a]
    return tree_map(lambda *gs: sum(gs) / float(n_arrived), *picked)


class StepWatchdog:
    """Detects stuck steps by wall-clock budget (host-side straggler guard).

    The Trainer creates one when ``step_budget_seconds`` is set and calls
    ``check`` with each chunk's mean per-step time; violations are counted
    into the epoch record (``watchdog_violations``), reported through
    ``on_violation``, and emitted as ``watchdog_violation`` telemetry
    events (with the measured seconds and the budget) on ``recorder`` —
    the global one by default — so a stuck step shows up in the metrics
    stream, not just the log.
    """

    def __init__(self, budget_seconds: float,
                 on_violation: Optional[Callable] = None, recorder=None):
        self.budget = budget_seconds
        self.on_violation = on_violation
        self.recorder = recorder
        self.violations = 0

    def check(self, step_seconds: float, step: int) -> int:
        if step_seconds > self.budget:
            self.violations += 1
            if self.on_violation is not None:
                self.on_violation(step, step_seconds)
            rec = (self.recorder if self.recorder is not None
                   else get_recorder())
            rec.event("watchdog_violation", float(step_seconds),
                      step=int(step),
                      data={"budget_seconds": float(self.budget)})
            rec.add("watchdog_violations")
        return self.violations
