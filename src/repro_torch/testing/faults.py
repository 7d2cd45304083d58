"""Deterministic fault injection for chaos tests, port of the training
half of ``repro.testing.faults`` (numpy only; that module imports the JAX
package's store).

Every injector is reproducible from explicit arguments (a step index, a
byte count), so a chaos test that fails replays bit for bit:

* **Disk corruption** — :func:`truncate_tail` chops bytes off any file
  (e.g. a checkpoint's ``arrays.npz``, a crash mid-write that the COMMIT
  ordering missed).
* **Numerical faults** — :class:`NonFiniteBatchInjector` wraps a loader and
  poisons chosen batches with NaN/Inf, driving the engine's
  ``nonfinite_guard`` skip path.
* **Process death** — :class:`KillSwitch` wraps a loader and signals the
  *current process* (SIGTERM for a graceful preemption, SIGKILL for an
  instant crash) when batch N is produced, driving the resume path. The
  switch carries a caller-armed gate (``armed=False`` builds it disarmed).

The injectors are loader proxies: any attribute they do not override
forwards to the wrapped loader, so ``state_dict``, ``batch_size`` and the
rest keep working and the proxies compose with ``DevicePrefetcher`` and
``Trainer`` unchanged. The store's faults (``corrupt_shard_file``,
``FlakyShardReads``) wait for the store, the serving faults for serving.
"""
from __future__ import annotations

import os
import signal
from typing import Iterable

import numpy as np


def truncate_tail(path: str, n_bytes: int = 1) -> int:
    """Chop the last ``n_bytes`` off ``path`` (a crash-mid-write simulant).
    Returns the new size."""
    size = os.path.getsize(path)
    new_size = max(size - n_bytes, 0)
    os.truncate(path, new_size)
    return new_size


class _LoaderProxy:
    """Forward everything to the wrapped loader except ``__iter__``.

    ``for`` looks up ``__iter__`` on the *type*, so subclasses must define
    it; every other attribute (``state_dict``, ``batch_size``,
    ``batches_per_epoch``, ...) resolves through ``__getattr__``.
    """

    def __init__(self, loader):
        self._loader = loader

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def epochs(self, n_epochs: int):
        for _ in range(n_epochs):
            yield from iter(self)

    def __iter__(self):
        raise NotImplementedError


class NonFiniteBatchInjector(_LoaderProxy):
    """Poison chosen batches with a non-finite value.

    ``at_steps`` are cumulative batch indices across every epoch iterated
    through this wrapper (step 0 is the first batch produced). The ``key``
    column of a poisoned batch is replaced wholesale with ``value``
    (default NaN), which propagates to a non-finite loss and non-finite
    gradients — exactly what the engine's ``nonfinite_guard`` must skip.
    """

    def __init__(self, loader, at_steps: Iterable[int], key: str = "clicks",
                 value: float = float("nan")):
        super().__init__(loader)
        self.at_steps = frozenset(int(s) for s in at_steps)
        self.key = key
        self.value = value
        self.produced = 0
        self.injected = 0

    def __iter__(self):
        for batch in iter(self._loader):
            if self.produced in self.at_steps:
                batch = dict(batch)
                poisoned = np.array(batch[self.key], copy=True)
                poisoned[...] = self.value
                batch[self.key] = poisoned
                self.injected += 1
            self.produced += 1
            yield batch


class KillSwitch(_LoaderProxy):
    """Send ``sig`` to the current process when batch ``after_batches`` is
    produced (cumulative across epochs; 0 kills before the first batch).

    With ``signal.SIGKILL`` the process dies at once — the checkpoint
    directory is left exactly as the last committed save wrote it, which is
    what crash-exact resume must recover from. With ``signal.SIGTERM`` a
    registered :class:`~repro_torch.train.PreemptionHandler` turns the
    signal into a final checkpoint and a clean exit. The prefetcher's
    staging thread may produce the batch ahead of the step that consumes
    it; the checkpoint records the loader state of the last chunk
    consumed, so the resume point does not depend on when the signal lands.

    The gate is **caller-armed**: the switch fires at most once, and only
    while ``armed``. A restart supervisor rebuilds the same pipeline on
    every attempt, so the caller decides when the switch is live — e.g.
    ``launch/train.py --fault-kill-at-step`` arms it only while the
    checkpoint directory holds no committed step, which is why the
    relaunched child survives; ``arm(False)`` disarms a built pipeline.
    """

    def __init__(self, loader, after_batches: int,
                 sig: int = signal.SIGTERM, armed: bool = True):
        super().__init__(loader)
        self.after_batches = int(after_batches)
        self.sig = sig
        self.armed = bool(armed)
        self.produced = 0
        self.fired = False

    def arm(self, armed: bool = True) -> "KillSwitch":
        self.armed = bool(armed)
        return self

    def __iter__(self):
        for batch in iter(self._loader):
            if (self.produced == self.after_batches and self.armed
                    and not self.fired):
                self.fired = True
                os.kill(os.getpid(), self.sig)
            self.produced += 1
            yield batch
