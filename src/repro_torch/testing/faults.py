"""Deterministic fault injection for chaos tests, port of the training
and store half of ``repro.testing.faults`` (numpy only; that module imports
the JAX package's store).

Every injector is reproducible from explicit arguments (a seed, a step
index, a byte offset), so a chaos test that fails replays bit for bit:

* **Disk corruption** — :func:`corrupt_shard_file` flips bits inside one
  column file of an on-disk
  :class:`~repro_torch.data.store.SessionStore` shard;
  :func:`truncate_tail` chops bytes off any file (e.g. a checkpoint's
  ``arrays.npz``, a crash mid-write that the COMMIT ordering missed).
* **Numerical faults** — :class:`NonFiniteBatchInjector` wraps a loader and
  poisons chosen batches with NaN/Inf, driving the engine's
  ``nonfinite_guard`` skip path.
* **Flaky IO** — :class:`FlakyShardReads` wraps a store so the first N
  ``open_shard`` calls fail with a transient ``OSError`` (optionally after a
  delay), driving the streaming loader's retry-with-backoff path.
* **Process death** — :class:`KillSwitch` wraps a loader and signals the
  *current process* (SIGTERM for a graceful preemption, SIGKILL for an
  instant crash) when batch N is produced, driving the resume path. The
  switch carries a caller-armed gate (``armed=False`` builds it disarmed).

The injectors are loader and store proxies: any attribute they do not
override forwards to the wrapped object, so ``state_dict``, ``batch_size``
and the rest keep working and the proxies compose with ``DevicePrefetcher``
and ``Trainer`` unchanged. The serving faults wait for serving.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.data.store import MANIFEST_NAME


def corrupt_shard_file(store_dir: str, shard: int = 0,
                       column: Optional[str] = None, n_flips: int = 1,
                       seed: int = 0,
                       byte_offset: Optional[int] = None) -> Dict:
    """Flip bits in one column file of a committed store shard.

    The byte offsets are drawn from ``rng(seed)`` (or pinned via
    ``byte_offset``) and each chosen byte is XORed with 0xFF, so a single
    flip is guaranteed to change the column's crc32. Returns a description
    dict (``path``, ``column``, ``offsets``) for test assertions and
    replays.
    """
    with open(os.path.join(store_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    shard_meta = manifest["shards"][shard]
    if column is None:
        column = sorted(manifest["columns"])[0]
    path = os.path.join(store_dir, shard_meta["name"], f"{column}.bin")
    size = os.path.getsize(path)
    if byte_offset is not None:
        offsets = [int(byte_offset)]
    else:
        offsets = np.random.default_rng(seed).integers(
            0, size, size=n_flips).tolist()
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ 0xFF]))
    return {"path": path, "column": column, "offsets": offsets}


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


class FlakyShardReads:
    """Store proxy whose first ``fail_times`` ``open_shard`` calls fail.

    Failures raise a transient ``OSError`` (optionally preceded by
    ``delay_seconds`` of latency, simulating a slow remote filesystem);
    subsequent calls pass through, so a reader with ``io_retries >=
    fail_times`` recovers and one without surfaces the error.
    """

    def __init__(self, store, fail_times: int = 1, delay_seconds: float = 0.0):
        self._store = store
        self.fail_times = int(fail_times)
        self.delay_seconds = float(delay_seconds)
        self.calls = 0
        self.failures = 0

    def __getattr__(self, name):
        return getattr(self._store, name)

    def open_shard(self, index, columns=None):
        self.calls += 1
        if self.delay_seconds:
            time.sleep(self.delay_seconds)
        if self.failures < self.fail_times:
            self.failures += 1
            raise OSError(f"injected transient IO failure "
                          f"#{self.failures} (shard {index})")
        return self._store.open_shard(index, columns=columns)


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
