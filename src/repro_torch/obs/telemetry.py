"""Host-side consumer of the engine's per-chunk device telemetry, port of
``repro.obs.telemetry``.

:class:`TelemetryDrain` is the single source of truth for the epoch's
``train_loss`` sum, ``n_batches`` and ``skipped_steps``, and it turns the
same drained numpy into per-step metric events. A chunk's payload (the
``(n,)`` or ``(n, R)`` losses, or a dict of such tensors: ``loss``,
the guard's ``skipped`` and the engine's telemetry series ``grad_norm``,
``param_norm`` and ``lr``) is handed to :func:`stage` right after the chunk
is queued: on CUDA every tensor is copied to pinned host memory without
blocking and one event marks the end of the chunk's work. :meth:`drain`
reads a staged payload one chunk later, waiting on that event only, so the
telemetry rides the transfer the losses always needed and adds no host
sync (the JAX version's one ``device_get`` per chunk).

Accumulation is bit-compatible with the JAX version: one run adds its
losses one by one into a Python float (which round-trips JSON exactly, for
crash-exact resume); a sweep adds ``(R,)`` float64 vectors, a skipped step
contributing no loss and one skip.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.recorder import Recorder, get_recorder

#: telemetry payload keys that are not per-step metric series
_STRUCTURAL_KEYS = ("loss", "skipped")

Staged = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


def stage(payload) -> Staged:
    """Start moving a chunk's payload to the host. On CUDA the copies go to
    pinned memory without blocking, and an event marks the end of this
    chunk's work: reading a CUDA tensor directly (``.tolist()``) would wait
    for everything queued on the stream, the next chunk included. A CPU
    payload is kept as it is."""
    tensors = payload if isinstance(payload, dict) else {"loss": payload}
    if next(iter(tensors.values())).device.type != "cuda":
        return tensors, None
    host = {}
    for k, t in tensors.items():
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def read(staged: Staged) -> Dict[str, np.ndarray]:
    """A staged payload as numpy arrays; waits for its chunk only."""
    host, done = staged
    if done is not None:
        done.synchronize()
    return {k: t.numpy() for k, t in host.items()}


class TelemetryDrain:
    """Accumulate one epoch's drained chunk payloads; emit per-step events.

    ``drain(staged, first_step)`` takes what :func:`stage` returned for a
    chunk (a bare ``(n,)`` / ``(n, R)`` loss tensor is staged as
    ``{"loss": ...}``) and the global index of the chunk's first step,
    used only to tag the events.
    """

    def __init__(self, replicas: Optional[int] = None,
                 recorder: Optional[Recorder] = None, every: int = 1,
                 epoch: Optional[int] = None):
        self.R = replicas
        self.recorder = recorder
        self.every = max(int(every), 1)
        self.epoch = epoch
        self.n_batches = 0
        if replicas is None:
            self.train_loss: Any = 0.0
            self.skipped_steps: Any = 0
        else:
            self.train_loss = np.zeros(replicas, np.float64)
            self.skipped_steps = np.zeros(replicas, np.int64)

    def _rec(self) -> Recorder:
        return self.recorder if self.recorder is not None else get_recorder()

    # -- resume ------------------------------------------------------------
    def load(self, accum: Dict[str, Any]) -> None:
        """Restore mid-epoch accumulators from checkpoint aux (the
        ``epoch_accum`` dict written by :meth:`aux`)."""
        self.n_batches = int(accum["n_batches"])
        if self.R is None:
            self.train_loss = float(accum["train_loss"])
            self.skipped_steps = int(accum.get("skipped", 0))
        else:
            self.train_loss = np.asarray(accum["train_loss"], np.float64)
            self.skipped_steps = np.asarray(
                accum.get("skipped", [0] * self.R), np.int64)

    def aux(self) -> Dict[str, Any]:
        """JSON-able mid-epoch accumulators for checkpoint aux. Python
        floats round-trip json exactly (repr-based), so a resumed epoch's
        loss sum stays bit-identical to an uninterrupted run's."""
        if self.R is None:
            return {"train_loss": self.train_loss,
                    "n_batches": int(self.n_batches),
                    "skipped": int(self.skipped_steps)}
        return {"train_loss": np.asarray(self.train_loss,
                                         np.float64).tolist(),
                "n_batches": int(self.n_batches),
                "skipped": np.asarray(self.skipped_steps).tolist()}

    # -- the drain ---------------------------------------------------------
    def drain(self, staged: Staged, first_step: Optional[int] = None) -> None:
        """Read one staged chunk (waiting for that chunk only) and fold it
        into the epoch accumulators and the sinks."""
        data = read(staged)
        losses = data["loss"]
        skipped = data.get("skipped")
        extras = {k: v for k, v in data.items()
                  if k not in _STRUCTURAL_KEYS}
        n = losses.shape[0]
        if self.R is None:
            # loss by loss into the Python float: the JAX version's sum
            for i, loss in enumerate(losses.tolist()):
                if skipped is not None and skipped[i]:
                    self.skipped_steps += 1
                else:
                    self.train_loss += loss
        else:
            arr = np.asarray(losses, np.float64)
            if skipped is None:
                self.train_loss += arr.sum(axis=0)
            else:
                self.train_loss += np.where(skipped, 0.0, arr).sum(axis=0)
                self.skipped_steps += skipped.sum(axis=0)
        start = self.n_batches if first_step is None else first_step
        self.n_batches += n
        rec = self._rec()
        if rec.enabled:
            self._emit(rec, losses, skipped, extras, start)

    def _emit(self, rec, losses, skipped, extras, start) -> None:
        for i in range(losses.shape[0]):
            step = start + i
            if self.R is None:
                if step % self.every == 0:
                    rec.metric("train_step", losses[i], step=step,
                               epoch=self.epoch,
                               data=self._extras_at(extras, i, None))
                if skipped is not None and skipped[i]:
                    rec.event("skipped_step", step=step, epoch=self.epoch)
            else:
                for r in range(self.R):
                    if step % self.every == 0:
                        rec.metric("train_step", losses[i, r], step=step,
                                   epoch=self.epoch, replica=r,
                                   data=self._extras_at(extras, i, r))
                    if skipped is not None and skipped[i, r]:
                        rec.event("skipped_step", step=step,
                                  epoch=self.epoch, replica=r)

    @staticmethod
    def _extras_at(extras, i, r) -> Optional[Dict[str, float]]:
        if not extras:
            return None
        if r is None:
            return {k: float(v[i]) for k, v in extras.items()}
        return {k: float(v[i, r]) for k, v in extras.items()}

    # -- derived views -----------------------------------------------------
    def mean_loss(self):
        """Epoch mean over the steps that actually updated (skipped steps
        contributed no loss)."""
        if self.R is None:
            return self.train_loss / max(self.n_batches - self.skipped_steps,
                                         1)
        return self.train_loss / np.maximum(
            self.n_batches - self.skipped_steps, 1)
