"""Pinned staging of a bulk entry's batch in and answer out, shared by
``configs.clax_baidu.serve_bulk`` and ``configs.lm_common.score_bulk``: the
batch goes to the card in pieces through one reused pinned set, so the host
fills a piece while the copy engine moves the one before, and the answer
comes back into a new pinned tensor the caller owns."""
from __future__ import annotations

import threading
import weakref
from typing import Dict

import numpy as np
import torch

from repro_torch.data.loader import _PinnedRing

#: Bytes of one piece of a batch's copy in on the card: the host fills one
#: piece of the pinned staging buffer while the copy engine moves the one
#: before. From ``chip_smoke.py`` ``_bulk``'s sweep of
#: ``configs.clax_baidu.serve_bulk`` at 262,144 x 10 on an H100: each piece
#: costs a fill and a copy of their own, and 16 MiB (each of the batch's
#: arrays one piece) was the fastest of 1-16 MiB.
PIECE_BYTES = 16 << 20


def _cuda_event(device):
    """An event recorded on ``device``'s current stream."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class PinnedStaging:
    """A bulk entry's pinned host memory for one model: one staging
    set for the batch, reused from call to call (a one-slot
    :class:`~repro_torch.data.loader._PinnedRing`, refitted on a new key,
    shape or dtype), and a new pinned tensor for each answer, which the
    caller then owns. ``pinned(shape, dtype)`` allocates pinned host memory
    and ``mark(device)`` records an event on the device's current stream
    (plain tensors and stand-in events on the CPU, in the tests)."""

    def __init__(self, pinned=None, mark=None):
        self._pinned = pinned or (lambda shape, dtype: torch.empty(
            shape, dtype=dtype, pin_memory=True))
        self._mark = mark or _cuda_event
        self._ring = _PinnedRing(1, pinned=self._pinned)
        self._lock = threading.Lock()

    def copy_in(self, host: Dict[str, np.ndarray], device):
        """``(inputs, allocated)``: ``host``'s C-contiguous arrays as new
        tensors on ``device``, and whether a staging set was allocated.
        Each array goes in pieces of :data:`PIECE_BYTES`: a piece is filled
        into the staging buffer on the host (torch's threaded ``copy_``),
        then its copy is enqueued without waiting, so the copy engine moves
        piece i while the host fills piece i + 1. The set is refilled only
        once the previous call's copies out of it have completed."""
        src = {k: torch.from_numpy(v) for k, v in host.items()}
        with self._lock:
            allocs = self._ring.allocs
            slot, staged = self._ring.take(
                {k: (tuple(t.shape), t.dtype) for k, t in src.items()})
            inputs = {}
            for k, t in src.items():
                dst = torch.empty(t.shape, dtype=t.dtype, device=device)
                flat_src, flat_buf, flat_dst = (t.view(-1), staged[k].view(-1),
                                                dst.view(-1))
                step = max(1, PIECE_BYTES // t.element_size())
                for lo in range(0, t.numel(), step):
                    piece = slice(lo, lo + step)
                    flat_buf[piece].copy_(flat_src[piece])
                    flat_dst[piece].copy_(flat_buf[piece], non_blocking=True)
                inputs[k] = dst
            self._ring.copied(slot, self._mark(device))
            return inputs, self._ring.allocs != allocs

    def copy_out(self, out: torch.Tensor, device) -> np.ndarray:
        """``out`` copied into a new pinned host tensor, once the device has
        finished it; its numpy view."""
        answer = self._pinned(tuple(out.shape), out.dtype)
        answer.copy_(out, non_blocking=True)
        self._mark(device).synchronize()
        return answer.numpy()


#: Each model's :class:`PinnedStaging`, made at its first call on the card
#: and dropped with the model.
_STAGING: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def staging_for(model, device):
    """The model's pinned staging, made at its first call on a CUDA card;
    None on the CPU, where the batch is copied as it lies."""
    staging = _STAGING.get(model)
    if staging is None and device.type == "cuda":
        staging = _STAGING.setdefault(model, PinnedStaging())
    return staging
