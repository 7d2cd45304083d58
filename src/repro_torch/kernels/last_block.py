"""Last-block counters of the one-launch loss kernels.

``examination_nll`` and ``session_nll`` finish their mean inside the launch
(``csrc/last_block.cuh``): the last block to take a ticket from an int32
counter sums every block's partials and resets the counter to 0. Two calls
that may run at the same time must not share a counter, or a block of one
could take a ticket of the other's and finish its mean early.
:func:`counter` picks one:

* outside graph capture, one counter per (device, stream): calls on one
  stream run in order, so they can share it;
* a call captured into a CUDA graph gets a counter of its own, for good,
  from a pool of the device's counters. Every launch leaves its counter
  at 0, so no fill node enters the graph; the graph keeps the slot, 4
  bytes per captured call, never handed out again.

The pool is allocated zeroed outside capture only: at the first call on
the device, and again, twice as large, whenever an eager call finds it
half used. A call captured while no slot is free (capture before any
eager call, or more captured calls than the pool has room for) takes a
``torch.zeros(1)`` made inside the capture: correct, at the cost of one
fill node that the graph runs on every replay.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

#: Counters in the first pool of a device.
POOL_SLOTS = 1024


class Counters:
    """The counters of one device. ``zeros(n)`` returns n int32 counters,
    zeroed and ready for any stream (the caller allocates outside capture).
    """

    def __init__(self, zeros: Callable[[int], torch.Tensor]):
        self._zeros = zeros
        self._streams: Dict[int, torch.Tensor] = {}
        self._pools: List[torch.Tensor] = []  # every pool stays alive
        self._used = 0  # slots handed out of the newest pool

    def _free(self) -> int:
        return len(self._pools[-1]) - self._used if self._pools else 0

    def _take(self) -> torch.Tensor:
        slot = self._pools[-1][self._used:self._used + 1]
        self._used += 1
        return slot

    def for_stream(self, stream: int) -> torch.Tensor:
        """The counter of eager calls on ``stream`` (a stream handle). Grows
        the pool first if it is half used, so that captures find room."""
        if not self._pools or 2 * self._free() < len(self._pools[-1]):
            size = 2 * len(self._pools[-1]) if self._pools else POOL_SLOTS
            self._pools.append(self._zeros(size))
            self._used = 0
        if stream not in self._streams:
            self._streams[stream] = self._take()
        return self._streams[stream]

    def for_capture(self) -> Optional[torch.Tensor]:
        """A slot of the pool that no other call has had, or None when none
        is free (the pool is not grown during capture)."""
        return self._take() if self._free() > 0 else None


_COUNTERS: Dict[int, Counters] = {}


def _zeros_ready(device: torch.device, n: int) -> torch.Tensor:
    """n zeroed counters on ``device``, the fill finished before any other
    stream can use them."""
    out = torch.zeros(n, dtype=torch.int32, device=device)
    torch.cuda.current_stream(device).synchronize()
    return out


def counter(device: torch.device) -> torch.Tensor:
    """The counter for one launch on ``device``'s current stream."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    device = torch.device("cuda", index)
    counters = _COUNTERS.get(index)
    if counters is None:
        counters = _COUNTERS[index] = Counters(
            lambda n: _zeros_ready(device, n))
    with torch.cuda.device(device):
        if torch.cuda.is_current_stream_capturing():
            slot = counters.for_capture()
            if slot is None:
                slot = torch.zeros(1, dtype=torch.int32, device=device)
            return slot
        return counters.for_stream(torch.cuda.current_stream().cuda_stream)
