"""The yardstick's arithmetic: the bytes and operations a piece of work
needs, counted from shapes, and the least time one H100 could take for it.

Frozen copy of what the benchmark needs from ``src/repro_torch/kernels/
cost.py`` (the peaks, ``bound``, the ``adamw`` and ``examination_nll``
counts) as that file stood when the benchmark was defined, plus the whole
step's and the whole call's counts. The program may change its own copy;
this one stays as it is.

Every input byte is counted once and every output byte once, whatever a
kernel reads again; where the work depends on the data (the table sectors
a serving call touches) the caller counts what these inputs need.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 outside the
#: tensor cores (every kernel of the click models is float32 arithmetic).
#: Both assume the card's full power limit of 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
SECTOR = 32

#: Operations per (B, K) element of the examination-chain loss kernel, and
#: per element of one AdamW step with weight decay (counted from the
#: kernel sources, as the program's cost table had them).
EXAMINATION_NLL_OPS = 44
ADAMW_OPS = 16


class Cost(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other):  # type: ignore[override]
        return Cost(self.flops + other.flops, self.bytes + other.bytes)


def bound_s(cost: Cost) -> float:
    """The least seconds one H100 takes for ``cost``: the larger of its
    bytes over the memory rate and its operations over the float32 rate."""
    return max(cost.bytes / PEAK_BYTES_PER_S, cost.flops / PEAK_FP32_PER_S)


def adamw(numels: Iterable[int]) -> Cost:
    """One AdamW step over float32 tensors of ``numels`` elements: p, g and
    both moments read, p and both moments written, 28 bytes an element."""
    n = sum(int(x) for x in numels)
    return Cost(n * ADAMW_OPS, n * 28)


def examination_nll(rows: int, cols: int) -> Cost:
    """The loss kernel over (rows, cols): six float32 inputs and the bool
    mask read once, a float32 scalar written."""
    n = rows * cols
    return Cost(n * EXAMINATION_NLL_OPS, n * (6 * 4 + 1) + 4)


def train_step(numels: Iterable[int], batch_bytes: int,
               model_flops: float) -> Cost:
    """One training step as a whole: each parameter's p, m and v read and
    written once (24 bytes an element; the gradient is the step's own
    intermediate), the batch read once; AdamW's operations and the
    model's."""
    numels = [int(x) for x in numels]
    n = sum(numels)
    return Cost(n * ADAMW_OPS + model_flops, n * 24 + batch_bytes)


def serve_call(batch_bytes: int, answer_bytes: int, sectors: int,
               model_flops: float) -> Cost:
    """One serving call as a whole: the batch in, the answer out, and each
    32-byte table sector that the call's rows lie in read once."""
    return Cost(model_flops, batch_bytes + answer_bytes + sectors * SECTOR)
