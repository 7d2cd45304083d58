"""Fused examination-chain NLL (DCM / CCM / DBN / SDBN loss).

Two forms of one function, (B, K) inputs -> scalar fp32 masked-mean NLL:

* :func:`examination_nll_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/examination_nll.cu`` that replaces the TPU kernel
  ``repro/kernels/examination_nll.py`` (``_examination_nll_kernel``). A
  block stages its rows' spans into shared memory, one thread walks one
  session row through the capped death-odds recurrence and the two-log
  NLL, each block writes one masked (sum, count) pair, and the last block
  to finish writes ``sum / max(count, 1)``: one launch per call, nothing
  after it. Its counter is the stream's, or the captured call's own
  (:mod:`last_block`), so calls may run at once on several streams.
  :func:`launch_plan` sizes the rows per block and the shared memory from
  K. Its source says what bounds it and how its design answers that.
* :func:`examination_nll_plain`, the plain-torch form of
  ``examination_nll_xla`` (odds via the capped doubling scan, then the
  kernel's two-log NLL). The CPU path runs it, and the chip smoke holds the
  kernel against it.

``examination_nll_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core.recursions import conditional_examination_odds
from repro_torch.kernels import last_block


def examination_nll_plain(attr_logits, clicks, mask, p_skip_survive,
                          p_death, p_reset, p_reset_not) -> torch.Tensor:
    """Fused plain form: capped-scan odds + the kernel's two-log NLL."""
    x = attr_logits.float()
    c = clicks.float()
    m = mask.float()
    r = conditional_examination_odds(c, p_skip_survive, p_death, p_reset,
                                     p_reset_not)
    e = torch.exp(-torch.abs(x))
    denom = torch.log1p(r + e + r * e)
    log_p = torch.clamp_max(x, 0.0) - denom
    s = torch.where(x >= 0, e, 1.0)
    log_1mp = torch.log(s + r * (1.0 + e)) - denom
    nll = -(c * log_p + (1.0 - c) * log_1mp)
    return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)


#: Rows per block by default, at most 512 (kMaxThreads in the source: the
#: recurrence takes one thread per row).
ROWS_PER_BLOCK = 128
MAX_THREADS = 512
#: Elements each thread takes in the per-element parts, at most.
ELEMENTS_PER_THREAD = 2
FLOAT_INPUTS = 6
#: A block's staged spans stay within this unless a single row needs more,
#: so that several blocks share an SM; above 48 KB a block must opt in.
SMEM_TARGET = 48 * 1024
#: H100: the most shared memory one block may opt into, less the kernel's
#: static reduction scratch.
SMEM_PER_BLOCK = 232_448 - 256


class Plan(NamedTuple):
    """How one call is launched: ``rows_per_block`` rows per block,
    ``threads`` threads (whole warps, at least one per row),
    ``smem_bytes`` of staged inputs per block, ``grid`` blocks (one partial
    (sum, count) each)."""
    rows_per_block: int
    threads: int
    grid: int
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def staged_bytes(rows_per_block: int, cols: int) -> int:
    """Shared memory of one block: six float32 spans of R*K elements, each
    rounded to 16 bytes, then the bool mask's R*K bytes (the source's
    layout)."""
    n = rows_per_block * cols
    return FLOAT_INPUTS * _round_up(4 * n, 16) + _round_up(n, 16)


@functools.lru_cache(maxsize=256)
def launch_plan(rows: int, cols: int,
                rows_per_block: Optional[int] = None) -> Plan:
    """The geometry of one call over a (rows, cols) batch: 128 rows per
    block, halved while a block's staged spans exceed 48 KB (K > 15) and
    down to one row, whose spans may then take up to the 227 KB a block can
    opt into (K <= 9,284); threads for two elements each, at least one per
    row, at most 512. Raises for longer rows. ``rows_per_block`` may be
    given (1..512) to measure other geometries."""
    if rows_per_block is None:
        rows_per_block = ROWS_PER_BLOCK
        while (rows_per_block > 1
               and staged_bytes(rows_per_block, cols) > SMEM_TARGET):
            rows_per_block //= 2
    if not 1 <= rows_per_block <= MAX_THREADS:
        raise ValueError(f"rows_per_block must be in 1..{MAX_THREADS}, got "
                         f"{rows_per_block}")
    smem = staged_bytes(rows_per_block, cols)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{rows_per_block} rows of K = {cols} need {smem} "
                         f"bytes of shared memory, over {SMEM_PER_BLOCK}")
    threads = min(MAX_THREADS, max(
        _round_up(rows_per_block, 32),
        _round_up(-(-rows_per_block * cols // ELEMENTS_PER_THREAD), 32)))
    return Plan(rows_per_block, threads, max(1, -(-rows // rows_per_block)),
                smem)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signatures:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("examination_nll").path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.examination_nll_forward.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.examination_nll_forward.restype = i32
    lib.examination_nll_error_string.argtypes = [i32]
    lib.examination_nll_error_string.restype = ctypes.c_char_p
    return lib


def examination_nll_cuda(attr_logits, clicks, mask, p_skip_survive, p_death,
                         p_reset, p_reset_not, plan: Optional[Plan] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; one launch writes the
    scalar loss, and nothing runs after it. All inputs are (B, K)
    contiguous CUDA tensors on one device: float32, except ``mask``
    (bool). ``plan`` (default ``launch_plan(B, K)``) may be given to
    measure another geometry. Raises on anything else, and if the launch is
    refused."""
    floats = (attr_logits, clicks, p_skip_survive, p_death, p_reset,
              p_reset_not)
    device = attr_logits.device
    if device.type != "cuda":
        raise ValueError(f"examination_nll_cuda needs CUDA tensors, got "
                         f"{device}")
    if attr_logits.dim() != 2:
        raise ValueError(
            f"inputs must be (B, K), got {tuple(attr_logits.shape)}")
    shape = attr_logits.shape
    for t in floats + (mask,):
        if t.shape != shape or t.device != device:
            raise ValueError(
                "examination_nll inputs differ in shape or device")
        if not t.is_contiguous():
            raise ValueError("examination_nll inputs must be contiguous")
        if t.dtype != torch.float32 and t is not mask:
            raise TypeError(
                f"examination_nll takes float32 factors, got {t.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"examination_nll takes a bool mask, got {mask.dtype}")
    rows, cols = shape
    if rows * cols >= 2 ** 31:
        raise ValueError(f"batch of {rows}x{cols} exceeds the kernel's "
                         "int32 row and column arguments")
    if rows == 0 or cols == 0:
        return attr_logits.new_zeros(())
    if plan is None:
        plan = launch_plan(rows, cols)
    return torch.ops.repro_torch.examination_nll(
        attr_logits, clicks, mask, p_skip_survive, p_death, p_reset,
        p_reset_not, list(plan))


@torch.library.custom_op("repro_torch::examination_nll", mutates_args=(),
                         device_types="cuda")
def _launch(attr_logits: torch.Tensor, clicks: torch.Tensor,
            mask: torch.Tensor, p_skip_survive: torch.Tensor,
            p_death: torch.Tensor, p_reset: torch.Tensor,
            p_reset_not: torch.Tensor, plan: List[int]) -> torch.Tensor:
    """The launch, as a registered op: a fake tensor meets its fake form,
    which makes the scalar output and launches nothing."""
    rows_per_block, threads, grid, smem_bytes = plan
    rows, cols = attr_logits.shape
    device = attr_logits.device
    lib = _library()
    partials = torch.empty(2 * grid, dtype=torch.float32, device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    ticket = last_block.counter(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.examination_nll_forward(
            attr_logits.data_ptr(), clicks.data_ptr(), mask.data_ptr(),
            p_skip_survive.data_ptr(), p_death.data_ptr(),
            p_reset.data_ptr(), p_reset_not.data_ptr(), partials.data_ptr(),
            ticket.data_ptr(), out.data_ptr(), rows, cols,
            rows_per_block, threads, smem_bytes, stream)
    if err != 0:
        raise RuntimeError("examination_nll kernel launch failed: "
                           + lib.examination_nll_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        examination_nll_cuda.launches += 1
    return out


@_launch.register_fake
def _(attr_logits, clicks, mask, p_skip_survive, p_death, p_reset,
      p_reset_not, plan):
    return attr_logits.new_empty((), dtype=torch.float32)


examination_nll_cuda.launches = 0
