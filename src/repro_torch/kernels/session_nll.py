"""Fused session NLL (GCTR / RCTR / DCTR loss): masked mean of
softplus(x) - c x, straight from logits.

Three forms of one function, (B, K) float32 logits and clicks and a bool
mask -> the scalar float32 masked-mean NLL:

* :func:`session_nll_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/session_nll.cu`` that replaces the TPU kernel
  ``repro/kernels/session_nll.py`` (``_session_nll_kernel``). Every thread
  loads its 4-element vectors of x, c and the mask before any arithmetic,
  each block writes one (sum, count) pair, and the last block to finish
  writes ``sum / max(count, 1)`` (``csrc/last_block.cuh``, with the
  stream's or the captured call's own counter from :mod:`last_block`): one
  launch per call, nothing after it. :func:`launch_plan` gives its
  geometry. Its source says what bounds it and how its design answers
  that.
* :func:`session_nll_triton`, the first design (Triton, masked 1024-element
  blocks whose partials the caller sums with four more device kernels).
  No path runs it; the chip smoke times it beside the CUDA kernel.
* :func:`session_nll_plain`, the plain-torch form (``repro/kernels/ops.py``
  ``_session_nll_xla``), which the CPU path runs and the chip smoke holds
  the kernels against.

``triton`` is imported on the first launch, never at module import. Each
kernel's wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional

import torch

from repro_torch.kernels import last_block

#: The Triton design's elements per program.
BLOCK = 1024

tl = None  # triton.language, bound by _kernel() on the first launch
_compiled = None

#: The CUDA kernel's default geometry: threads per block and 4-element
#: vectors per thread (2,048 elements a block, 320 blocks at 65,536 x 10).
THREADS = 512
VECTORS = 1
#: Vectors per thread the source instantiates; threads per block it takes.
VECTOR_CHOICES = (1, 2, 4)
MAX_THREADS = 1024


def session_nll_plain(logits, clicks, mask) -> torch.Tensor:
    """softplus(x) - c*x, masked mean: the one-transcendental BCE form."""
    x = logits.float()
    c = clicks.float()
    m = mask.float()
    nll = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x))) - c * x
    return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)


def _session_nll_kernel(x_ptr, c_ptr, m_ptr, sum_ptr, cnt_ptr, n_elements,
                        BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    live = offs < n_elements
    x = tl.load(x_ptr + offs, mask=live, other=0.0)
    c = tl.load(c_ptr + offs, mask=live, other=0.0)
    m = tl.load(m_ptr + offs, mask=live, other=0).to(tl.float32)
    e = tl.exp(-tl.abs(x))
    # log1p(e) without a libdevice call: log(w) * e / (w - 1) with w = 1 + e
    # is exact to rounding (w - 1 is exact for w in [1, 2]); w == 1 means
    # e is below half an ulp of 1, where log1p(e) = e.
    w = 1.0 + e
    l1p = tl.where(w == 1.0, e, tl.log(w) * (e / (w - 1.0)))
    nll = tl.maximum(x, 0.0) + l1p - c * x
    tl.store(sum_ptr + pid, tl.sum(nll * m, axis=0))
    tl.store(cnt_ptr + pid, tl.sum(m, axis=0))


def _kernel():
    global tl, _compiled
    if _compiled is None:
        import triton
        import triton.language as tl  # noqa: F811 - binds the kernel's global
        _compiled = triton.jit(_session_nll_kernel)
    return _compiled


def _check(name, logits, clicks, mask) -> None:
    """Raise unless the inputs are contiguous CUDA tensors of one shape on
    one device: float32 logits and clicks, a bool mask."""
    device = logits.device
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    for t in (logits, clicks, mask):
        if t.shape != logits.shape or t.device != device:
            raise ValueError("session_nll inputs differ in shape or device")
        if not t.is_contiguous():
            raise ValueError("session_nll inputs must be contiguous")
    if logits.dtype != torch.float32 or clicks.dtype != torch.float32:
        raise TypeError("session_nll takes float32 logits and clicks, got "
                        f"{logits.dtype} and {clicks.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"session_nll takes a bool mask, got {mask.dtype}")


def session_nll_triton(logits, clicks, mask) -> torch.Tensor:
    """Launch the Triton kernel (the first design), then sum its partials.
    Inputs are (B, K) contiguous CUDA tensors on one device: float32 logits
    and clicks, bool mask. Raises on anything else."""
    _check("session_nll_triton", logits, clicks, mask)
    device = logits.device
    n = logits.numel()
    if n == 0:
        return logits.new_zeros(())
    grid = (n + BLOCK - 1) // BLOCK
    sums = torch.empty(grid, dtype=torch.float32, device=device)
    counts = torch.empty(grid, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _kernel()[(grid,)](logits, clicks, mask.view(torch.uint8), sums,
                           counts, n, BLOCK=BLOCK, num_warps=4)
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        session_nll_triton.launches += 1
    return torch.sum(sums) / torch.clamp_min(torch.sum(counts), 1.0)


session_nll_triton.launches = 0


class Plan(NamedTuple):
    """How :func:`session_nll_cuda` launches over n elements: ``threads``
    threads a block, ``vectors`` 4-element vectors a thread, ``grid``
    blocks (one (sum, count) partial pair each)."""
    threads: int
    vectors: int
    grid: int


def launch_plan(n: int, threads: Optional[int] = None,
                vectors: Optional[int] = None) -> Plan:
    """The geometry of one call over n elements: 512 threads of one
    4-element vector by default, so that a (65,536, 10) batch is 320 blocks
    that the card holds at once. ``threads`` (a multiple of 32 up to 1024)
    and ``vectors`` (1, 2 or 4) may be given to measure other
    geometries."""
    threads = THREADS if threads is None else threads
    vectors = VECTORS if vectors is None else vectors
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in 32.."
                         f"{MAX_THREADS}, got {threads}")
    if vectors not in VECTOR_CHOICES:
        raise ValueError(f"vectors must be one of {VECTOR_CHOICES}, got "
                         f"{vectors}")
    per_block = 4 * vectors * threads
    return Plan(threads, vectors, max(1, -(-n // per_block)))


def vector_loads(logits_addr: int, clicks_addr: int, mask_addr: int) -> bool:
    """Whether the kernel may load whole vectors: 16-byte logits and clicks
    and 4-byte-aligned mask words (else it reads every element alone)."""
    return logits_addr % 16 == 0 and clicks_addr % 16 == 0 \
        and mask_addr % 4 == 0


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signatures:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("session_nll").path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.session_nll_forward.argtypes = ([ptr] * 6 + [ctypes.c_longlong]
                                        + [i32] * 3 + [ptr])
    lib.session_nll_forward.restype = i32
    lib.session_nll_error_string.argtypes = [i32]
    lib.session_nll_error_string.restype = ctypes.c_char_p
    return lib


def session_nll_cuda(logits, clicks, mask,
                     plan: Optional[Plan] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; one launch writes the
    scalar loss, and nothing runs after it. Inputs are (B, K) contiguous
    CUDA tensors on one device (a storage offset is fine): float32 logits
    and clicks, bool mask. ``plan`` (default ``launch_plan(B * K)``) may be
    given to measure another geometry. Raises on anything else, for 2^31
    elements or more, and if the launch is refused."""
    _check("session_nll_cuda", logits, clicks, mask)
    device = logits.device
    n = logits.numel()
    if n >= 2 ** 31:
        raise ValueError(f"batch of {n} elements exceeds the kernel's int32 "
                         "element indices")
    if n == 0:
        return logits.new_zeros(())
    if plan is None:
        plan = launch_plan(n)
    return torch.ops.repro_torch.session_nll(logits, clicks, mask,
                                             list(plan))


@torch.library.custom_op("repro_torch::session_nll", mutates_args=(),
                         device_types="cuda")
def _launch(logits: torch.Tensor, clicks: torch.Tensor, mask: torch.Tensor,
            plan: List[int]) -> torch.Tensor:
    """The launch, as a registered op: a fake tensor meets its fake form,
    which makes the scalar output and launches nothing."""
    threads, vectors, grid = plan
    device = logits.device
    lib = _library()
    partials = torch.empty(2 * grid, dtype=torch.float32, device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    ticket = last_block.counter(device)
    vector = vector_loads(logits.data_ptr(), clicks.data_ptr(),
                          mask.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.session_nll_forward(
            logits.data_ptr(), clicks.data_ptr(), mask.data_ptr(),
            partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
            logits.numel(), threads, vectors, int(vector), stream)
    if err != 0:
        raise RuntimeError("session_nll kernel launch failed: "
                           + lib.session_nll_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        session_nll_cuda.launches += 1
    return out


@_launch.register_fake
def _(logits, clicks, mask, plan):
    return logits.new_empty((), dtype=torch.float32)


session_nll_cuda.launches = 0
