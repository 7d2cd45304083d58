"""DCN-V2 cross layer: ``out = x0 * (x @ W + b) + x``.

Two forms of one function, with x0 and x (B, D), W (D, D) in the (in, out)
layout and b (D,), float32 or bfloat16, -> (B, D) float32:

* :func:`dcn_cross_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/dcn_cross.cu`` that replaces the TPU kernel
  ``repro/kernels/dcn_cross.py`` (``_cross_kernel``): a shared-memory tiled
  float32 GEMM whose epilogue (+ b, * x0, + x) is applied in registers
  before the one write of the output, with no padding of B or D; its source
  says what bounds it and how the design answers that.
* ``dcn_cross_plain``, the plain-torch form, which is ``ref.dcn_cross_ref``:
  every input cast to float32, one matrix product. The CPU path runs it,
  and the chip smoke holds the kernel against it.

``dcn_cross_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import dcn_cross_ref as dcn_cross_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signatures:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("dcn_cross").path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dcn_cross_forward.argtypes = [ptr] * 5 + [i64, i32, i32, ptr]
    lib.dcn_cross_forward.restype = i32
    lib.dcn_cross_error_string.argtypes = [i32]
    lib.dcn_cross_error_string.restype = ctypes.c_char_p
    return lib


def dcn_cross_cuda(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. x0 and x (B, D), w
    (D, D) and b (D,) must share one dtype (float32 or bfloat16) and one
    CUDA device, and be contiguous; x may be x0. Raises on anything else,
    and if the launch is refused."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"dcn_cross_cuda needs CUDA tensors, got {device}")
    if x.dim() != 2 or x0.shape != x.shape:
        raise ValueError(f"dcn_cross takes x0 and x of one (B, D) shape, got "
                         f"{tuple(x0.shape)} and {tuple(x.shape)}")
    rows, dim = x.shape
    if w.shape != (dim, dim) or b.shape != (dim,):
        raise ValueError(f"dcn_cross with D = {dim} takes W ({dim}, {dim}) "
                         f"and b ({dim},), got {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")
    for t in (x0, w, b):
        if t.device != device:
            raise ValueError("dcn_cross inputs lie on different devices")
        if t.dtype != x.dtype:
            raise TypeError(f"dcn_cross inputs must share one dtype, got "
                            f"{t.dtype} and {x.dtype}")
    for t in (x0, x, w, b):
        if not t.is_contiguous():
            raise ValueError("dcn_cross inputs must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dcn_cross takes float32 or bfloat16, got {x.dtype}")
    if dim >= 2 ** 31 or -(-rows // 64) >= 2 ** 31:
        raise ValueError(f"({rows}, {dim}) exceeds one launch's grid")
    if rows * dim == 0:
        return torch.empty(rows, dim, dtype=torch.float32, device=device)
    return torch.ops.repro_torch.dcn_cross(x0, x, w, b)


@torch.library.custom_op("repro_torch::dcn_cross", mutates_args=(),
                         device_types="cuda")
def _launch(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """The launch, as a registered op: a fake tensor meets its fake form,
    which makes the (B, D) output and launches nothing."""
    rows, dim = x.shape
    device = x.device
    out = torch.empty(rows, dim, dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dcn_cross_forward(x0.data_ptr(), x.data_ptr(), w.data_ptr(),
                                    b.data_ptr(), out.data_ptr(), rows, dim,
                                    _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("dcn_cross kernel launch failed: "
                           + lib.dcn_cross_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        dcn_cross_cuda.launches += 1
    return out


@_launch.register_fake
def _(x0, x, w, b):
    return x.new_empty(x.shape, dtype=torch.float32)


dcn_cross_cuda.launches = 0
