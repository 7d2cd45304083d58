"""Fused examination-chain NLL (DCM / CCM / DBN / SDBN loss).

Two forms of one function, (B, K) inputs -> scalar fp32 masked-mean NLL:

* :func:`examination_nll_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/examination_nll.cu`` that replaces the TPU kernel
  ``repro/kernels/examination_nll.py`` (``_examination_nll_kernel``). One
  thread walks one session row through the capped death-odds recurrence
  and the two-log NLL; each block writes one masked (sum, count) pair, and
  the final ``sum / max(count, 1)`` happens here, as in the JAX version.
  Its source says what bounds it and how its design answers that.
* :func:`examination_nll_plain`, the plain-torch form of
  ``examination_nll_xla`` (odds via the capped doubling scan, then the
  kernel's two-log NLL). The CPU path runs it, and the chip smoke holds the
  kernel against it.

``examination_nll_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.recursions import conditional_examination_odds


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


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signatures:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("examination_nll").path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.examination_nll_forward.argtypes = [ptr] * 9 + [i32, i32, ptr]
    lib.examination_nll_forward.restype = i32
    lib.examination_nll_num_blocks.argtypes = [i32]
    lib.examination_nll_num_blocks.restype = i32
    lib.examination_nll_error_string.argtypes = [i32]
    lib.examination_nll_error_string.restype = ctypes.c_char_p
    return lib


def examination_nll_cuda(attr_logits, clicks, mask, p_skip_survive, p_death,
                         p_reset, p_reset_not) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. All inputs are (B, K)
    contiguous CUDA tensors on one device: float32, except ``mask`` (bool).
    Raises on anything else, and if the launch is refused."""
    floats = (attr_logits, clicks, p_skip_survive, p_death, p_reset,
              p_reset_not)
    device = attr_logits.device
    if device.type != "cuda":
        raise ValueError(f"examination_nll_cuda needs CUDA tensors, got "
                         f"{device}")
    if attr_logits.dim() != 2:
        raise ValueError(
            f"inputs must be (B, K), got {tuple(attr_logits.shape)}")
    for t in floats + (mask,):
        if t.shape != attr_logits.shape or t.device != device:
            raise ValueError(
                "examination_nll inputs differ in shape or device")
        if not t.is_contiguous():
            raise ValueError("examination_nll inputs must be contiguous")
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(
                f"examination_nll takes float32 factors, got {t.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"examination_nll takes a bool mask, got {mask.dtype}")
    rows, cols = attr_logits.shape
    if rows * cols >= 2 ** 31:
        raise ValueError(f"batch of {rows}x{cols} exceeds the kernel's "
                         "int32 row and column arguments")
    if rows == 0 or cols == 0:
        return attr_logits.new_zeros(())
    lib = _library()
    blocks = lib.examination_nll_num_blocks(rows)
    sums = torch.empty(blocks, dtype=torch.float32, device=device)
    counts = torch.empty(blocks, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.examination_nll_forward(
            *(t.data_ptr() for t in (attr_logits, clicks)),
            mask.data_ptr(),
            *(t.data_ptr() for t in (p_skip_survive, p_death, p_reset,
                                     p_reset_not)),
            sums.data_ptr(), counts.data_ptr(), rows, cols, stream)
    if err != 0:
        raise RuntimeError("examination_nll kernel launch failed: "
                           + lib.examination_nll_error_string(err).decode())
    examination_nll_cuda.launches += 1
    return torch.sum(sums) / torch.clamp_min(torch.sum(counts), 1.0)


examination_nll_cuda.launches = 0
