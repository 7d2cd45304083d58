"""Fused session NLL (GCTR / RCTR / DCTR loss): masked mean of
softplus(x) - c x, straight from logits.

* :func:`session_nll_triton`, a hand-written Triton kernel that replaces the
  TPU kernel ``repro/kernels/session_nll.py`` (``_session_nll_kernel``).
  What bounds it: bytes. Per element it reads a float32 logit, a float32
  click and a bool mask (9 bytes) for ~10 flops; at the main-path shape
  (65,536 x 10) that is 5.9 MB, 1.8 us at 3.35 TB/s, so one launch is
  launch-bound. Design: the work is one fused elementwise pass and a sum,
  so the (B, K) batch is flattened and cut into power-of-two blocks with a
  masked tail (K = 10 needs no padding to a lane width). Each program writes
  one (sum, count) partial; the caller sums the partials (no atomics, so the
  loss is the same from run to run).
* :func:`session_nll_plain`, the plain-torch form (``repro/kernels/ops.py``
  ``_session_nll_xla``), which the CPU path runs and the chip smoke holds
  the kernel against.

``triton`` is imported on the first launch, never at module import.
``session_nll_triton.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

BLOCK = 1024

tl = None  # triton.language, bound by _kernel() on the first launch
_compiled = None


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


def session_nll_triton(logits, clicks, mask) -> torch.Tensor:
    """Launch the Triton kernel. Inputs are (B, K) contiguous CUDA tensors on
    one device: float32 logits and clicks, bool mask. Raises on anything
    else."""
    device = logits.device
    if device.type != "cuda":
        raise ValueError(f"session_nll_triton needs CUDA tensors, got {device}")
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
    n = logits.numel()
    if n == 0:
        return logits.new_zeros(())
    grid = (n + BLOCK - 1) // BLOCK
    sums = torch.empty(grid, dtype=torch.float32, device=device)
    counts = torch.empty(grid, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _kernel()[(grid,)](logits, clicks, mask.view(torch.uint8), sums,
                           counts, n, BLOCK=BLOCK, num_warps=4)
    session_nll_triton.launches += 1
    return torch.sum(sums) / torch.clamp_min(torch.sum(counts), 1.0)


session_nll_triton.launches = 0
