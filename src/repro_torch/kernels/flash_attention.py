"""Online-softmax attention with grouped K/V heads.

Two forms of one function, q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh)
with Hq % Hkv == 0 -> (B, Hq, Sq, Dh):

* :func:`flash_attention_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/flash_attention.cu`` that replaces the TPU kernel
  ``repro/kernels/flash_attention.py`` (``_fa_kernel``). One block per
  (batch, head, q-tile) streams K/V through shared memory with a float32
  running max, sum and accumulator; its source says what bounds it and how
  the design answers that. It takes float32 (bf16 inputs are a ROADMAP
  item) and Dh <= 128.
* :func:`flash_attention_plain`, the plain-torch form of
  ``_flash_attention_xla``: the query heads grouped through a reshape
  (never a repeat of K/V), one softmax. The CPU path runs it, the backward
  differentiates it, and the chip smoke holds the kernel against it.

``causal=True`` aligns q to the end of KV (``q_pos + Skv - Sq >= k_pos``).
With ``Sq > Skv`` that leaves the first rows no key at all, where the
Pallas kernel (finite ``NEG_INF``) and the reference (``-inf``, NaN)
disagree; no caller makes such a call, and both forms here raise on it.
``flash_attention_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch


def check_shapes(q, k, v, causal) -> None:
    """Raise unless q, k, v form a grouped attention call both forms take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, S, Dh) q, k and v")
    B, Hq, Sq, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {k.shape[1]}")
    if causal and Sq > k.shape[2]:
        raise ValueError(f"causal attention with Sq = {Sq} > Skv = "
                         f"{k.shape[2]} leaves rows that see no key")


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Grouped softmax attention: GQA via a reshape, never a repeated K/V."""
    check_shapes(q, k, v, causal)
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, Dh).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, Hq, Sq, Dh).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signatures:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("flash_attention").path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = (
        [ptr] * 4 + [ctypes.c_longlong] + [i32] * 5
        + [ctypes.c_float, i32, ptr])
    lib.flash_attention_forward.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. q, k and v are float32
    contiguous CUDA tensors on one device, Dh <= 128. Raises on anything
    else, and if the launch is refused."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{device}")
    check_shapes(q, k, v, causal)
    for t in (q, k, v):
        if t.device != device:
            raise ValueError("flash_attention inputs lie on different devices")
        if not t.is_contiguous():
            raise ValueError("flash_attention inputs must be contiguous")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention_cuda takes float32, got "
                            f"{t.dtype}")
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Dh > 128:
        raise ValueError(f"flash_attention_cuda takes Dh <= 128, got {Dh}")
    if max(Hq, Sq, Skv) >= 2 ** 31:
        raise ValueError("a head or sequence count exceeds the kernel's "
                         "int32 arguments")
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention over an empty key sequence")
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, Dh, float(scale), int(causal), stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
