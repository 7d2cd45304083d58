"""Fused embedding-bag gather + weighted reduce.

Two forms of one function, ``out[b] = sum_l w[b,l] * table[ids[b,l]]``
with ids < 0 as padding, table (N, D) float32 and ids, weights (B, L) ->
(B, D) float32:

* :func:`embedding_bag_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/embedding_bag.cu`` that replaces the TPU kernel
  ``repro/kernels/embedding_bag.py`` (``_bag_kernel``). One thread per
  (bag, d) output element walks the bag's slots, so DeepFM's D = 1
  first-order table wastes no lane where the TPU kernel pads each row to
  128; its source says what bounds it and how the design answers that.
* :func:`embedding_bag_plain`, the plain-torch form of
  ``_embedding_bag_xla`` (clamp the ids, gather (B, L, D), zero the padding
  weights, sum over L). The CPU path runs it, and the chip smoke holds the
  kernel against it.

The kernel reads int64 ids (what ``hash_ids`` and torch indexing give; the
JAX package uses int32). ``weights=None`` means all ones and reads no
weight array. ``embedding_bag_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch


def embedding_bag_plain(table, ids, weights=None) -> torch.Tensor:
    """Gather (B, L, D), zero the padding slots' weights, sum over L."""
    gathered = table[torch.clamp_min(ids, 0).long()].float()   # (B, L, D)
    w = (ids >= 0).float() if weights is None else torch.where(
        ids >= 0, weights, 0.0).float()
    return torch.sum(gathered * w[..., None], dim=1)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signatures:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("embedding_bag").path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.embedding_bag_forward.argtypes = [ptr] * 4 + [i64, i32, i64, i32,
                                                      ptr]
    lib.embedding_bag_forward.restype = i32
    lib.embedding_bag_error_string.argtypes = [i32]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. ``table`` is a (N, D)
    float32, ``ids`` a (B, L) int64 and ``weights`` None or a (B, L)
    float32 tensor, all contiguous on one CUDA device; ids must be < N.
    Raises on anything else, and if the launch is refused."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors, got {device}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"embedding_bag takes a (N, D) table and (B, L) ids, "
                         f"got {tuple(table.shape)} and {tuple(ids.shape)}")
    operands = (table, ids) if weights is None else (table, ids, weights)
    for t in operands:
        if t.device != device:
            raise ValueError("embedding_bag inputs lie on different devices")
        if not t.is_contiguous():
            raise ValueError("embedding_bag inputs must be contiguous")
    if table.dtype != torch.float32:
        raise TypeError(f"embedding_bag takes a float32 table, got "
                        f"{table.dtype}")
    if ids.dtype != torch.int64:
        raise TypeError(f"embedding_bag takes int64 ids, got {ids.dtype}")
    if weights is not None:
        if weights.shape != ids.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != ids "
                             f"{tuple(ids.shape)}")
        if weights.dtype != torch.float32:
            raise TypeError(f"embedding_bag takes float32 weights, got "
                            f"{weights.dtype}")
    rows, dim = table.shape
    bags, slots = ids.shape
    if dim >= 2 ** 31 or slots >= 2 ** 31:
        raise ValueError(f"D = {dim} or L = {slots} exceeds the kernel's "
                         "int32 arguments")
    if -(-bags * dim // 256) >= 2 ** 31:
        raise ValueError(f"{bags} bags x {dim} exceeds one launch's grid")
    out = torch.empty(bags, dim, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.embedding_bag_forward(
            table.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            rows, dim, bags, slots, stream)
    if err != 0:
        raise RuntimeError("embedding_bag kernel launch failed: "
                           + lib.embedding_bag_error_string(err).decode())
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
