"""Grouped matrix product over the experts of a dispatched MoE layer:
``out[rows of e] = a[rows of e] @ b[e]`` for each expert ``e``, where the
rows of ``a`` are the routed token-slots sorted by expert and the rows of
expert ``e`` end at ``ends[e]`` (the running sum of the experts' counts).

On a CUDA card it is PyTorch's own grouped GEMM, ``torch._grouped_mm``
(bf16 in and out, float32 accumulation), over the ``ends`` made on the
device, so the host never reads a count. It replaces no TPU kernel: the JAX
package runs its MoE as a dense oracle (every expert over every token) or
as a capacity-bounded einsum, and neither computes a grouped product. For
Moonlight-16B-A3B each of the 64 experts of a layer sees about 3,072 of the
196,608 routed rows of a 32,768-token call, and the products are bound by
operations: a (3,072 x 2,048) by (2,048 x 1,408) product does about 1,000
operations a byte it moves, far above the H100's ~295 for bf16.

:func:`grouped_mm_plain` is the plain form, a per-expert ``torch.matmul``
loop in float32 rounded once to ``a``'s type; :func:`grouped_mm` takes it
for CPU tensors, and the chip smoke holds the library to it.
"""
from __future__ import annotations

import torch


def grouped_mm_plain(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor
                     ) -> torch.Tensor:
    """The grouped product, one ``torch.matmul`` an expert in float32, the
    result rounded once to ``a``'s type: ``(M, N)``. Reads ``ends`` on the
    host."""
    out = a.new_empty((a.shape[0], b.shape[-1]))
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        out[lo:hi] = (a[lo:hi].float() @ b[e].float()).to(a.dtype)
        lo = hi
    return out


def grouped_mm(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """The grouped product of ``a`` (M, K) and ``b`` (E, K, N) over the
    experts' row ``ends`` (E,) int32, ``ends[-1] == M``: the plain form for
    CPU tensors, ``torch._grouped_mm`` for CUDA ones."""
    if a.dim() != 2 or b.dim() != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(f"grouped_mm takes a (M, K) and b (E, K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if ends.shape != (b.shape[0],):
        raise ValueError(f"grouped_mm takes one end an expert, got "
                         f"{tuple(ends.shape)} for {b.shape[0]} experts")
    if a.device.type == "cpu":
        return grouped_mm_plain(a, b, ends)
    return torch._grouped_mm(a, b, offs=ends)
