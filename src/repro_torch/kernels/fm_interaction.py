"""Factorization-machine second-order term [Rendle 2010]:
``out[b] = 0.5 * sum_d[(sum_f v[b,f,d])^2 - sum_f v[b,f,d]^2]``,
(B, F, D) -> (B,) float32.

* :func:`fm_interaction_triton`, a hand-written Triton kernel that replaces
  the TPU kernel ``repro/kernels/fm_interaction.py`` (``_fm_kernel``). What
  bounds it: bytes. It reads v once and writes one float per row, ~4
  operations per element read; at DeepFM's shape (65,536 x 39 x 10) that is
  102 MB, ~30.6 us at 3.35 TB/s. Design: the work is one fused read and two
  reductions, what Triton's block model is for. A program owns BLOCK_B rows
  as a (BLOCK_B, BLOCK_F, BLOCK_D) block: F = 39 and D = 10 are not powers
  of two, so the padded part of the block is masked on load (zeros add
  nothing to either sum), and for wide rows the program loops over F in
  chunks. The (sum_f v)^2 - sum_f v^2 difference is taken per d *before*
  the d-sum: the two totals are large and nearly equal, and subtracting
  them last loses most of the result to cancellation.
* :func:`fm_interaction_plain`, the plain-torch form of
  ``_fm_interaction_xla`` (also subtracting per d). The CPU path runs it,
  and the chip smoke holds the kernel against it.

``triton`` is imported on the first launch, never at module import.
``fm_interaction_triton.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

# Elements of v a program holds at once (the block's padded size).
BLOCK_ELEMENTS = 4096
MAX_D = 4096

tl = None  # triton.language, bound by _kernel() on the first launch
_compiled = None


def fm_interaction_plain(v) -> torch.Tensor:
    vf = v.float()
    s = torch.sum(vf, dim=1)
    return 0.5 * torch.sum(torch.square(s) - torch.sum(torch.square(vf), dim=1),
                           dim=-1)


def _fm_kernel(v_ptr, out_ptr, n_rows, n_fields, n_dims,
               BLOCK_B: tl.constexpr, BLOCK_F: tl.constexpr,
               BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    rows = pid.to(tl.int64) * BLOCK_B + tl.arange(0, BLOCK_B)
    fields = tl.arange(0, BLOCK_F)
    dims = tl.arange(0, BLOCK_D)
    row_ok = rows < n_rows
    dim_ok = dims < n_dims
    base = rows * n_fields * n_dims
    s = tl.zeros((BLOCK_B, BLOCK_D), dtype=tl.float32)
    sq = tl.zeros((BLOCK_B, BLOCK_D), dtype=tl.float32)
    for f0 in range(0, n_fields, BLOCK_F):
        f = f0 + fields
        offs = (base[:, None, None] + f[None, :, None] * n_dims
                + dims[None, None, :])
        live = (row_ok[:, None, None] & (f < n_fields)[None, :, None]
                & dim_ok[None, None, :])
        x = tl.load(v_ptr + offs, mask=live, other=0.0)
        s += tl.sum(x, axis=1)
        sq += tl.sum(x * x, axis=1)
    out = 0.5 * tl.sum(s * s - sq, axis=1)  # per-d difference, then d-sum
    tl.store(out_ptr + rows, out, mask=row_ok)


def _kernel():
    global tl, _compiled
    if _compiled is None:
        import triton
        import triton.language as tl  # noqa: F811 - binds the kernel's global
        _compiled = triton.jit(_fm_kernel)
    return _compiled


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def block_shape(n_fields: int, n_dims: int):
    """(BLOCK_B, BLOCK_F, BLOCK_D) for a (B, F, D) input: D padded to a power
    of two, as many fields as fit BLOCK_ELEMENTS, then as many rows."""
    block_d = _pow2(n_dims)
    block_f = min(_pow2(n_fields), max(1, BLOCK_ELEMENTS // block_d))
    block_b = max(1, BLOCK_ELEMENTS // (block_f * block_d))
    return block_b, block_f, block_d


def fm_interaction_triton(v: torch.Tensor) -> torch.Tensor:
    """Launch the Triton kernel. ``v`` is a (B, F, D) float32 contiguous CUDA
    tensor with D <= 4096. Raises on anything else."""
    device = v.device
    if device.type != "cuda":
        raise ValueError(f"fm_interaction_triton needs CUDA tensors, got "
                         f"{device}")
    if v.dim() != 3:
        raise ValueError(f"fm_interaction takes (B, F, D), got "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError("fm_interaction input must be contiguous")
    if v.dtype != torch.float32:
        raise TypeError(f"fm_interaction takes float32, got {v.dtype}")
    B, F, D = v.shape
    if D > MAX_D:
        raise ValueError(f"fm_interaction_triton takes D <= {MAX_D}, got {D}")
    if B == 0:
        return torch.empty(B, dtype=torch.float32, device=device)
    if F == 0 or D == 0:
        return torch.zeros(B, dtype=torch.float32, device=device)
    return torch.ops.repro_torch.fm_interaction(v)


@torch.library.custom_op("repro_torch::fm_interaction", mutates_args=(),
                         device_types="cuda")
def _launch(v: torch.Tensor) -> torch.Tensor:
    """The launch, as a registered op: a fake tensor meets its fake form,
    which makes the (B,) output and launches nothing."""
    B, F, D = v.shape
    out = torch.empty(B, dtype=torch.float32, device=v.device)
    block_b, block_f, block_d = block_shape(F, D)
    grid = ((B + block_b - 1) // block_b,)
    with torch.cuda.device(v.device):
        # No fma contraction: s*s - sq must round as the plain form does,
        # so a row of one field gives exactly 0.
        _kernel()[grid](v, out, B, F, D, BLOCK_B=block_b, BLOCK_F=block_f,
                        BLOCK_D=block_d, num_warps=8, enable_fp_fusion=False)
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        fm_interaction_triton.launches += 1
    return out


@_launch.register_fake
def _(v):
    return v.new_empty((v.shape[0],), dtype=torch.float32)


fm_interaction_triton.launches = 0
