"""Online-softmax attention with grouped K/V heads.

Two forms of one function, q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh)
with Hq % Hkv == 0 -> (B, Hq, Sq, Dh) in q's type and q's layout:

* :func:`flash_attention_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/flash_attention.cu`` that replaces the TPU kernel
  ``repro/kernels/flash_attention.py`` (``_fa_kernel``). It takes float32
  or bfloat16 q, k and v (float32 arithmetic inside, as the Pallas kernel),
  Dh <= 128, and each of them either contiguous or as the
  ``transpose(1, 2)`` view of a contiguous (B, S, H, Dh) tensor (what
  AutoInt's projections give), so no copy is made. :func:`launch_plan`
  picks one of its two variants from the shape: ``rows`` (Dh in {4, 8,
  16}: persistent blocks that own whole batch rows, fed by bulk copies
  into a ring of shared-memory stages) or ``tiles`` (any Dh: one block per
  (batch, head, q-tile)); the source says what bounds each and how.
* :func:`flash_attention_plain`, the plain-torch form of
  ``_flash_attention_xla``: the query heads grouped through a reshape
  (never a repeat of K/V), one softmax. The CPU path runs it, the backward
  differentiates it, and the chip smoke holds the kernel against it.

``causal=True`` aligns q to the end of KV (``q_pos + Skv - Sq >= k_pos``).
With ``Sq > Skv`` that leaves the first rows no key at all, where the
Pallas kernel (finite ``NEG_INF``) and the reference (``-inf``, NaN)
disagree; no caller makes such a call, and both forms here raise on it.
``flash_attention_cuda.launches`` counts kernel launches of either variant.
"""
from __future__ import annotations

import ctypes
import functools
from fractions import Fraction
from typing import List, NamedTuple, Optional

import torch

#: Head widths the rows variant is built for (a thread holds a whole row).
ROWS_DH = (4, 8, 16)
ROWS_MAX_THREADS = 512     # kRowsMaxThreads in the source
ROWS_PER_THREAD = 2        # kRowsPerThread
ROWS_MAX_STAGES = 4        # kMaxStages
ROWS_THREADS_PER_SM = 512  # 65,536 registers at up to 128 a thread
TILES_MAX_THREADS = 128    # kTilesMaxThreads
BARRIER_BYTES = 64         # kBarrierBytes: the stages' mbarriers
BULK_ALIGN = 16            # cp.async.bulk: addresses and sizes
# H100: shared memory of one SM, the most one block may opt into, and what
# the runtime keeps per resident block.
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED_PER_BLOCK = 1024
# The rows plan takes P batch rows per group with at most this share of
# its block's lanes idle, and with this many blocks on an SM, so that one
# block's wait for its next group is covered by another block's work.
MAX_IDLE_LANES = Fraction(1, 8)
MIN_BLOCKS_PER_SM = 2
MAX_BLOCKS_PER_SM = 32
H100_SMS = 132


class Plan(NamedTuple):
    """How one call is launched. ``rows_per_block``: the query rows a block
    owns at once (P Hq Sq for rows, threads / lanes-per-row for tiles)."""
    variant: str        # "rows" or "tiles"
    threads: int
    grid: int
    smem_bytes: int     # dynamic shared memory (rows); tiles use static
    per_group: int      # rows: P batch rows per group (tiles: 0)
    stages: int         # rows: ring stages (tiles: 0)
    rows_per_block: int
    blocks_per_sm: int  # rows: resident blocks per SM the grid assumes


def _lanes_per_row(dh: int) -> int:
    return 1 if dh <= 16 else 2 if dh <= 32 else 4 if dh <= 64 else 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tiles_plan(B, Hq, Sq, Dh) -> Plan:
    g = _lanes_per_row(Dh)
    threads = min(_round_up(Sq * g, 32), TILES_MAX_THREADS)
    rows = threads // g
    return Plan("tiles", threads, B * Hq * -(-Sq // rows), 0, 0, 0, rows, 0)


def _rows_geometry(threads_per_b, span_bytes, widened_bytes, P, stages):
    """(threads, smem_bytes, blocks_per_sm) of P batch rows per group and
    ``stages`` stages, each batch row a ``span_bytes`` q, k and v span in
    every stage plus ``widened_bytes`` of float32 K/V; blocks_per_sm 0 when
    it does not fit."""
    threads = _round_up(P * threads_per_b, 32)
    smem = BARRIER_BYTES + P * (stages * span_bytes + widened_bytes)
    if threads > ROWS_MAX_THREADS or smem > SMEM_PER_BLOCK:
        return threads, smem, 0
    return threads, smem, min(ROWS_THREADS_PER_SM // threads,
                              SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK),
                              MAX_BLOCKS_PER_SM)


def launch_plan(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, Dh: int,
                itemsize: int, causal: bool = False, aligned: bool = True,
                sm_count: int = H100_SMS, per_group: Optional[int] = None,
                stages: Optional[int] = None,
                variant: Optional[str] = None) -> Plan:
    """The variant and geometry of one call, from the shape alone (and
    whether every pointer is 16-byte aligned). ``rows`` when Dh is 4, 8 or
    16, a batch row's q and k spans are whole 16-byte units, the pointers
    are aligned, and one batch row's threads and two stages fit a block;
    else ``tiles``. For rows, ``stages`` is 2 and P (``per_group``) the
    number of batch rows per group that leaves at most 1/8 of the block's
    lanes idle, lets two blocks share an SM and, among those, keeps the
    most warps resident per SM (the smaller P on a tie); the grid is as
    many blocks as fit on the card at once, at most one per group.
    ``per_group`` and ``stages``, or ``variant="tiles"``, may be given to
    measure other geometries."""
    del causal  # both variants take it; it changes no geometry
    threads_per_b = Hq * -(-Sq // ROWS_PER_THREAD)
    q_span = Hq * Sq * Dh * itemsize
    kv_span = Hkv * Skv * Dh * itemsize
    span = q_span + 2 * kv_span
    # bfloat16 K/V are widened to float32 once per group, beside the ring.
    widened = 2 * Hkv * Skv * Dh * 4 if itemsize == 2 else 0
    eligible = (Dh in ROWS_DH and aligned and q_span % BULK_ALIGN == 0
                and kv_span % BULK_ALIGN == 0
                and _rows_geometry(threads_per_b, span, widened, 1, 2)[2] > 0)
    if variant not in (None, "tiles"):
        raise ValueError(f"variant may only be forced to 'tiles', got "
                         f"{variant!r}")
    if not eligible or variant == "tiles":
        if per_group is not None or stages is not None:
            raise ValueError("per_group and stages apply to the rows variant, "
                             "which this shape does not take")
        return _tiles_plan(B, Hq, Sq, Dh)
    stages = 2 if stages is None else stages
    if not 1 <= stages <= ROWS_MAX_STAGES:
        raise ValueError(f"stages must be in 1..{ROWS_MAX_STAGES}, got "
                         f"{stages}")
    if per_group is None:
        def cost(P):  # worse: many idle lanes, a lone block, fewer warps
            threads, _, per_sm = _rows_geometry(threads_per_b, span,
                                                widened, P, stages)
            idle = Fraction(threads - P * threads_per_b, threads)
            return (idle > MAX_IDLE_LANES, per_sm < MIN_BLOCKS_PER_SM,
                    -per_sm * threads // 32, P)

        per_group = min(
            (P for P in range(1, ROWS_MAX_THREADS // threads_per_b + 1)
             if _rows_geometry(threads_per_b, span, widened, P,
                               stages)[2] > 0),
            key=cost)
    threads, smem, per_sm = _rows_geometry(threads_per_b, span, widened,
                                           per_group, stages)
    if per_sm == 0:
        raise ValueError(f"{per_group} batch rows x {stages} stages do not "
                         "fit one block")
    groups = -(-B // per_group)
    return Plan("rows", threads, max(1, min(groups, sm_count * per_sm)), smem,
                per_group, stages, per_group * Hq * Sq, per_sm)


def layout(t: torch.Tensor) -> Optional[int]:
    """0 for a contiguous (B, H, S, Dh) tensor, 1 for the transpose(1, 2)
    view of a contiguous (B, S, H, Dh) tensor, None for any other. In both,
    one batch row is one contiguous span."""
    if t.is_contiguous():
        return 0
    if t.transpose(1, 2).is_contiguous():
        return 1
    return None


def empty_like_layout(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of q's shape and type in q's layout."""
    if layout(q) == 1:
        B, H, S, D = q.shape
        return torch.empty(B, S, H, D, dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


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


def check_kernel_inputs(q, k, v) -> None:
    """Raise unless the kernel takes q, k and v's types and layouts."""
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k, v)):
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 q, "
                        f"k and v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if layout(t) is None:
            raise ValueError(
                f"flash_attention_cuda takes {name} as a contiguous (B, H, "
                f"S, Dh) tensor or the transpose(1, 2) view of a contiguous "
                f"(B, S, H, Dh) one, got strides {tuple(t.stride())}")
    if q.shape[3] > 128:
        raise ValueError(f"flash_attention_cuda takes Dh <= 128, got "
                         f"{q.shape[3]}")


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Grouped softmax attention: GQA via a reshape, never a repeated K/V.
    The result is in q's type and, like the kernel's, q's layout."""
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
    out = out.reshape(B, Hq, Sq, Dh).to(q.dtype)
    if layout(q) == 1 and not out.transpose(1, 2).is_contiguous():
        out = empty_like_layout(q).copy_(out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signatures:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("flash_attention").path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_forward.argtypes = (
        [ptr] * 4 + [i64] + [i32] * 9 + [ctypes.c_float] + [i32] * 5
        + [i64, i32, ptr])
    lib.flash_attention_forward.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = False, **overrides) -> Plan:
    """The plan :func:`flash_attention_cuda` takes for these CUDA inputs
    (its output, a fresh allocation, is aligned); ``overrides`` go to
    :func:`launch_plan`."""
    B, Hq, Sq, Dh = q.shape
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    aligned = all(t.data_ptr() % BULK_ALIGN == 0 for t in (q, k, v))
    return launch_plan(B, Hq, k.shape[1], Sq, k.shape[2], Dh,
                       q.element_size(), causal, aligned, _sm_count(index),
                       **overrides)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False, scale: Optional[float] = None,
                         plan: Optional[Plan] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. q, k and v are float32
    or bfloat16 CUDA tensors of one type on one device, each contiguous or
    a (B, S, H, Dh)-backed view, Dh <= 128; the output is in q's layout.
    ``plan`` overrides :func:`launch_plan` (to measure another geometry).
    Raises on anything else, and if the launch is refused."""
    check_shapes(q, k, v, causal)
    check_kernel_inputs(q, k, v)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{device}")
    if any(t.device != device for t in (k, v)):
        raise ValueError("flash_attention inputs lie on different devices")
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if max(B, Hq, Sq, Skv) >= 2 ** 31:
        raise ValueError("a batch, head or sequence count exceeds the "
                         "kernel's int32 arguments")
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    if B * Hq * Sq * Dh == 0:
        return empty_like_layout(q)
    if Skv == 0:
        raise ValueError("flash_attention over an empty key sequence")
    fields = None
    if plan is not None:
        fields = [int(plan.variant == "rows"), plan.per_group, plan.stages,
                  plan.threads, plan.grid, plan.smem_bytes]
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                 float(scale), fields)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, plan: Optional[List[int]]) -> torch.Tensor:
    """The launch, as a registered op: a fake tensor meets its fake form,
    which makes the output in q's layout and launches nothing. ``plan``:
    None for :func:`plan_for` (which reads the inputs' alignment), else
    the launch's (rows variant, per_group, stages, threads, grid,
    smem_bytes)."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    device = q.device
    if plan is None:
        p = plan_for(q, k, v, causal)
        plan = [int(p.variant == "rows"), p.per_group, p.stages, p.threads,
                p.grid, p.smem_bytes]
    rows, per_group, stages, threads, grid, smem_bytes = plan
    out = empty_like_layout(q)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, Dh, layout(q), layout(k), layout(v),
            int(q.dtype == torch.bfloat16), scale, int(causal), rows,
            per_group, stages, threads, grid, smem_bytes, stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        flash_attention_cuda.launches += 1
    return out


@_launch.register_fake
def _(q, k, v, causal, scale, plan):
    return empty_like_layout(q)


flash_attention_cuda.launches = 0
