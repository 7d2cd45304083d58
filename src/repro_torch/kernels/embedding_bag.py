"""Fused embedding-bag gather + weighted reduce.

Two forms of one function, ``out[b] = sum_l w[b,l] * table[ids[b,l]]``
with table (N, D) float32 and ids, weights (B, L) -> (B, D) float32. Ids
< 0 are padding and contribute nothing; an id >= N reads row N - 1, as
``bag_lookup``'s clip does, so callers hand raw ids over without a pass:

* :func:`embedding_bag_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/embedding_bag.cu`` that replaces the TPU kernel
  ``repro/kernels/embedding_bag.py`` (``_bag_kernel``). It reads int32 or
  int64 ids as it is given them. :func:`launch_plan` picks one of its two
  variants from the shape: ``slots`` (D <= 16: a block owns a tile of
  whole bags, stages their ids through shared memory and keeps many
  gathers in flight per thread) or ``wide`` (one thread per (bag, d), the
  rows read coalesced); its source says what bounds each and how.
* :func:`embedding_bag_plain`, the plain-torch form of
  ``_embedding_bag_xla`` (clamp the ids, gather (B, L, D), zero the padding
  weights, sum over L). The CPU path runs it, and the chip smoke holds the
  kernel against it.

``weights=None`` means all ones and reads no weight array.
``embedding_bag_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

#: Widest rows the slots variant takes; wider rows are read coalesced by the
#: wide variant's one thread per (bag, d).
SLOTS_MAX_DIM = 16
SLOTS_THREADS = 256        # kSlotsThreads in the source
WIDE_THREADS = 256         # kWideThreads
#: The slots plan takes enough bags per tile for this many gathers per
#: thread (the source issues up to 16 before it uses any) ...
GATHERS_PER_THREAD = 8
#: ... within this much shared memory, so that several blocks share an SM
#: (above 48 KB a block must opt in).
SLOTS_SMEM_TARGET = 48 * 1024
#: ... and small enough that there are two tiles per SM where the bags
#: allow it.
MIN_TILES = 2 * 132
#: H100: the most shared memory one block may opt into.
SMEM_PER_BLOCK = 232_448
ID_TYPES = (torch.int32, torch.int64)


class Plan(NamedTuple):
    """How one call is launched. ``tile_bags``: slots, T bags per block
    (wide: 0); ``smem_bytes``: the slots variant's dynamic shared memory."""
    variant: str        # "slots" or "wide"
    threads: int
    grid: int
    tile_bags: int
    smem_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def slots_smem_bytes(tile_bags: int, slots: int, dim: int, id_itemsize: int,
                     weighted: bool) -> int:
    """Shared memory of one slots block (the source's layout): the tile's
    ids, its weights if any, each rounded to 16 bytes, and its gathered
    floats."""
    n = tile_bags * slots
    return (_round_up(n * id_itemsize, 16)
            + (_round_up(n * 4, 16) if weighted else 0) + n * dim * 4)


def launch_plan(rows: int, dim: int, bags: int, slots: int, id_itemsize: int,
                weighted: bool = False, tile_bags: Optional[int] = None,
                variant: Optional[str] = None) -> Plan:
    """The variant and geometry of one call, from the shape alone. ``slots``
    when D <= 16 and a tile of the fewest bags fits a block, else ``wide``.
    For slots, T (``tile_bags``) is a multiple of the smallest tile whose
    ids and weights are whole 16-byte units (4 / gcd(L, 4) bags), the
    fewest that give every thread >= 8 gathers, cut to what fits 48 KB of
    shared memory and to two tiles per SM where there are the bags; the
    grid is one block per tile, and the gathers run slot-major (a warp's
    lanes read one slot of neighbouring bags, so the repeated ids of a
    skewed field share sectors). ``tile_bags``, or ``variant="wide"``, may
    be given to measure other geometries."""
    del rows  # no geometry depends on it
    if id_itemsize not in (4, 8):
        raise ValueError(f"ids are 4 or 8 bytes, got {id_itemsize}")
    if variant not in (None, "slots", "wide"):
        raise ValueError(f"unknown variant {variant!r}")
    unit = 4 // math.gcd(slots, 4) if slots else 1

    def smem(T):
        return slots_smem_bytes(T, slots, dim, id_itemsize, weighted)

    eligible = (0 < dim <= SLOTS_MAX_DIM and slots > 0
                and smem(unit) <= SMEM_PER_BLOCK)
    if variant == "wide" or (variant is None and not eligible):
        if tile_bags is not None:
            raise ValueError("tile_bags applies to the slots variant, which "
                             "this call does not take")
        return Plan("wide", WIDE_THREADS,
                    max(1, -(-bags * dim // WIDE_THREADS)), 0, 0)
    if not eligible:
        raise ValueError(f"D = {dim}, L = {slots} do not fit the slots "
                         "variant")
    if tile_bags is None:
        want = _round_up(-(-GATHERS_PER_THREAD * SLOTS_THREADS
                           // (slots * dim)), unit)
        fits = max(unit, SLOTS_SMEM_TARGET // smem(unit) * unit)
        while smem(fits) > SLOTS_SMEM_TARGET and fits > unit:
            fits -= unit
        spread = bags // MIN_TILES // unit * unit
        tile_bags = max(unit, min(want, fits, max(spread, unit)))
    if tile_bags < 1 or tile_bags % unit:
        raise ValueError(f"tile_bags must be a positive multiple of {unit} "
                         f"at L = {slots}, got {tile_bags}")
    if smem(tile_bags) > SMEM_PER_BLOCK:
        raise ValueError(f"{tile_bags} bags of L = {slots}, D = {dim} need "
                         f"{smem(tile_bags)} bytes of shared memory")
    return Plan("slots", SLOTS_THREADS, max(1, -(-bags // tile_bags)),
                tile_bags, smem(tile_bags))


def plan_for(table: torch.Tensor, ids: torch.Tensor,
             weights: Optional[torch.Tensor] = None, **overrides) -> Plan:
    """``launch_plan`` for these tensors."""
    return launch_plan(table.shape[0], table.shape[1], ids.shape[0],
                       ids.shape[1], ids.element_size(),
                       weighted=weights is not None, **overrides)


def embedding_bag_plain(table, ids, weights=None) -> torch.Tensor:
    """Gather (B, L, D) with ids clamped to [0, N - 1], zero the padding
    slots' weights, sum over L."""
    safe = torch.clamp(ids, 0, max(table.shape[0] - 1, 0)).long()
    gathered = table[safe].float()                             # (B, L, D)
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
                                                      i32, i32, i32, ptr]
    lib.embedding_bag_forward.restype = i32
    lib.embedding_bag_error_string.argtypes = [i32]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       plan: Optional[Plan] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. ``table`` is a (N, D)
    float32 with N >= 1, ``ids`` a (B, L) int32 or int64 and ``weights``
    None or a (B, L) float32 tensor, all contiguous on one CUDA device. Ids
    < 0 are padding, ids >= N read row N - 1. ``plan`` (default
    :func:`plan_for` these tensors) may be given to measure another
    geometry. Raises on anything else, and if the launch is refused."""
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
    if ids.dtype not in ID_TYPES:
        raise TypeError(f"embedding_bag takes int32 or int64 ids, got "
                        f"{ids.dtype}")
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
    out = torch.empty(bags, dim, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if rows == 0 and slots > 0:
        raise ValueError("embedding_bag takes a table of at least one row")
    if plan is None:
        plan = plan_for(table, ids, weights)
    if plan.grid >= 2 ** 31:
        raise ValueError(f"{bags} bags x {dim} exceeds one launch's grid")
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.embedding_bag_forward(
            table.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            rows, dim, bags, slots, ids.element_size(), plan.tile_bags,
            plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError("embedding_bag kernel launch failed: "
                           + lib.embedding_bag_error_string(err).decode())
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
