"""Dense AdamW in one pass over a parameter tensor.

:func:`adamw_cuda` launches the hand-written CUDA C++ kernel in
``csrc/adamw.cu``: it reads the parameter, its gradient and both moments
once and writes the parameter and the moments once, in place, keeping the
JAX chain's order of operations (``repro/optim/optimizers.py:93-150``),
with float32 or bfloat16 parameters, gradients and moments: a bfloat16
parameter is written as ``apply_updates`` writes it (``:29-31``), the update
rounded to bfloat16 and then added in bfloat16. It
is not a TPU kernel: it replaces the loop XLA fuses out of that chain. Its
plain version is the chain itself, ``repro_torch.optim.adamw``'s ``update``
followed by ``apply_updates``, which the CPU runs;
``repro_torch.optim.step`` picks by device. With ``norm=True`` the launch
also returns the sum of squares of the parameters the step would write
(the engine's telemetry: ``repro_torch.optim.step(..., norm=True)``).

``adamw_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's codes
THREADS = 256           # the kernel's __launch_bounds__
BLOCKS_PER_SM = 8       # 2,048 resident threads an SM at 256 a block


class LaunchPlan(NamedTuple):
    blocks: int
    threads: int
    vector: bool     # 4-element vectors, then the n % 4 tail one by one


def launch_plan(n: int, vector: bool, sm_count: int) -> LaunchPlan:
    """The grid of one launch over ``n`` elements: one thread per 4-element
    vector (or per element when the pointers are not aligned for vectors),
    capped at ``BLOCKS_PER_SM`` resident blocks an SM, over which the
    kernel's grid-stride loop walks. Element ``i`` of the vectors' range
    belongs to vector ``i // 4``, visited by thread ``i // 4 % (blocks *
    threads)``; tail element ``n_vec * 4 + t`` to thread ``t % (blocks *
    threads)``."""
    units = max(n // 4 if vector else n, 1)
    blocks = min(-(-units // THREADS), BLOCKS_PER_SM * sm_count)
    return LaunchPlan(blocks, THREADS, vector)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signature:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("adamw").path)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.adamw_step.argtypes = ([ptr] * 4 + [i64] + [i32] * 4 + [f32] * 7
                               + [ptr] * 5 + [i32, i32, ptr])
    lib.adamw_step.restype = i32
    lib.adamw_error_string.argtypes = [i32]
    lib.adamw_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def adamw_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, count: torch.Tensor, *, b1: float, b2: float,
               eps: float, weight_decay: float, lr: float,
               lr_tensor: Optional[torch.Tensor] = None,
               pred: Optional[torch.Tensor] = None, norm: bool = False,
               apply: Optional[torch.Tensor] = None
               ) -> Optional[torch.Tensor]:
    """One AdamW step of ``p`` in place, with its moments ``m`` and ``v``.

    ``p``, ``g`` and the moments ``m`` and ``v`` (both of one type) are each
    float32 or bfloat16, all of one shape, contiguous and on one CUDA
    device. ``count`` is the int32 0-d
    step count on that device, already advanced for this step; the kernel
    reads it there, and reads the learning rate from ``lr_tensor`` (a
    float32 0-d tensor) when one is given, else takes ``lr``. ``pred``, a
    bool 0-d tensor on that device, is the step's predicate (the
    non-finite guard's, a sweep's active replica): where it is False the
    launch writes nothing, and the caller advances ``count`` by it.

    ``norm=True`` (a sweep's telemetry) also returns the float64 0-d sum of
    squares of the parameters the step *would* write: the step runs where
    ``apply`` (a bool 0-d tensor, the guard's; None: always) holds, reading
    ``count`` as its step count (the count plus ``apply``, which the caller
    makes), and is written only where ``pred`` holds too; where ``apply``
    is False the parameter counts as it stands. Raises on anything else,
    and if the launch is refused."""
    device = p.device
    if device.type != "cuda":
        raise ValueError(f"adamw_cuda needs CUDA tensors, got {device}")
    for name, t in (("g", g), ("m", m), ("v", v), ("count", count)) + (
            (("lr", lr_tensor),) if lr_tensor is not None else ()) + (
            (("pred", pred),) if pred is not None else ()) + (
            (("apply", apply),) if apply is not None else ()):
        if t.device != device:
            raise ValueError(f"adamw_cuda: {name} on {t.device}, p on "
                             f"{device}")
    if g.shape != p.shape or m.shape != p.shape or v.shape != p.shape:
        raise ValueError(f"adamw_cuda: shapes p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                         f"{tuple(v.shape)} differ")
    if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
        raise TypeError(f"adamw_cuda takes float32 or bfloat16 p and g, got "
                        f"{p.dtype} and {g.dtype}")
    if m.dtype not in _DTYPES or v.dtype != m.dtype:
        raise TypeError(f"adamw_cuda takes float32 or bfloat16 moments of "
                        f"one type, got {m.dtype} and {v.dtype}")
    if count.dtype != torch.int32 or count.dim() != 0:
        raise TypeError("adamw_cuda takes an int32 0-d step count")
    if lr_tensor is not None and (lr_tensor.dtype != torch.float32
                                  or lr_tensor.dim() != 0):
        raise TypeError("adamw_cuda takes a float32 0-d injected lr")
    for t in (pred, apply):
        if t is not None and (t.dtype != torch.bool or t.dim() != 0):
            raise TypeError("adamw_cuda takes bool 0-d predicates")
    if apply is not None and not norm:
        raise ValueError("adamw_cuda: apply is the would-be step's "
                         "predicate, for norm=True only")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("adamw_cuda takes contiguous tensors")
    if p.numel() == 0:
        return torch.zeros((), dtype=torch.float64, device=device) \
            if norm else None
    out = torch.ops.repro_torch.adamw(
        p, g, m, v, count, lr_tensor, pred, apply, bool(norm), float(b1),
        float(b2), float(eps), float(weight_decay), float(lr))
    return out if norm else None


@torch.library.custom_op("repro_torch::adamw", mutates_args=("p", "m", "v"),
                         device_types="cuda")
def _launch(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor, count: torch.Tensor,
            lr_tensor: Optional[torch.Tensor], pred: Optional[torch.Tensor],
            apply: Optional[torch.Tensor], norm: bool, b1: float, b2: float,
            eps: float, weight_decay: float, lr: float) -> torch.Tensor:
    """The launch, as a registered op that writes ``p``, ``m`` and ``v`` in
    place: a fake tensor meets its fake form, which launches nothing. It
    returns the 0-d float64 sum of squares with ``norm``, else an empty
    (0,) tensor (an op returns a tensor or nothing, never either)."""
    device = p.device
    n = p.numel()
    vector = all(_aligned(t, 4 * t.element_size()) for t in (p, g, m, v))
    plan = launch_plan(n, vector, _sm_count(device.index
                                            if device.index is not None
                                            else torch.cuda.current_device()))
    partials = (torch.empty(plan.blocks, dtype=torch.float64, device=device)
                if norm else None)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.adamw_step(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
            _DTYPES[p.dtype], _DTYPES[g.dtype], _DTYPES[m.dtype],
            int(plan.vector), b1, b2, 1.0 - b1,
            1.0 - b2, eps, weight_decay, lr, count.data_ptr(),
            None if lr_tensor is None else lr_tensor.data_ptr(),
            None if pred is None else pred.data_ptr(),
            None if apply is None else apply.data_ptr(),
            None if partials is None else partials.data_ptr(),
            plan.blocks, plan.threads, stream)
    if err != 0:
        raise RuntimeError("adamw kernel launch failed: "
                           + lib.adamw_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        adamw_cuda.launches += 1
    if partials is None:
        return torch.empty(0, dtype=torch.float64, device=device)
    return partials.sum()


@_launch.register_fake
def _(p, g, m, v, count, lr_tensor, pred, apply, norm, b1, b2, eps,
      weight_decay, lr):
    return p.new_empty(() if norm else (0,), dtype=torch.float64)


adamw_cuda.launches = 0
