"""Sparse lazy AdamW: update only the rows of a table that a batch touched.

Two forms of one function, over a (n_rows, d) float32 table with its two
moments (float32 or bfloat16), the batch's distinct row ids (int64, padded
with the out-of-range sentinel ``n_rows``), their (slots, d) float32
gradient rows and the int32 0-d step count, already advanced:

* :func:`sparse_adamw_cuda`, the hand-written CUDA C++ kernel in
  ``csrc/sparse_adamw.cu``: one thread per (slot, column), sentinel slots
  skipped, touched rows updated in place. It is not a TPU kernel: it
  replaces the gathers and drop-mode scatters XLA fuses out of
  ``repro/optim/sparse.py`` ``sparse_adamw_update``.
* :func:`sparse_adamw_plain`, the same arithmetic in plain torch; the CPU
  runs it, and the chip smoke holds the kernel against it.

Both keep the sparse form's own order (``p - lr * u``, the update from the
unrounded moments), and both take an optional predicate, a bool 0-d tensor
on the device: where it is False nothing is written. With ``norm=True``
both also return the float64 0-d sum of ``p'^2 - p^2`` over the touched
elements, where ``p'`` is what the step would write (a sweep's telemetry:
the norm of a frozen replica's would-be update).
``sparse_adamw_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_MOMENT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with its C signature:
    ctypes would otherwise pass each pointer as a 32-bit int."""
    from repro_torch.kernels import build

    lib = ctypes.CDLL(build.build("sparse_adamw").path)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.sparse_adamw_step.argtypes = ([ptr] * 5 + [i64, i32, i64, i32]
                                      + [f32] * 7 + [ptr] * 5)
    lib.sparse_adamw_step.restype = i32
    lib.sparse_adamw_error_string.argtypes = [i32]
    lib.sparse_adamw_error_string.restype = ctypes.c_char_p
    return lib


def _check(table, mu, nu, ids, grads, count, pred=None, apply=None,
           norm=False):
    if table.dim() != 2 or mu.shape != table.shape or nu.shape != table.shape:
        raise ValueError(f"sparse_adamw: table {tuple(table.shape)} and "
                         f"moments {tuple(mu.shape)}, {tuple(nu.shape)} must "
                         f"share one (n_rows, d) shape")
    if ids.dim() != 1 or grads.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"sparse_adamw: ids {tuple(ids.shape)} and grads "
                         f"{tuple(grads.shape)} must be (slots,) and (slots, "
                         f"{table.shape[1]})")
    if table.dtype != torch.float32 or grads.dtype != torch.float32:
        raise TypeError(f"sparse_adamw takes a float32 table and grads, got "
                        f"{table.dtype} and {grads.dtype}")
    if mu.dtype not in _MOMENT_DTYPES or nu.dtype != mu.dtype:
        raise TypeError(f"sparse_adamw takes float32 or bfloat16 moments of "
                        f"one type, got {mu.dtype} and {nu.dtype}")
    if ids.dtype != torch.int64:
        raise TypeError(f"sparse_adamw takes int64 ids, got {ids.dtype}")
    if count.dtype != torch.int32 or count.dim() != 0:
        raise TypeError("sparse_adamw takes an int32 0-d step count")
    for t in (pred, apply):
        if t is not None and (t.dtype != torch.bool or t.dim() != 0):
            raise TypeError("sparse_adamw takes bool 0-d predicates")
    if apply is not None and not norm:
        raise ValueError("sparse_adamw: apply is the would-be step's "
                         "predicate, for norm=True only")


def _hyper(b1, b2):
    # 1 - b in double, rounded once to float32, as JAX's weakly typed
    # Python scalars are.
    return np.float32(b1), np.float32(b2), np.float32(1 - b1), np.float32(
        1 - b2)


@torch.no_grad()
def sparse_adamw_plain(table, mu, nu, ids, grads, count, *, lr, b1=0.9,
                       b2=0.999, eps=1e-8, weight_decay=0.0,
                       pred=None, norm=False, apply=None):
    """The plain form: gather the live slots' rows (a boolean mask drops the
    sentinel), update, scatter back in place; with a predicate, each
    scattered row is ``where(pred, new, old)``, as JAX keeps a skipped
    step's state. With ``norm=True`` the step is the would-be step under
    ``apply``, written only where ``pred`` holds too (see
    :func:`sparse_adamw_cuda`), and the sum of ``p'^2 - p^2`` is
    returned."""
    _check(table, mu, nu, ids, grads, count, pred, apply, norm)
    k = np.float32(int(count))
    b1f, b2f, omb1, omb2 = _hyper(b1, b2)
    c1 = float(np.float32(1) - b1f ** k)
    c2 = float(np.float32(1) - b2f ** k)
    live = (ids >= 0) & (ids < table.shape[0])
    rows, g = ids[live], grads[live]
    m = mu[rows].float() * float(b1f) + g * float(omb1)
    v = nu[rows].float() * float(b2f) + (g * g) * float(omb2)
    p = table[rows]
    u = (m / c1) / (torch.sqrt(v / c2) + eps)
    if weight_decay:
        u = u + p * weight_decay
    new = (p - u * lr, m.to(mu.dtype), v.to(nu.dtype))
    delta = None
    if norm:
        delta = torch.sum(new[0].double() ** 2 - p.double() ** 2)
        if apply is not None:
            delta = torch.where(apply, delta, 0.0)
            pred = apply if pred is None else pred & apply
    for t, x in zip((table, mu, nu), new):
        t[rows] = x if pred is None else torch.where(pred, x, t[rows])
    return delta


def sparse_adamw_cuda(table, mu, nu, ids, grads, count, *, lr, b1=0.9,
                      b2=0.999, eps=1e-8, weight_decay=0.0,
                      pred=None, norm=False, apply=None):
    """Launch the CUDA kernel on the current stream. All tensors on one CUDA
    device and contiguous; the ids distinct apart from the sentinel. Where
    ``pred`` (a bool 0-d tensor) is False the launch writes nothing.

    ``norm=True`` (a sweep's telemetry) also returns the float64 0-d sum of
    ``p'^2 - p^2`` over the touched elements, ``p'`` being what the step
    would write: the step runs where ``apply`` (the guard's bool 0-d
    tensor; None: always) holds, reading ``count`` as its step count (the
    count plus ``apply``, which the caller makes), and is written only where
    ``pred`` holds too. Raises on anything else, and if the launch is
    refused."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"sparse_adamw_cuda needs CUDA tensors, got {device}")
    _check(table, mu, nu, ids, grads, count, pred, apply, norm)
    for t in (mu, nu, ids, grads, count) + tuple(
            t for t in (pred, apply) if t is not None):
        if t.device != device:
            raise ValueError("sparse_adamw inputs lie on different devices")
    if not all(t.is_contiguous() for t in (table, mu, nu, ids, grads)):
        raise ValueError("sparse_adamw_cuda takes contiguous tensors")
    slots, d = grads.shape
    if slots * d >= 2 ** 31 * 256:
        raise ValueError(f"{slots} x {d} exceeds one launch's grid")
    if slots * d == 0:
        return torch.zeros((), dtype=torch.float64, device=device) \
            if norm else None
    partials = (torch.empty(-(-slots * d // 256), dtype=torch.float64,
                            device=device) if norm else None)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sparse_adamw_step(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), ids.data_ptr(),
            grads.data_ptr(), slots, d, table.shape[0],
            _MOMENT_DTYPES[mu.dtype], b1, b2, 1.0 - b1, 1.0 - b2, eps,
            weight_decay, lr, count.data_ptr(),
            None if pred is None else pred.data_ptr(),
            None if apply is None else apply.data_ptr(),
            None if partials is None else partials.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("sparse_adamw kernel launch failed: "
                           + lib.sparse_adamw_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        sparse_adamw_cuda.launches += 1
    return None if partials is None else partials.sum()


sparse_adamw_cuda.launches = 0
