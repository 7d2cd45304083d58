"""The work each kernel op must do, from its arguments' shapes and types.

For each registered kernel op (``repro_torch::<name>``) a function of the
op's own arguments returns a :class:`Cost`: the ``flops`` the kernel must
do (every compare, select, add, multiply, divide and transcendental counts
one, counted from the kernel sources) and the ``bytes`` it must move, each
input read once and each output written once. :func:`bound_ms` turns a
cost into the least time an H100 could take for it. The dry run's counter
(:mod:`repro_torch.launch.op_cost`) charges each op met with this cost,
and ``chip_smoke.py`` takes every kernel's bound from it.

Two kernels do work that depends on their data: ``embedding_bag`` reads
each 32-byte table sector a live id touches, ``sparse_adamw`` each sector
a live row lies in. Their functions take that count (``sectors``, and
``live`` slots for ``sparse_adamw``) where the caller has counted it from
the data; a dry run has no data, and its count is then the most the shapes
allow (every slot its own sectors, at most the table's).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside
#: the tensor cores; every kernel here is float32 arithmetic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
SECTOR = 32

#: Operations per (B, K) element of the loss kernels.
OPS_PER_ELEMENT = {"examination_nll": 44, "session_nll": 12}
#: Operations per element of one AdamW step, weight decay on
#: (``csrc/adamw.cu``).
ADAMW_OPS_PER_ELEMENT = 16


class Cost(NamedTuple):
    flops: float
    bytes: float


def bound_ms(cost: Cost) -> Tuple[float, str]:
    """``(ms, "bytes" or "operations")``: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes = cost.bytes / PEAK_BYTES_PER_S
    t_ops = cost.flops / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _numel(t) -> int:
    n = 1
    for s in t.shape:
        n *= int(s)
    return n


def _itemsize(t) -> int:
    return t.dtype.itemsize


def examination_nll(attr_logits, clicks, mask, *rest, **kw) -> Cost:
    """Six float32 (B, K) inputs and the bool mask read, a scalar
    written."""
    n = _numel(attr_logits)
    return Cost(n * OPS_PER_ELEMENT["examination_nll"], n * (6 * 4 + 1) + 4)


def session_nll(logits, clicks, mask, *rest, **kw) -> Cost:
    """Float32 logits and clicks and the bool mask read, a scalar
    written."""
    n = _numel(logits)
    return Cost(n * OPS_PER_ELEMENT["session_nll"], n * (2 * 4 + 1) + 4)


def row_sectors(dim: int) -> int:
    """The most 32-byte sectors one float32 row of ``dim`` touches when the
    table starts on a sector boundary."""
    span = dim * 4
    if not span:
        return 0
    # a row starts at a multiple of gcd(span, 32) within its sector
    return -(-(span + SECTOR - math.gcd(span, SECTOR)) // SECTOR)


def embedding_bag(table, ids, weights=None, *rest,
                  sectors: Optional[int] = None, **kw) -> Cost:
    """Ids (and weights) read once, each 32-byte table sector a live id
    touches read once (``sectors``; by default every slot's own, at most
    the table's), the (B, D) output written once; a multiply-add per
    gathered float. Ids count 4 bytes while the table has fewer than 2^31
    rows (the function needs no more; the TPU kernel reads int32)."""
    rows, dim = (int(s) for s in table.shape)
    slots = _numel(ids)
    if sectors is None:
        sectors = min(slots * row_sectors(dim),
                      -(-rows * dim * 4 // SECTOR))
    id_bytes = 4 if rows < 2 ** 31 else 8
    nbytes = (slots * id_bytes + sectors * SECTOR + int(ids.shape[0]) * dim * 4
              + (0 if weights is None else _numel(weights) * 4))
    return Cost(2 * slots * dim, nbytes)


def fm_interaction(v, *rest, **kw) -> Cost:
    """(B, F, D) float32 read, (B,) written; an add, a square, an add and
    a subtract per element."""
    n = _numel(v)
    return Cost(4 * n, n * 4 + int(v.shape[0]) * 4)


def attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs one head computes: all of them, or with the
    causal mask aligned to the end of the keys the ones at or below it."""
    if not causal:
        return sq * skv
    return sq * skv - sq * (sq - 1) // 2


def flash_attention(q, k, v, causal=False, *rest, **kw) -> Cost:
    """q, k, v read once and o written once, in their own type; per (query,
    key) pair 2 Dh operations for the score, 2 Dh for the weighted sum and
    one exp."""
    B, Hq, Sq, Dh = (int(s) for s in q.shape)
    pairs = attention_pairs(Sq, int(k.shape[2]), bool(causal))
    nbytes = _itemsize(q) * (2 * _numel(q) + _numel(k) + _numel(v))
    return Cost(B * Hq * pairs * (4 * Dh + 1), nbytes)


def dcn_cross(x0, x, w, b, *rest, **kw) -> Cost:
    """x0 and x read once, W and b read once, the float32 output written
    once; 2 D operations per output element for the product, 3 for the
    epilogue (+ b, * x0, + x)."""
    rows, dim = (int(s) for s in x.shape)
    nbytes = ((2 * rows * dim + dim * dim + dim) * _itemsize(x)
              + rows * dim * 4)
    return Cost(rows * dim * (2 * dim + 3), nbytes)


def adamw(p, g, m, v, *rest, **kw) -> Cost:
    """p, g and both moments read, p and both moments written, each in its
    own type: 28 bytes an element in float32."""
    n = _numel(p)
    per = 2 * _itemsize(p) + _itemsize(g) + 4 * _itemsize(m)
    return Cost(n * ADAMW_OPS_PER_ELEMENT, n * per)


def sparse_adamw(table, mu, nu, ids, grads, count=None, pred=None,
                 apply=None, norm=False, lr=0.0, b1=0.0, b2=0.0, eps=0.0,
                 weight_decay=0.0, span=None, table_grad=False, *,
                 sectors: Optional[int] = None, live: Optional[int] = None,
                 **kw) -> Cost:
    """Each 32-byte sector a live row lies in (``sectors``), read and
    written in the table and both moments; the 8-byte id of each slot
    walked (every slot without ``span``; with one, the live slots: the
    span of every caller holds just the live run); each live slot's
    (``live``, default every slot) gradient: its row read in order (per
    slot), or with ``table_grad`` its row's sectors of the table gradient,
    the table's sectors read once more. By default every slot's row its
    own sectors, at most the table's."""
    rows, dim = (int(s) for s in table.shape)
    slots = int(ids.shape[0])
    live = slots if live is None else int(live)
    walked = slots if span is None else live
    if sectors is None:
        sectors = min(live * row_sectors(dim), -(-rows * dim * 4 // SECTOR))
    per_sector = 2 * (_itemsize(table) + 2 * _itemsize(mu)) * SECTOR // 4
    grad_bytes = (sectors * SECTOR * _itemsize(grads) // 4 if table_grad
                  else live * dim * 4)
    nbytes = sectors * per_sector + walked * 8 + grad_bytes
    return Cost(live * dim * ADAMW_OPS_PER_ELEMENT, nbytes)


#: Each registered op's name -> its cost function of the op's arguments.
COSTS: Dict[str, Callable[..., Cost]] = {
    "examination_nll": examination_nll,
    "session_nll": session_nll,
    "embedding_bag": embedding_bag,
    "fm_interaction": fm_interaction,
    "flash_attention": flash_attention,
    "dcn_cross": dcn_cross,
    "adamw": adamw,
    "sparse_adamw": sparse_adamw,
}
