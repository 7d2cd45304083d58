"""Sparse-row (lazy) AdamW for huge embedding tables, port of
``repro.optim.sparse``.

A paper-width step touches at most 655,360 of a table's 214,748,672 rows,
yet dense AdamW reads and writes every row's parameter and moments. Here
the optimizer updates only the batch's rows:

    rows = unique_rows_with_sentinel(ids, n_rows)     # distinct, padded
    g = d_table[rows] (clipped), or sparse_row_grads  # (U, d)
    sparse_adamw_update(table, state, rows, g, lr=...)

**Lazy-Adam semantics** (torch SparseAdam, as the JAX module): a row is
touched on a step iff it appears in that step's ids; touched rows update as
dense AdamW would (to float32 rounding: the two forms order their
arithmetic each their own way); untouched rows are left entirely alone (no
moment decay, no weight decay, no catch-up on the bias correction, which
uses the global step count).

Fixed-size dedupe pads the row buffer with the out-of-range **sentinel**
``n_rows``: the update skips those slots, so padding never aliases a real
row (clamping it to ``n_rows - 1`` would race with that row's own update,
the clamp-side twin of the old ``fill_value=0`` bug).

Unlike the JAX module, which is pure, the table, the moments and the step
count are updated in place, and the dedupe runs without a host sync (no
data-dependent shapes), so a sparse step can be captured in a CUDA graph.
:func:`sparse_adamw_update` runs the hand-written ``sparse_adamw`` kernel on
CUDA tensors and its plain version on CPU tensors.

The dedupe's live slots are one contiguous run (ascending ids, then the
sentinel; on a row-sharded mesh, whose rows outside this rank's block map
to the local sentinel, sentinels on both sides of it): the dedupe's own
span (one device) and :func:`live_span` (a mesh) find it on the device,
and the update walks only those slots. The update also takes the
table gradient itself (``table_grad=True``), read at the live rows, in
place of a per-slot gather of it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.sparse_adamw import (sparse_adamw_cuda,
                                              sparse_adamw_plain)


class SparseTableState(NamedTuple):
    count: torch.Tensor  # int32 0-d global step (for bias correction)
    mu: torch.Tensor     # (R, d) first moment
    nu: torch.Tensor     # (R, d) second moment


def init_sparse_table_state(table: torch.Tensor,
                            moment_dtype=torch.float32) -> SparseTableState:
    return SparseTableState(
        count=torch.zeros((), dtype=torch.int32, device=table.device),
        mu=torch.zeros_like(table, dtype=moment_dtype),
        nu=torch.zeros_like(table, dtype=moment_dtype))


def unique_rows_with_sentinel(ids: torch.Tensor, n_rows: int, *,
                              return_inverse: bool = False,
                              max_unique: Optional[int] = None,
                              return_span: bool = False):
    """Fixed-size dedupe of a row-id stream: the distinct ids in ascending
    order, padded to ``max_unique or ids.numel()`` slots with the
    out-of-range sentinel ``n_rows`` (``jnp.unique(size=..., fill_value=
    n_rows)``); with ``return_inverse``, also each id's slot; with
    ``return_span``, last, ``[0, count)`` as a (2,) int64 tensor on the
    device, ``count`` the number of distinct ids (for ids in ``[0,
    n_rows)``, the live run: a ``span`` of ``sparse_adamw_update``, with no
    search).

    No host sync: sort, mark the first id of each run, ``pos = cumsum - 1``,
    and scatter each sorted id to its ``pos`` in a buffer filled with the
    sentinel (ids of one run write one value to one slot). Distinct ids past
    the buffer land in one spare slot that is cut off. The marks start with
    a 0, so the running count begins at 0 and ends at ``count``: the span
    is a view of its two ends, no launch of its own."""
    flat = ids.reshape(-1)
    size = max_unique or flat.shape[0]
    out = torch.full((size + 1,), n_rows, dtype=flat.dtype,
                     device=flat.device)
    n = flat.shape[0]
    if n == 0:
        inverse = torch.empty_like(flat)
        span = torch.zeros(2, dtype=torch.int64, device=flat.device)
    else:
        sorted_ids, order = torch.sort(flat, stable=True)
        # first[1 + i]: sorted id i starts a run; first[0] = 0
        first = torch.ones(n + 1, dtype=torch.bool, device=flat.device)
        first[:1].fill_(False)  # a launch, not a host copy: capturable
        torch.ne(sorted_ids[1:], sorted_ids[:-1], out=first[2:])
        runs = torch.cumsum(first, 0)
        pos = torch.clamp(runs[1:] - 1, max=size)
        out.scatter_(0, pos, sorted_ids)
        span = runs[::n]  # runs[0] = 0 and runs[n] = count
        if return_inverse:
            inverse = torch.empty_like(pos).scatter_(0, order, pos)
    got = (out[:size],) + ((inverse,) if return_inverse else ()) + (
        (span,) if return_span else ())
    return got if len(got) > 1 else got[0]


def live_span(unique_ids: torch.Tensor, bounds: torch.Tensor
              ) -> torch.Tensor:
    """``[start, end)`` of the slots of ``unique_ids`` (ascending, as
    :func:`unique_rows_with_sentinel` makes them) whose ids lie in
    ``[bounds[0], bounds[1])``, a (2,) int64 tensor on their device: one
    search there, no host sync. ``bounds`` (a (2,) int64 tensor on the
    same device) is ``[lo, lo + rows]`` for this rank's block of a
    row-sharded table (``[0, n_rows]`` for a whole one, whose span the
    dedupe's ``return_span`` gives with no search)."""
    return torch.searchsorted(unique_ids, bounds)


def sparse_row_grads(row_grads: torch.Tensor, ids: torch.Tensor, n_rows: int,
                     max_unique: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum (N, d) per-lookup grads into (U, d) per-distinct-row grads.

    Returns (unique_ids (U,), grads (U, d)); surplus slots hold the sentinel
    ``n_rows`` and a zero gradient."""
    flat_ids = ids.reshape(-1)
    g = row_grads.reshape(flat_ids.shape[0], -1)
    unique_ids, inverse = unique_rows_with_sentinel(
        flat_ids, n_rows, return_inverse=True, max_unique=max_unique)
    size = unique_ids.shape[0]
    # one spare row takes the lookups of ids cut off past `size`
    grads = torch.zeros((size + 1, g.shape[1]), dtype=g.dtype,
                        device=g.device)
    grads.index_add_(0, inverse, g)
    return unique_ids, grads[:size]


def sparse_adamw_update(table: torch.Tensor, state: SparseTableState,
                        unique_ids: torch.Tensor, grads: torch.Tensor, *,
                        lr: float, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, weight_decay: float = 0.0,
                        pred: Optional[torch.Tensor] = None,
                        norm: bool = False,
                        apply: Optional[torch.Tensor] = None,
                        span: Optional[torch.Tensor] = None,
                        table_grad: bool = False):
    """Update only the touched rows of (table, mu, nu), in place; advances
    ``state.count`` in place. Sentinel slots change nothing. Returns the
    same table and state. CPU tensors take the plain form, CUDA tensors the
    ``sparse_adamw`` kernel; other devices raise. With ``pred`` (a bool 0-d
    tensor on the device: the non-finite guard's, a sweep's active replica)
    the count advances by it, and where it is False nothing is written.

    ``grads`` are ``(slots, d)``, one row a slot; with ``table_grad=True``
    the ``(n_rows, d)`` table gradient, read at each live slot's row.
    ``span`` (None: every slot) gives the slots walked, a (2,) int64
    ``[start, end)`` on the device (the dedupe's ``return_span``, or
    :func:`live_span`), under the precondition that the live slots of
    ``unique_ids`` are one contiguous run inside it.

    ``norm=True`` (the engine's telemetry, ``repro_torch.optim.step``'s
    sparse twin) also returns the float64 0-d sum of squares of the table
    the step *would* write under ``apply`` alone: the table's sum of
    squares before the step plus the kernel's (or the plain form's) sum of
    ``p'^2 - p^2`` over the touched elements. The step is written under
    ``pred & apply``; the would-be step reads the count plus ``apply``."""
    table = table.detach()
    if apply is not None:
        if not norm:
            raise ValueError("sparse_adamw_update: apply is the would-be "
                             "step's predicate, for norm=True only")
        pred = apply if pred is None else pred & apply
    before = count = None
    if norm:
        before = torch.linalg.vector_norm(table).double() ** 2
        count = state.count + (1 if apply is None else apply)
    state.count.add_(1 if pred is None else pred)
    kwargs = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  pred=pred, norm=norm, apply=apply, span=span,
                  table_grad=table_grad)
    args = (table, state.mu, state.nu, unique_ids, grads.float(),
            state.count if count is None else count)
    if table.device.type == "cpu":
        delta = sparse_adamw_plain(*args, **kwargs)
    else:
        delta = sparse_adamw_cuda(*args, **kwargs)
    return (table, state, before + delta) if norm else (table, state)


def make_sparse_embedding_train_step(forward_from_rows, gather_rows, *,
                                     lr: float, n_rows: int,
                                     weight_decay: float = 0.0,
                                     dense_optimizer=None):
    """Build a train step that is sparse in the table and dense elsewhere.

    * ``gather_rows(table, batch) -> (rows, ids)``: the forward gather,
      returning the gathered row values and their ids.
    * ``forward_from_rows(dense_params, rows, batch) -> loss``: the rest of
      the model, treating the gathered rows as an input.
    * ``dense_optimizer``: a ``repro_torch.optim`` transformation for the
      dense params (a list of tensors that require grad), run through
      ``optim.step``.

    The table is differentiated only through its gathered rows, so no
    (n_rows, d) gradient is made. ``step`` updates the table, the dense
    params and both states in place and returns them with the detached
    loss."""
    from repro_torch import optim as optim_lib

    def init(table, dense_params):
        dense_opt = (dense_optimizer.init(list(dense_params))
                     if dense_optimizer else None)
        return init_sparse_table_state(table), dense_opt

    def step(table, sparse_state, dense_params, dense_opt, batch):
        dense_params = list(dense_params)
        with torch.no_grad():
            rows, ids = gather_rows(table, batch)
        rows = rows.detach().requires_grad_(True)
        loss = forward_from_rows(dense_params, rows, batch)
        d_rows, *d_dense = torch.autograd.grad(
            loss, [rows] + dense_params, allow_unused=True)
        uids, ugrads = sparse_row_grads(d_rows, ids, n_rows)
        table, sparse_state = sparse_adamw_update(
            table, sparse_state, uids, ugrads, lr=lr,
            weight_decay=weight_decay)
        if dense_optimizer is not None:
            d_dense = [torch.zeros_like(p) if g is None else g
                       for p, g in zip(dense_params, d_dense)]
            dense_opt = optim_lib.step(dense_optimizer, d_dense, dense_opt,
                                       dense_params)
        return table, sparse_state, dense_params, dense_opt, loss.detach()

    return init, step
