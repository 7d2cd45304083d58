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
                              max_unique: Optional[int] = None):
    """Fixed-size dedupe of a row-id stream: the distinct ids in ascending
    order, padded to ``max_unique or ids.numel()`` slots with the
    out-of-range sentinel ``n_rows`` (``jnp.unique(size=..., fill_value=
    n_rows)``); with ``return_inverse``, also each id's slot.

    No host sync: sort, mark the first id of each run, ``pos = cumsum - 1``,
    and scatter each sorted id to its ``pos`` in a buffer filled with the
    sentinel (ids of one run write one value to one slot). Distinct ids past
    the buffer land in one spare slot that is cut off."""
    flat = ids.reshape(-1)
    size = max_unique or flat.shape[0]
    out = torch.full((size + 1,), n_rows, dtype=flat.dtype,
                     device=flat.device)
    if flat.shape[0] == 0:
        return (out[:size], torch.empty_like(flat)) if return_inverse \
            else out[:size]
    sorted_ids, order = torch.sort(flat, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    pos = torch.clamp(torch.cumsum(first, 0) - 1, max=size)
    out.scatter_(0, pos, sorted_ids)
    if not return_inverse:
        return out[:size]
    inverse = torch.empty_like(pos).scatter_(0, order, pos)
    return out[:size], inverse


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
                        pred: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, SparseTableState]:
    """Update only the touched rows of (table, mu, nu), in place; advances
    ``state.count`` in place. Sentinel slots change nothing. Returns the
    same table and state. CPU tensors take the plain form, CUDA tensors the
    ``sparse_adamw`` kernel; other devices raise. With ``pred`` (a bool 0-d
    tensor on the device: the non-finite guard's, a sweep's active replica)
    the count advances by it, and where it is False nothing is written."""
    table = table.detach()
    state.count.add_(1 if pred is None else pred)
    kwargs = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  pred=pred)
    args = (table, state.mu, state.nu, unique_ids, grads.float(), state.count)
    if table.device.type == "cpu":
        sparse_adamw_plain(*args, **kwargs)
    else:
        sparse_adamw_cuda(*args, **kwargs)
    return table, state


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
