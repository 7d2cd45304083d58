"""Fail-closed per-request validation.

Copied from ``repro.serve.validation`` (numpy only).

One poisoned request must never poison a batch (NaN features would turn
the whole padded batch's predictions into garbage for every batch-mate)
and must never raise through the server loop. So validation is a *total*
function: it returns a rejection reason string or ``None``, catches every
exception class internally, and runs at admission — before a request can
reach the queue, the batcher, or a compiled program.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.serve.request import ServeRequest

# Stable reason strings (counters/tests key on them).
R_UNKNOWN_MODEL = "unknown_model"
R_BAD_SHAPE = "bad_shape"
R_BAD_DTYPE = "bad_dtype"
R_NONFINITE = "nonfinite_values"
R_IDS_RANGE = "ids_out_of_range"
R_POSITIONS_RANGE = "positions_out_of_range"
R_BAD_DEADLINE = "bad_deadline"
R_INTERNAL = "validator_error"


def _as_int_array(arr, shape):
    """Cast to int32 after proving the cast is lossless; returns (a, reason)."""
    a = np.asarray(arr)
    if a.shape != shape:
        return None, R_BAD_SHAPE
    if np.issubdtype(a.dtype, np.floating):
        if not np.isfinite(a).all():
            return None, R_NONFINITE
        if not np.equal(np.mod(a, 1), 0).all():
            return None, R_BAD_DTYPE
        a = a.astype(np.int64)
    elif np.issubdtype(a.dtype, np.bool_):
        a = a.astype(np.int64)
    elif not np.issubdtype(a.dtype, np.integer):
        return None, R_BAD_DTYPE
    return a.astype(np.int64), None


def validate_request(req: ServeRequest, *, positions: int, n_pairs: int,
                     feature_dim: Optional[int] = None) -> Optional[str]:
    """Reason string if ``req`` must be rejected, ``None`` if servable.

    Checks, in order: array shapes are (K,), dtypes are losslessly
    integral where the model indexes tables, every float is finite,
    query-doc ids lie in [0, n_pairs), positions in [1, K], the mask is
    boolean-like, optional features are (K, F) finite, and the deadline is
    a positive finite budget. Any internal surprise (a string array, a
    ragged object array, ...) is caught and reported as
    ``validator_error:<ExceptionName>`` — never raised.
    """
    try:
        shape = (int(positions),)

        pos, reason = _as_int_array(req.positions, shape)
        if reason:
            return f"{reason}:positions"
        if pos.min(initial=1) < 1 or pos.max(initial=1) > positions:
            return R_POSITIONS_RANGE

        ids, reason = _as_int_array(req.query_doc_ids, shape)
        if reason:
            return f"{reason}:query_doc_ids"
        if ids.min(initial=0) < 0 or ids.max(initial=0) >= n_pairs:
            return R_IDS_RANGE

        mask = np.asarray(req.mask)
        if mask.shape != shape:
            return f"{R_BAD_SHAPE}:mask"
        if np.issubdtype(mask.dtype, np.floating) and \
                not np.isfinite(mask).all():
            return f"{R_NONFINITE}:mask"
        if not np.isin(np.asarray(mask, dtype=np.float64), (0.0, 1.0)).all():
            return f"{R_BAD_DTYPE}:mask"

        if req.features is not None:
            feats = np.asarray(req.features)
            if feats.ndim != 2 or feats.shape[0] != positions or (
                    feature_dim is not None and feats.shape[1] != feature_dim):
                return f"{R_BAD_SHAPE}:features"
            if not np.issubdtype(feats.dtype, np.floating) and \
                    not np.issubdtype(feats.dtype, np.integer):
                return f"{R_BAD_DTYPE}:features"
            if not np.isfinite(feats.astype(np.float64)).all():
                return f"{R_NONFINITE}:features"
        elif feature_dim is not None:
            return f"{R_BAD_SHAPE}:features"

        deadline = float(req.deadline_s)
        if not np.isfinite(deadline) or deadline <= 0:
            return R_BAD_DEADLINE
        return None
    except Exception as e:  # fail closed, never raise through the loop
        return f"{R_INTERNAL}:{type(e).__name__}"
