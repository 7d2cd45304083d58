"""Per-column storage codecs for the session store (format v2).

Copied from ``repro.data.codecs`` (numpy only).

Click logs are dominated by columns that barely carry entropy: ``clicks``
and ``mask`` are almost entirely zeros/ones, ``positions`` is the same
``1..K`` row repeated for every session, and id columns are small integers
rattling around in int64 slots. Storing them raw wastes bytes *and* read
bandwidth — at billion-session scale the store's byte volume is the data
plane's binding constraint. This module gives every column file an explicit
codec:

=========  =============================================================
``raw``    the v1 format: the array's contiguous bytes, ``np.memmap``-able
           (zero-copy reads; the only codec v1 stores know)
``bitpack``  1 bit per element via ``np.packbits`` — exact for any column
           whose values are all 0 or 1 (bool masks, float 0.0/1.0 click
           indicators): 8x for bool, 32x for float32
``zlib``   DEFLATE over the raw bytes (zstd-style byte-stream compression
           with a stdlib-only dependency) — wins on repetitive or
           small-integer columns, skipped when it doesn't pay
=========  =============================================================

Codec choice is **deterministic in the column bytes alone**
(:func:`encode_auto`): bitpack if every value is 0/1, else zlib if it
shrinks the column below :data:`ZLIB_ACCEPT` of raw, else raw. Two writers
handed the same shard rows therefore emit byte-identical column files —
the property the parallel-ingest byte-identity pin rests on.

Checksums and truncation checks operate on the *stored* (encoded) bytes,
so the store's fail-closed corruption paths (crc32 verify, quarantine)
work unchanged on compressed columns; :func:`decode` additionally wraps
any decoder error in ``ValueError`` so a corrupt stream that defeats a
size check still fails closed instead of returning garbage-shaped data.
"""
from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

CODECS = ("raw", "bitpack", "zlib")
#: DEFLATE level used at write time (decode is level-independent). Level 1
#: keeps ingest compute-light; the columns zlib wins on (constant or
#: small-integer patterns) compress nearly as well as at level 9.
ZLIB_LEVEL = 1
#: zlib is only chosen when it shrinks a column below this fraction of raw
#: — a marginal win is not worth losing the zero-copy memmap read path.
ZLIB_ACCEPT = 0.9


def raw_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


def is_binary(arr: np.ndarray) -> bool:
    """True when every element is exactly 0 or 1 (any dtype), i.e. the
    column round-trips exactly through 1-bit packing."""
    if arr.dtype == np.bool_:
        return True
    if arr.dtype.kind not in "iuf":
        return False
    return bool(((arr == 0) | (arr == 1)).all())


def encode(codec: str, arr: np.ndarray) -> bytes:
    """Encode one column of one shard into its stored byte stream."""
    if codec == "raw":
        return raw_bytes(arr)
    if codec == "bitpack":
        if not is_binary(arr):
            raise ValueError(
                "bitpack requires every value to be 0 or 1 — refusing a "
                "lossy encode (use codec='auto' to pick per shard)")
        flat = np.ascontiguousarray(arr).reshape(-1)
        return np.packbits(flat != 0).tobytes()
    if codec == "zlib":
        return zlib.compress(raw_bytes(arr), ZLIB_LEVEL)
    raise ValueError(f"unknown codec {codec!r}; known: {CODECS}")


def decode(codec: str, data: bytes, dtype, shape: Tuple[int, ...]
           ) -> np.ndarray:
    """Decode a stored byte stream back into the column array.

    Any decoder failure (corrupt DEFLATE stream, wrong element count) is
    raised as ``ValueError`` so callers can map it onto
    ``ShardCorruptionError`` uniformly.
    """
    dtype = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64))
    if codec == "raw":
        arr = np.frombuffer(data, dtype=dtype)
        if arr.size != n:
            raise ValueError(f"raw column holds {arr.size} elements, "
                             f"expected {n}")
        return arr.reshape(shape)
    if codec == "bitpack":
        want_bytes = (n + 7) // 8
        if len(data) != want_bytes:
            raise ValueError(f"bitpack column is {len(data)} bytes, "
                             f"expected {want_bytes} for {n} elements")
        bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8), count=n)
        return bits.astype(dtype).reshape(shape)
    if codec == "zlib":
        try:
            raw = zlib.decompress(data)
        except zlib.error as e:
            raise ValueError(f"zlib stream corrupt: {e}") from e
        arr = np.frombuffer(raw, dtype=dtype)
        if arr.size != n:
            raise ValueError(f"zlib column decodes to {arr.size} elements, "
                             f"expected {n}")
        return arr.reshape(shape)
    raise ValueError(f"unknown codec {codec!r}; known: {CODECS}")


def encode_auto(arr: np.ndarray) -> Tuple[str, bytes]:
    """Pick the best codec for this shard's column and encode in one pass.

    Deterministic in the column values: bitpack when exact, else zlib when
    it clears :data:`ZLIB_ACCEPT`, else raw. Returns ``(codec, stored)``
    so the trial compression is never repeated.
    """
    if is_binary(arr):
        return "bitpack", encode("bitpack", arr)
    raw = raw_bytes(arr)
    z = zlib.compress(raw, ZLIB_LEVEL)
    if len(z) <= ZLIB_ACCEPT * len(raw):
        return "zlib", z
    return "raw", raw
