"""Out-of-core session store: sharded, columnar, memory-mapped click logs.

Copied from ``repro.data.store`` (numpy only).

The scale-defining input of a click-model system is the log itself (CLAX
trains on the billion-session Baidu-ULTR log); a log that must fit in host
RAM as one numpy dict caps every downstream component. This module gives the
log a durable on-disk representation:

    <dir>/manifest.json            schema + shard table (atomic, written last)
    <dir>/shard_00000/<col>.bin    one raw binary file per column per shard
    <dir>/shard_00001/<col>.bin    ...

Design points:

- **Columnar, fixed schema.** Every column has one dtype and per-row shape
  across the whole store (recorded in the manifest), so a shard file is
  exactly ``rows * prod(shape) * itemsize`` bytes and can be mapped with
  ``np.memmap`` — zero-copy reads, no deserialization, OS page cache does
  the caching.
- **Sharded.** Fixed ``shard_rows`` per shard (last shard partial). Shards
  are the unit of shuffling, host placement, and read-ahead for
  :class:`repro_torch.data.streaming.StreamingClickLogLoader`; peak reader memory
  is O(shard) — or O(window) with windowed reads — never O(log).
- **Self-describing + verifiable.** The manifest carries dtypes (numpy
  ``dtype.str``, endianness included), per-row shapes, per-shard row counts,
  a crc32 per column file, and free-form user metadata (e.g. the
  ``SyntheticConfig`` that generated the log).
- **Crash-safe.** The manifest is written last via ``os.replace``; a
  directory without a committed manifest is not a store, so a crashed ingest
  can never be half-read.
- **Per-column compression (format v2).** Each shard entry records a codec
  per column (see :mod:`repro_torch.data.codecs`); ``codec="auto"`` at write time
  picks ``bitpack`` for 0/1 columns (clicks, mask), ``zlib`` where DEFLATE
  pays, and ``raw`` otherwise. Checksums and size checks cover the *stored*
  bytes, so corruption fails closed on compressed columns exactly as on raw
  ones. ``raw`` columns keep the zero-copy ``np.memmap`` read path, and v1
  manifests (no codec field) read as all-``raw`` — byte-compatible.

``ingest_synthetic`` streams a :class:`repro_torch.data.synthetic.SyntheticConfig`
log through :func:`repro_torch.data.synthetic.iter_click_log_chunks` straight into
writers — optionally split into train/val/test stores — so logs far larger
than RAM are synthesized with peak memory O(chunk + shard). For multi-process
ingest over the same deterministic chunk stream see
:mod:`repro_torch.data.ingest`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data import codecs as _codecs

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 2
#: Manifest versions this reader accepts. v1 lacks per-column codec fields
#: (every column is implicitly ``raw``); v2 shard entries add ``codecs`` and
#: ``nbytes`` maps. v1 stores written by older builds stay readable forever.
READABLE_FORMAT_VERSIONS = (1, 2)
#: Writer-side codec modes: ``"raw"`` pins every column to raw bytes (v1
#: byte-compatible, memmap reads); ``"auto"`` picks per column per shard.
WRITER_CODECS = ("raw", "auto")


class ShardCorruptionError(ValueError):
    """A shard's bytes disagree with the manifest (bad crc32, or a column
    file whose size doesn't match the recorded row count). Distinct from
    transient ``OSError`` IO failures: corruption is deterministic, so
    callers retry the latter but quarantine (or raise) on the former."""


def _shard_dirname(index: int) -> str:
    return f"shard_{index:05d}"


def _crc32(arr: np.ndarray) -> str:
    return f"{zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1)):08x}"


def _crc32_bytes(data: bytes) -> str:
    return f"{zlib.crc32(data):08x}"


def _write_shard_dir(directory: str, name: str, shard: Mapping[str, np.ndarray],
                     rows: int, codec: str) -> Dict:
    """Encode and write one shard's column files; return its manifest entry.

    The single place shard bytes are produced — shared by
    :class:`SessionStoreWriter` and the parallel-ingest workers
    (:mod:`repro_torch.data.ingest`), so both paths emit byte-identical files and
    entries for the same rows. ``codec`` is a writer mode from
    :data:`WRITER_CODECS`; the per-column choice under ``"auto"`` is
    deterministic in the column values (see ``codecs.encode_auto``).
    """
    os.makedirs(directory, exist_ok=True)
    checksums, col_codecs, nbytes = {}, {}, {}
    for cname, arr in shard.items():
        arr = np.ascontiguousarray(arr)
        path = os.path.join(directory, f"{cname}.bin")
        chosen, stored = ("raw", None) if codec == "raw" \
            else _codecs.encode_auto(arr)
        if chosen == "raw":
            # tofile streams the buffer — no bytes copy; crc over the array
            # view IS the crc over the stored bytes for the raw codec.
            arr.tofile(path)
            checksums[cname] = _crc32(arr)
            nbytes[cname] = int(arr.nbytes)
        else:
            with open(path, "wb") as f:
                f.write(stored)
            checksums[cname] = _crc32_bytes(stored)
            nbytes[cname] = len(stored)
        col_codecs[cname] = chosen
    return {"name": name, "rows": int(rows), "checksums": checksums,
            "codecs": col_codecs, "nbytes": nbytes}


def _take_rows(parts: List[Dict[str, np.ndarray]], n: int
               ) -> Dict[str, np.ndarray]:
    """Pop the first ``n`` rows from a list of same-schema row blocks.

    Shared buffering primitive of ``SessionStoreWriter`` (chunks in, shards
    out) and ``StreamingClickLogLoader`` (windows in, batches out).
    """
    taken: Dict[str, list] = {}
    got = 0
    while got < n:
        part = parts[0]
        rows = next(iter(part.values())).shape[0]
        need = n - got
        if rows <= need:
            parts.pop(0)
            piece = part
            got += rows
        else:
            piece = {k: v[:need] for k, v in part.items()}
            parts[0] = {k: v[need:] for k, v in part.items()}
            got = n
        for k, v in piece.items():
            taken.setdefault(k, []).append(v)
    return {k: (v[0] if len(v) == 1 else np.concatenate(v, axis=0))
            for k, v in taken.items()}


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """Schema of one column: numpy dtype string + per-row (trailing) shape."""
    dtype: str           # np.dtype.str, e.g. "<f4", "|b1"
    shape: Tuple[int, ...]  # per-row shape; () for scalar columns

    def to_json(self):
        return {"dtype": self.dtype, "shape": list(self.shape)}

    @classmethod
    def from_json(cls, d):
        return cls(dtype=d["dtype"], shape=tuple(int(s) for s in d["shape"]))

    @classmethod
    def of(cls, arr: np.ndarray) -> "ColumnSpec":
        return cls(dtype=np.dtype(arr.dtype).str, shape=tuple(arr.shape[1:]))

    @property
    def row_nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * int(np.prod(self.shape, dtype=np.int64)))


class SessionStoreWriter:
    """Append-only writer emitting fixed-size columnar shards.

    Usage::

        with SessionStoreWriter(path, shard_rows=1_000_000) as w:
            for chunk in chunks:          # dict of (rows, ...) arrays
                w.append(chunk)
        store = SessionStore(path)

    The schema (column set, dtypes, per-row shapes) is fixed by the first
    ``append``; later chunks must match it exactly. Buffered rows are flushed
    as full shards of ``shard_rows``; ``close()`` flushes the remainder as a
    final partial shard and commits the manifest atomically. Peak writer
    memory is O(shard_rows + largest chunk).
    """

    def __init__(self, directory: str, shard_rows: int = 1_000_000,
                 columns: Optional[Sequence[str]] = None,
                 metadata: Optional[Mapping] = None, codec: str = "raw"):
        if shard_rows < 1:
            raise ValueError(f"shard_rows must be >= 1, got {shard_rows}")
        if codec not in WRITER_CODECS:
            raise ValueError(f"codec must be one of {WRITER_CODECS}, "
                             f"got {codec!r}")
        self.directory = directory
        self.shard_rows = int(shard_rows)
        self.codec = codec
        self._columns = tuple(columns) if columns is not None else None
        self.metadata = dict(metadata or {})
        self._specs: Optional[Dict[str, ColumnSpec]] = None
        self._buffer: List[Dict[str, np.ndarray]] = []
        self._buffered_rows = 0
        self._shards: List[Dict] = []
        self._closed = False
        os.makedirs(directory, exist_ok=True)
        # Re-ingesting over a committed store: drop the old manifest first so
        # a crash mid-write can't leave it pointing at half-overwritten shard
        # files ("no manifest = not a store" must hold during the rewrite).
        stale = os.path.join(directory, MANIFEST_NAME)
        if os.path.exists(stale):
            os.remove(stale)

    # -- schema ----------------------------------------------------------------
    def _fix_schema(self, chunk: Mapping[str, np.ndarray]):
        keys = self._columns or tuple(sorted(chunk))
        missing = [k for k in keys if k not in chunk]
        if missing:
            raise KeyError(f"chunk missing columns {missing}")
        self._specs = {k: ColumnSpec.of(np.asarray(chunk[k])) for k in keys}
        self._buffer = []

    def _check_chunk(self, chunk: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self._columns is None:
            extra = set(chunk) - set(self._specs)
            if extra:
                raise KeyError(
                    f"chunk carries columns {sorted(extra)} absent from the "
                    "schema fixed by the first append — they would be "
                    "silently dropped")
        out, rows = {}, None
        for name, spec in self._specs.items():
            if name not in chunk:
                raise KeyError(f"chunk missing column {name!r}")
            arr = np.asarray(chunk[name])
            if np.dtype(arr.dtype).str != spec.dtype or arr.shape[1:] != spec.shape:
                raise ValueError(
                    f"column {name!r}: got dtype={np.dtype(arr.dtype).str} "
                    f"shape={arr.shape[1:]}, store schema is dtype={spec.dtype} "
                    f"shape={spec.shape}")
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ValueError(f"ragged chunk: column {name!r} has "
                                 f"{arr.shape[0]} rows, expected {rows}")
            out[name] = arr
        return out

    # -- writing ---------------------------------------------------------------
    def append(self, chunk: Mapping[str, np.ndarray]) -> None:
        if self._closed:
            raise RuntimeError("writer is closed")
        if self._specs is None:
            self._fix_schema(chunk)
        chunk = self._check_chunk(chunk)
        rows = next(iter(chunk.values())).shape[0] if chunk else 0
        if rows == 0:
            return
        self._buffer.append(chunk)
        self._buffered_rows += rows
        while self._buffered_rows >= self.shard_rows:
            self._flush_shard(self.shard_rows)

    def _flush_shard(self, rows: int) -> None:
        shard = _take_rows(self._buffer, rows)
        self._buffered_rows -= rows
        index = len(self._shards)
        sdir = os.path.join(self.directory, _shard_dirname(index))
        self._shards.append(_write_shard_dir(sdir, _shard_dirname(index),
                                             shard, rows, self.codec))

    # -- commit ----------------------------------------------------------------
    def close(self) -> Dict:
        """Flush the final partial shard and atomically commit the manifest."""
        if self._closed:
            return self._manifest
        if self._specs is None:
            raise RuntimeError("nothing was appended; refusing to write an "
                               "empty store")
        if self._buffered_rows > 0:
            self._flush_shard(self._buffered_rows)
        manifest = {
            "format_version": FORMAT_VERSION,
            "columns": {k: s.to_json() for k, s in self._specs.items()},
            "shards": self._shards,
            "rows": int(sum(s["rows"] for s in self._shards)),
            "shard_rows": self.shard_rows,
            "metadata": self.metadata,
        }
        tmp = os.path.join(self.directory, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(self.directory, MANIFEST_NAME))
        self._manifest = manifest
        self._closed = True
        return manifest

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        # on error: leave no manifest — the directory is not a valid store
        return False


class SessionStore:
    """Read side: manifest + zero-copy ``np.memmap`` access to shard columns."""

    def __init__(self, directory: str, verify: bool = False):
        self.directory = directory
        path = os.path.join(directory, MANIFEST_NAME)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{directory!r} has no {MANIFEST_NAME} — not a committed "
                "session store (crashed ingest, or wrong path?)")
        with open(path) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format_version") not in READABLE_FORMAT_VERSIONS:
            raise ValueError(
                f"store format_version={self.manifest.get('format_version')} "
                f"not supported (reader accepts {READABLE_FORMAT_VERSIONS})")
        self.columns: Dict[str, ColumnSpec] = {
            k: ColumnSpec.from_json(v)
            for k, v in self.manifest["columns"].items()}
        self.shards: List[Dict] = self.manifest["shards"]
        self.rows: int = int(self.manifest["rows"])
        self.metadata: Dict = self.manifest.get("metadata", {})
        if verify:
            self.verify()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_rows(self, index: int) -> int:
        return int(self.shards[index]["rows"])

    def _shard_path(self, index: int, column: str) -> str:
        return os.path.join(self.directory, self.shards[index]["name"],
                            f"{column}.bin")

    def shard_codec(self, index: int, column: str) -> str:
        """Codec of one column file. v1 manifests carry no codec field —
        every column is ``raw`` by definition."""
        return self.shards[index].get("codecs", {}).get(column, "raw")

    def shard_stored_nbytes(self, index: int, column: str) -> int:
        """Bytes of one column file as stored on disk (encoded size)."""
        nb = self.shards[index].get("nbytes", {}).get(column)
        if nb is not None:
            return int(nb)
        return int(self.shards[index]["rows"]) * self.columns[column].row_nbytes

    def stored_nbytes(self, columns: Optional[Iterable[str]] = None) -> int:
        """Total on-disk bytes of the store's column files (manifest
        arithmetic, no IO) — the number compression shrinks."""
        names = tuple(columns if columns is not None else self.columns)
        return sum(self.shard_stored_nbytes(i, n)
                   for i in range(self.n_shards) for n in names)

    def _check_stored_size(self, index: int, column: str) -> str:
        path = self._shard_path(index, column)
        want = self.shard_stored_nbytes(index, column)
        got = os.path.getsize(path)
        if got != want:
            raise ShardCorruptionError(
                f"{path} is {got} bytes, manifest implies {want} stored "
                f"({self.shard_rows(index)} rows, "
                f"codec={self.shard_codec(index, column)}) — truncated or "
                "mismatched shard file")
        return path

    def open_shard(self, index: int,
                   columns: Optional[Iterable[str]] = None
                   ) -> Dict[str, np.ndarray]:
        """Open one shard: dict of read-only column arrays. ``raw`` columns
        are zero-copy ``np.memmap``; compressed columns are decoded into
        RAM (any decode failure raises :class:`ShardCorruptionError` — a
        corrupt stream that happens to keep its stored size still fails
        closed)."""
        rows = self.shard_rows(index)
        out = {}
        for name in (columns if columns is not None else self.columns):
            spec = self.columns[name]
            codec = self.shard_codec(index, name)
            path = self._check_stored_size(index, name)
            if codec == "raw":
                out[name] = np.memmap(path, dtype=np.dtype(spec.dtype),
                                      mode="r", shape=(rows,) + spec.shape)
                continue
            with open(path, "rb") as f:
                data = f.read()
            try:
                arr = _codecs.decode(codec, data, np.dtype(spec.dtype),
                                     (rows,) + spec.shape)
            except ValueError as e:
                raise ShardCorruptionError(
                    f"{path}: {codec} decode failed ({e}) — corrupt or "
                    "mismatched shard file") from e
            arr.flags.writeable = False  # match the memmap's read-only view
            out[name] = arr
        return out

    def verify(self, index: Optional[int] = None,
               columns: Optional[Iterable[str]] = None) -> None:
        """Check crc32 of every column file (or one shard's, or a subset of
        columns) over the *stored* bytes — no decode needed, so a corrupt
        compressed stream is caught before any decoder sees it. Raises
        :class:`ShardCorruptionError` on drift."""
        indices = range(self.n_shards) if index is None else [index]
        for i in indices:
            names = tuple(columns if columns is not None else self.columns)
            for name in names:
                path = self._check_stored_size(i, name)
                with open(path, "rb") as f:
                    got = _crc32_bytes(f.read())
                want = self.shards[i]["checksums"][name]
                if got != want:
                    raise ShardCorruptionError(
                        f"checksum mismatch in {path}: "
                        f"manifest={want} file={got}")

    def read_all(self, columns: Optional[Iterable[str]] = None
                 ) -> Dict[str, np.ndarray]:
        """Materialize the whole store in RAM (tests / small stores only)."""
        names = tuple(columns if columns is not None else self.columns)
        parts = {k: [] for k in names}
        for i in range(self.n_shards):
            shard = self.open_shard(i, columns=names)
            for k in names:
                parts[k].append(np.asarray(shard[k]))
        return {k: np.concatenate(v, axis=0) for k, v in parts.items()}


def write_session_store(data: Mapping[str, np.ndarray], directory: str,
                        shard_rows: int = 1_000_000,
                        metadata: Optional[Mapping] = None,
                        codec: str = "raw") -> SessionStore:
    """One-shot convenience: write an in-memory session dict as a store.

    Defaults to ``codec="raw"`` — every column file is the array's bytes
    (v1-identical, memmap reads); pass ``codec="auto"`` for per-column
    compression."""
    with SessionStoreWriter(directory, shard_rows=shard_rows,
                            metadata=metadata, codec=codec) as w:
        w.append(data)
    return SessionStore(directory)


def split_sizes(n: int, splits: Mapping[str, float]) -> List[int]:
    """Rows of an ``n``-row chunk routed to each split, in ``splits`` order:
    ``round(n * fraction)`` for all but the last split, which takes the
    exact remainder. Shared by the single-process and parallel ingest paths
    so their routing arithmetic can never drift."""
    names = list(splits)
    sizes = [int(round(n * splits[k])) for k in names[:-1]]
    sizes.append(n - sum(sizes))
    if min(sizes) < 0:
        raise ValueError(f"split fractions {dict(splits)} overflow a "
                         f"chunk of {n} rows")
    return sizes


def split_permutation(seed: int, chunk_index: int, n: int) -> np.ndarray:
    """The deterministic permutation routing chunk ``chunk_index``'s rows
    into splits (domain-separated from the chunk-synthesis streams)."""
    return np.random.default_rng((seed, 7, chunk_index)).permutation(n)


def ingest_synthetic(cfg, directory: str, chunk_sessions: int = 100_000,
                     shard_rows: int = 1_000_000,
                     splits: Optional[Mapping[str, float]] = None,
                     codec: str = "auto",
                     extra_metadata: Optional[Mapping] = None,
                     ) -> Dict[str, SessionStore]:
    """Stream a synthetic log into session store(s) with bounded memory.

    ``splits`` (e.g. ``{"train": .8, "val": .1, "test": .1}``) routes each
    chunk's rows into per-split writers under ``directory/<split>`` using a
    deterministic per-chunk permutation (last split takes the exact
    remainder), so arbitrarily large logs are split without ever being
    held. With ``splits=None`` the whole log lands in one store at
    ``directory``. Peak memory is O(chunk_sessions + shard_rows) rows,
    independent of ``cfg.n_sessions``.

    ``codec="auto"`` (default) picks a per-column codec per shard; pass
    ``"raw"`` for v1-byte-compatible stores. This single-process path is the
    reference implementation: :func:`repro_torch.data.ingest.ingest_synthetic`
    fans the same chunk stream across worker processes and is pinned
    byte-identical to it.
    """
    from repro_torch.data.synthetic import iter_click_log_chunks

    meta = {"synthetic_config": dataclasses.asdict(cfg),
            "chunk_sessions": int(chunk_sessions),
            "store_codec": codec}
    meta.update(extra_metadata or {})
    if splits is None:
        writers = {"": SessionStoreWriter(directory, shard_rows=shard_rows,
                                          metadata=meta, codec=codec)}
    else:
        writers = {name: SessionStoreWriter(os.path.join(directory, name),
                                            shard_rows=shard_rows,
                                            metadata=dict(meta, split=name,
                                                          fraction=frac),
                                            codec=codec)
                   for name, frac in splits.items()}

    for c, chunk in enumerate(iter_click_log_chunks(cfg, chunk_sessions)):
        if splits is None:
            writers[""].append(chunk)
            continue
        n = chunk["clicks"].shape[0]
        perm = split_permutation(cfg.seed, c, n)
        sizes = split_sizes(n, splits)
        start = 0
        for name, size in zip(splits, sizes):
            idx = perm[start:start + size]
            start += size
            if size:
                writers[name].append({k: v[idx] for k, v in chunk.items()})

    # Validate every split BEFORE committing any manifest, so a bad split
    # spec can't leave a half-committed train/val/test tree behind.
    empty = [name for name, w in writers.items() if w._specs is None]
    if empty:
        raise ValueError(
            f"splits {empty} received zero rows — fractions too small for "
            f"chunk_sessions={chunk_sessions}; use larger chunks")
    out = {}
    for name, w in writers.items():
        w.close()
        out[name] = SessionStore(w.directory)
    return out
