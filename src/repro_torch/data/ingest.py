"""Parallel ingest: fan deterministic chunk synthesis + shard writing

Copied from ``repro.data.ingest`` (numpy only).

across worker processes, byte-identical to the single-process path.

Single-process ingest tops out on chunk synthesis (numpy-bound), which
makes a billion-session store an hours-long serial job. The chunk stream,
however, is *randomly addressable*: chunk ``c`` is a pure function of
``(cfg, chunk_sessions, c)`` (:func:`repro_torch.data.synthetic.synthesize_chunk`)
and the split routing of its rows is a pure function of ``(seed, c)``
(:func:`repro_torch.data.store.split_permutation`). So the whole store layout —
which row of which chunk lands at which offset of which shard of which
split — is fixed by arithmetic before any data exists, and can be carved
into disjoint jobs:

1. **Plan** (pure arithmetic, no IO): per split, the row stream is
   ``sum(split_sizes(chunk))`` long and cuts into ``ceil(rows/shard_rows)``
   shards. Worker ``w`` of ``W`` owns the contiguous shard block
   ``[w*K//W, (w+1)*K//W)`` of every split — block boundaries sit on shard
   boundaries, so every worker-written shard is also a single-process shard.
2. **Workers** generate exactly the chunks overlapping their row ranges
   (each chunk once, routed to all of the worker's splits — the per-split
   ranges nearly coincide because split fractions are uniform across
   chunks), slice off the rows inside their range, and write their shard
   files with the same encoder as the serial writer
   (``store._write_shard_dir``), under the same atomic discipline: shard
   files first, manifest last.
3. **Merge** (single writer): the parent validates the returned shard
   groups — any overlap or gap is a hard error — and commits one manifest
   per split via the same atomic ``os.replace``. A crash anywhere before
   that leaves no manifest: not a store.

Because shard bytes are a deterministic function of the rows they hold and
the codec choice is deterministic in those rows, the parallel store is
**bit-identical** to ``store.ingest_synthetic``'s — shard files and
manifest alike (metadata records the actual ``ingest_workers``) — pinned
in tests/test_torch_store.py.

Workers are ``spawn`` processes, never forked: the parent may hold a CUDA
context and the prefetcher's threads. A worker unpickles its job from
``repro_torch.data``, whose package imports torch, so each worker pays
torch's import once (``chip_smoke.py``'s ``store`` phase prints the time a
spawned worker takes to import it).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.data.store import (FORMAT_VERSION, MANIFEST_NAME, ColumnSpec,
                              SessionStore, WRITER_CODECS, _shard_dirname,
                              _take_rows, _write_shard_dir, split_permutation,
                              split_sizes)
from repro_torch.data import store as _store
from repro_torch.data.synthetic import chunk_sizes, synthesize_chunk

# -- planning (pure arithmetic, shared by parent and workers) ------------------

def _split_names(splits: Optional[Mapping[str, float]]) -> List[str]:
    return list(splits) if splits is not None else [""]


def _split_cum_rows(chunk_rows: Sequence[int],
                    splits: Optional[Mapping[str, float]]
                    ) -> Dict[str, np.ndarray]:
    """Per split: cumulative row offsets ``cum[c]`` = first stream row of
    chunk ``c``'s contribution (``cum[-1]`` = the split's total rows)."""
    names = _split_names(splits)
    per_chunk = {name: np.zeros(len(chunk_rows) + 1, np.int64)
                 for name in names}
    for c, n in enumerate(chunk_rows):
        sizes = [n] if splits is None else split_sizes(n, splits)
        for name, s in zip(names, sizes):
            per_chunk[name][c + 1] = s
    return {name: np.cumsum(arr) for name, arr in per_chunk.items()}


def _shard_block(total_rows: int, shard_rows: int, worker: int,
                 workers: int) -> tuple:
    """Shard-index block ``[s_lo, s_hi)`` and row range ``[r_lo, r_hi)``
    worker ``worker`` owns for a split of ``total_rows`` rows."""
    n_shards = -(-total_rows // shard_rows) if total_rows else 0
    s_lo = (worker * n_shards) // workers
    s_hi = ((worker + 1) * n_shards) // workers
    return s_lo, s_hi, s_lo * shard_rows, min(s_hi * shard_rows, total_rows)


# -- worker side ---------------------------------------------------------------

class _ShardSliceWriter:
    """Writes one worker's contiguous shard block of one split.

    Same buffering (``_take_rows``) and encoding (``_write_shard_dir``) as
    ``SessionStoreWriter``, but shard numbering starts at ``first_shard``
    and no manifest is written — the parent merges entries from all
    workers and commits it once.
    """

    def __init__(self, directory: str, first_shard: int, shard_rows: int,
                 codec: str, row_lo: int, row_hi: int, cum: np.ndarray):
        self.directory = directory
        self.first_shard = first_shard
        self.shard_rows = shard_rows
        self.codec = codec
        self.row_lo, self.row_hi = row_lo, row_hi
        self.cum = cum  # chunk -> stream-row offset of this split
        self.entries: List[Dict] = []
        self.columns: Optional[Dict[str, Dict]] = None
        self._parts: List[Dict[str, np.ndarray]] = []
        self._buffered = 0

    def feed_chunk(self, c: int, chunk: Mapping[str, np.ndarray],
                   idx: np.ndarray) -> None:
        """Route chunk ``c``'s rows for this split (``idx``, in stream
        order) — keeping only the slice inside this worker's row range."""
        lo = int(self.cum[c])
        a = max(self.row_lo - lo, 0)
        b = min(self.row_hi - lo, len(idx))
        if b <= a:
            return
        sel = idx[a:b]
        # sorted key order matches SessionStoreWriter._fix_schema, so the
        # merged manifest's per-entry dicts serialize identically
        part = {k: np.asarray(chunk[k])[sel] for k in sorted(chunk)}
        if self.columns is None:
            self.columns = {k: ColumnSpec.of(v).to_json()
                            for k, v in part.items()}
        self._parts.append(part)
        self._buffered += len(sel)
        while self._buffered >= self.shard_rows:
            self._flush(self.shard_rows)

    def _flush(self, rows: int) -> None:
        shard = _take_rows(self._parts, rows)
        self._buffered -= rows
        index = self.first_shard + len(self.entries)
        sdir = os.path.join(self.directory, _shard_dirname(index))
        self.entries.append(_write_shard_dir(sdir, _shard_dirname(index),
                                             shard, rows, self.codec))

    def finish(self) -> Dict:
        if self._buffered:
            # Only the worker owning the stream's tail can hold a partial
            # shard — everyone else's range ends on a shard boundary.
            assert self.row_hi == int(self.cum[-1]), \
                (self.row_lo, self.row_hi, self._buffered)
            self._flush(self._buffered)
        return {"shards": self.entries, "columns": self.columns}


def _run_worker(worker: int, workers: int, chunk_fn: Callable,
                chunk_rows: Sequence[int], directory: str, shard_rows: int,
                splits: Optional[Mapping[str, float]], codec: str,
                seed: int) -> Dict[str, Dict]:
    """One worker's job: rebuild the plan (pure arithmetic — cheaper than
    shipping it), synthesize exactly the chunks its row ranges touch, and
    write its shard blocks for every split. Returns per-split shard
    entries + column specs for the parent's merge."""
    names = _split_names(splits)
    cum = _split_cum_rows(chunk_rows, splits)
    writers: Dict[str, _ShardSliceWriter] = {}
    for name in names:
        total = int(cum[name][-1])
        s_lo, s_hi, r_lo, r_hi = _shard_block(total, shard_rows, worker,
                                              workers)
        if s_hi > s_lo:
            writers[name] = _ShardSliceWriter(
                os.path.join(directory, name) if splits is not None
                else directory,
                s_lo, shard_rows, codec, r_lo, r_hi, cum[name])
    if not writers:
        return {}
    c_min = min(int(np.searchsorted(w.cum, w.row_lo, side="right")) - 1
                for w in writers.values())
    c_max = max(int(np.searchsorted(w.cum, w.row_hi, side="left"))
                for w in writers.values())
    for c in range(c_min, c_max):
        chunk = chunk_fn(c)
        n = next(iter(chunk.values())).shape[0]
        if n != chunk_rows[c]:
            raise ValueError(f"chunk {c} yielded {n} rows, plan says "
                             f"{chunk_rows[c]} — chunk_fn must be "
                             "deterministic in the chunk index")
        if splits is None:
            routed = {"": np.arange(n)}
        else:
            perm = split_permutation(seed, c, n)
            routed, start = {}, 0
            for name, size in zip(names, split_sizes(n, splits)):
                routed[name] = perm[start:start + size]
                start += size
        for name, w in writers.items():
            w.feed_chunk(c, chunk, routed[name])
    return {name: w.finish() for name, w in writers.items()}


# -- merge (single writer) -----------------------------------------------------

def merge_shard_groups(groups: Sequence[Sequence[Dict]]) -> List[Dict]:
    """Validate + order worker shard groups into one shard table.

    Each group is one worker's shard-entry list. Any shard index written by
    two groups (overlap) or by none (gap) is a hard error — a merged
    manifest must describe exactly the shards a single-process writer
    would have produced, or the store is silently wrong.
    """
    by_index: Dict[int, Dict] = {}
    for group in groups:
        for e in group:
            i = int(e["name"].rsplit("_", 1)[1])
            if i in by_index:
                raise ValueError(
                    f"overlapping shard groups: shard {i} written by two "
                    "workers — refusing to commit a manifest over "
                    "ambiguous bytes")
            by_index[i] = e
    if not by_index:
        raise ValueError("no shards to merge")
    missing = sorted(set(range(max(by_index) + 1)) - set(by_index))
    if missing:
        raise ValueError(f"shard groups leave gaps: shards {missing} "
                         "missing — refusing to commit a partial store")
    return [by_index[i] for i in range(len(by_index))]


def _commit_manifest(directory: str, columns: Dict, shards: List[Dict],
                     shard_rows: int, metadata: Mapping) -> None:
    # field-for-field the dict SessionStoreWriter.close() builds, committed
    # with the same atomic rename
    manifest = {
        "format_version": FORMAT_VERSION,
        "columns": columns,
        "shards": shards,
        "rows": int(sum(s["rows"] for s in shards)),
        "shard_rows": int(shard_rows),
        "metadata": dict(metadata),
    }
    tmp = os.path.join(directory, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(directory, MANIFEST_NAME))


# -- entrypoints ---------------------------------------------------------------

def ingest_chunks(chunk_fn: Callable[[int], Dict[str, np.ndarray]],
                  chunk_rows: Sequence[int], directory: str,
                  shard_rows: int = 1_000_000,
                  splits: Optional[Mapping[str, float]] = None,
                  codec: str = "auto", workers: int = 1, seed: int = 0,
                  metadata: Optional[Mapping] = None
                  ) -> Dict[str, SessionStore]:
    """Ingest any randomly-addressable chunk stream across ``workers``
    processes.

    ``chunk_fn(c)`` must return chunk ``c`` as a column dict of
    ``chunk_rows[c]`` rows, deterministically, and be picklable (a
    module-level function or ``functools.partial`` over one — workers are
    spawned). ``seed`` feeds the deterministic split-routing permutation;
    ``metadata`` lands in every split's manifest (plus ``split``/
    ``fraction`` keys). Returns the committed store(s), keyed by split
    name (``""`` when ``splits is None``).
    """
    if codec not in WRITER_CODECS:
        raise ValueError(f"codec must be one of {WRITER_CODECS}, "
                         f"got {codec!r}")
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if not len(chunk_rows) or min(chunk_rows) < 1:
        raise ValueError("chunk_rows must be a non-empty sequence of "
                         "positive per-chunk row counts")
    chunk_rows = [int(n) for n in chunk_rows]
    names = _split_names(splits)
    cum = _split_cum_rows(chunk_rows, splits)
    empty = [name for name in names if int(cum[name][-1]) == 0]
    if empty:
        raise ValueError(f"splits {empty} receive zero rows — fractions too "
                         "small for these chunk sizes; use larger chunks")
    for name in names:
        os.makedirs(os.path.join(directory, name) if splits is not None
                    else directory, exist_ok=True)
        stale = os.path.join(directory, name if splits is not None else "",
                             MANIFEST_NAME)
        if os.path.exists(stale):  # same re-ingest discipline as the writer
            os.remove(stale)

    args = [(w, workers, chunk_fn, chunk_rows, directory, shard_rows,
             dict(splits) if splits is not None else None, codec, seed)
            for w in range(workers)]
    if workers == 1:
        results = [_run_worker(*args[0])]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            results = pool.starmap(_run_worker, args)

    out = {}
    for name in names:
        sdir = os.path.join(directory, name) if splits is not None \
            else directory
        per_worker = [r[name]["shards"] for r in results if name in r]
        column_sets = [json.dumps(r[name]["columns"], sort_keys=True)
                       for r in results if name in r]
        if len(set(column_sets)) > 1:
            raise ValueError(f"workers disagree on the column schema of "
                             f"split {name!r}")
        shards = merge_shard_groups(per_worker)
        total = int(cum[name][-1])
        got = sum(s["rows"] for s in shards)
        if got != total:
            raise ValueError(f"merged shards of split {name!r} hold {got} "
                             f"rows, plan says {total}")
        columns = next(r[name]["columns"] for r in results if name in r)
        meta = dict(metadata or {})
        if splits is not None:
            meta.update(split=name, fraction=splits[name])
        _commit_manifest(sdir, columns, shards, shard_rows, meta)
        out[name] = SessionStore(sdir)
    return out


def ingest_synthetic(cfg, directory: str, chunk_sessions: int = 100_000,
                     shard_rows: int = 1_000_000,
                     splits: Optional[Mapping[str, float]] = None,
                     codec: str = "auto", workers: int = 1
                     ) -> Dict[str, SessionStore]:
    """:func:`repro_torch.data.store.ingest_synthetic` with a ``workers`` knob.

    ``workers=1`` runs the serial reference implementation in-process;
    ``workers>1`` fans the same deterministic chunk stream over processes
    via :func:`ingest_chunks` — byte-identical output either way (pinned
    in tests/test_torch_store.py). The manifest metadata records the codec and
    worker count actually used.
    """
    if workers == 1:
        return _store.ingest_synthetic(
            cfg, directory, chunk_sessions=chunk_sessions,
            shard_rows=shard_rows, splits=splits, codec=codec,
            extra_metadata={"ingest_workers": 1})
    meta = {"synthetic_config": dataclasses.asdict(cfg),
            "chunk_sessions": int(chunk_sessions),
            "store_codec": codec,
            "ingest_workers": int(workers)}
    return ingest_chunks(
        functools.partial(synthesize_chunk, cfg,
                          chunk_sessions=chunk_sessions),
        chunk_sizes(cfg, chunk_sessions), directory, shard_rows=shard_rows,
        splits=splits, codec=codec, workers=workers, seed=cfg.seed,
        metadata=meta)
