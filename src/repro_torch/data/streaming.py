"""Streaming loader over an on-disk :class:`repro_torch.data.store.SessionStore`.

Copied from ``repro.data.streaming`` (numpy only).

Trains on click logs far larger than host RAM with the same contract as the
in-memory ``ClickLogLoader``: deterministic shuffling, bit-exact mid-epoch
checkpoint/resume, host sharding for multi-host data parallelism, and an
iterator of numpy batch dicts that plugs straight into ``DevicePrefetcher``.

How the epoch stream is defined (all deterministic in ``(seed, epoch)``):

1. **Shard order** — the host's assigned shards (``shard_id % host_count ==
   host_id``: placement at shard granularity, no row-level coordination)
   are permuted by ``rng((seed, epoch, 0))``.
2. **In-shard order** — each shard's rows are permuted by
   ``rng((seed, epoch, 1 + shard_id))``. Row payloads are read only
   ``window_rows`` of that permutation at a time (default: one whole
   shard), so peak reader memory is O(window * (1 + read_ahead)) row
   payloads plus one O(shard_rows) index permutation (8 bytes/row, small
   next to the rows it orders) — never O(log).
3. **Batching** — batches of ``batch_size`` are cut sequentially from the
   concatenated stream, spanning shard boundaries; ``drop_last`` matches
   ``ClickLogLoader``.

A **single-shard** store (one host) uses in-shard seed ``(seed, epoch)`` —
exactly ``ClickLogLoader._epoch_order`` — so the streaming loader is a
drop-in replacement that reproduces the in-memory loader's batch stream
bit-for-bit (tested in tests/test_torch_streaming.py). With ``shuffle=False`` the
stream is the store's row order for any shard count.

The cursor ``(epoch, shard, step)`` checkpoints like ``LoaderState``:
``step * batch_size`` locates the resume row inside the deterministic epoch
stream by pure arithmetic over the manifest's per-shard row counts, so
resume skips already-consumed shards without reading them.

A background read-ahead thread stages upcoming permuted windows into a
bounded queue so disk reads overlap compute; the consuming iterator (and
``DevicePrefetcher`` above it) sees plain numpy batches either way.

**Self-healing** (all opt-in, off by default so the fast path is
byte-identical to the unhardened loader):

* ``verify_checksums=True`` re-checks the manifest's crc32 for every column
  the loader reads, at shard-open time — the store has always *written*
  checksums; this is the read path that finally consumes them.
* ``io_retries=K`` retries a failed shard open/verify up to K times with
  exponential backoff (``io_retry_backoff * 2**attempt``) — transient
  ``OSError`` only; corruption is deterministic and never retried.
* ``corrupt_policy`` decides what a :class:`ShardCorruptionError` does:
  ``"raise"`` (default) surfaces it; ``"skip"`` **quarantines** the shard —
  it contributes zero rows from the moment of detection, the quarantine set
  rides in ``state_dict`` so resume excludes it from the cursor arithmetic,
  and every later epoch skips it up front. Corruption is detected at shard
  open, *before* any of its rows are delivered, so the delivered stream is
  exactly the fault-free stream minus the quarantined shard's rows —
  deterministic and replayable. Quarantine is per-host state; with
  ``host_count > 1`` the policy must stay ``"raise"`` (hosts dropping
  different shards would desync the step count).
* The consumer side watches the read-ahead producer: a producer that dies
  with a transient error is restarted once (``watchdog_restarts``) from the
  first window it had not yet delivered — already-queued windows are never
  re-read, so the batch stream is unchanged — before the error is surfaced
  with its original traceback. **Shutdown unconditionally wins over the
  watchdog**: after :meth:`StreamingClickLogLoader.close` (callable from
  any thread — e.g. the trainer thread while the overlapped
  ``DevicePrefetcher``'s staging thread consumes the epoch), a dying
  producer is never restarted, and a restart is also refused while the old
  producer thread is still alive after its join timeout (two producers
  feeding one queue would interleave windows nondeterministically).

Compressed stores (format v2) change none of the above: ``open_shard``
decodes in the read-ahead thread, checksum verification covers the stored
bytes, and a corrupt compressed column raises the same
``ShardCorruptionError`` through the same fail-closed / quarantine paths.
``stream.bytes_stored`` counts bytes as stored on disk next to
``stream.bytes_read``'s decoded bytes — their ratio is the live
compression factor of the read path.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.loader import MODEL_KEYS
from repro_torch.data.store import SessionStore, ShardCorruptionError, _take_rows
from repro_torch.obs import get_recorder

CORRUPT_POLICIES = ("raise", "skip")


@dataclasses.dataclass
class StreamingLoaderState:
    """Resumable cursor. ``epoch``/``step`` are authoritative (``step`` is the
    batch index within the epoch, as in ``LoaderState``); ``shard`` records
    the epoch-order position of the shard the last batch was drawn from
    (derived — kept for observability and log messages)."""
    epoch: int = 0
    step: int = 0
    shard: int = 0

    def to_dict(self):
        return {"epoch": self.epoch, "step": self.step, "shard": self.shard}

    @classmethod
    def from_dict(cls, d):
        return cls(epoch=int(d["epoch"]), step=int(d["step"]),
                   shard=int(d.get("shard", 0)))


class _WorkerError:
    def __init__(self, error: BaseException):
        self.error = error


_DONE = object()


class StreamingClickLogLoader:
    """Deterministic, checkpointable, out-of-core batch loader.

    Same surface as ``ClickLogLoader`` (``__iter__`` runs one epoch,
    ``epochs(n)``, ``batches_per_epoch``, ``state_dict``/``load_state_dict``)
    but backed by a :class:`SessionStore` instead of an in-memory dict.
    See the module docstring for the self-healing knobs
    (``verify_checksums``, ``io_retries``, ``corrupt_policy``,
    ``watchdog_restarts``).
    """

    def __init__(self, store, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 host_id: int = 0, host_count: int = 1,
                 include_keys: Optional[Tuple[str, ...]] = None,
                 window_rows: Optional[int] = None, read_ahead: int = 2,
                 verify_checksums: bool = False,
                 corrupt_policy: str = "raise",
                 io_retries: int = 0, io_retry_backoff: float = 0.05,
                 watchdog_restarts: int = 1, log_fn=print, recorder=None):
        self.store = (SessionStore(store)
                      if isinstance(store, (str, os.PathLike)) else store)
        if host_count > 1 and self.store.n_shards < host_count:
            raise ValueError(
                f"store has {self.store.n_shards} shards but host_count="
                f"{host_count}: sharding is at shard granularity — re-ingest "
                "with smaller shard_rows")
        if host_count > 1 and not drop_last:
            raise ValueError(
                "drop_last=False with host_count > 1 would give hosts "
                "different final-batch shapes; multi-host training requires "
                "drop_last=True")
        if corrupt_policy not in CORRUPT_POLICIES:
            raise ValueError(f"corrupt_policy must be one of "
                             f"{CORRUPT_POLICIES}, got {corrupt_policy!r}")
        if corrupt_policy == "skip" and host_count > 1:
            raise ValueError(
                'corrupt_policy="skip" is per-host state: hosts quarantining '
                "different shards would run different step counts and desync "
                'collectives — use "raise" with host_count > 1')
        self.keys = tuple(include_keys or
                          (k for k in self.store.columns if k in MODEL_KEYS))
        missing = [k for k in self.keys if k not in self.store.columns]
        if missing:
            raise KeyError(f"store lacks columns {missing}")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.host_id, self.host_count = host_id, host_count
        self.shard_ids = list(range(host_id, self.store.n_shards, host_count))
        self.n = sum(self.store.shard_rows(i) for i in self.shard_ids)
        # Shard-granular placement gives hosts unequal row counts; every host
        # must still run the same number of steps per epoch or collectives
        # desync (ClickLogLoader equalizes via n // host_count). Cap the
        # epoch at the smallest host's rows — pure manifest arithmetic.
        self._epoch_rows = min(
            sum(self.store.shard_rows(i)
                for i in range(h, self.store.n_shards, host_count))
            for h in range(host_count))
        if window_rows is not None and window_rows < 1:
            raise ValueError(f"window_rows must be >= 1, got {window_rows}")
        self.window_rows = window_rows
        self.read_ahead = int(read_ahead)
        self.verify_checksums = bool(verify_checksums)
        self.corrupt_policy = corrupt_policy
        self.io_retries = int(io_retries)
        self.io_retry_backoff = float(io_retry_backoff)
        self.watchdog_restarts = int(watchdog_restarts)
        self.log_fn = log_fn
        # Telemetry (repro_torch.obs): spans around shard reads/crc verifies/retry
        # waits, `stream.*` counters (bytes_read, sessions, io_retries,
        # watchdog_restarts, queue_stall_s, quarantined_shards), a read-ahead
        # queue-depth gauge, and quarantine/watchdog_restart events. With no
        # recorder pinned, everything goes to the process-global one —
        # disabled (no sinks) means spans land only in the host ring buffer.
        self.recorder = recorder
        self.quarantined: set = set()
        # One shard spanning the whole loader degenerates to the in-memory
        # loader's order: in-shard seed (seed, epoch) == ClickLogLoader.
        self._single_shard = (self.store.n_shards == 1 and host_count == 1)
        self.state = StreamingLoaderState()
        self._closed = False
        self._iter_stop: Optional[threading.Event] = None

    def close(self) -> None:
        """Permanently shut the loader down, from any thread.

        Sets the active iteration's stop event (the read-ahead producer
        bails out of its next ``put``, the consumer loop stops waiting) and
        marks the loader closed — any further iteration raises. The
        watchdog never restarts a producer after close: shutdown wins the
        race against a worker dying mid-teardown."""
        self._closed = True
        stop = self._iter_stop
        if stop is not None:
            stop.set()

    # -- epoch geometry (pure arithmetic, no IO) -------------------------------
    def _quarantined_rows(self) -> int:
        return sum(self.store.shard_rows(s) for s in self.quarantined
                   if s in self.shard_ids)

    @property
    def batches_per_epoch(self) -> int:
        """Identical on every host (computed from the smallest host's rows).
        Quarantined shards' rows are excluded (single-host only — skip
        policy is refused with ``host_count > 1``)."""
        rows = self._epoch_rows - self._quarantined_rows()
        if self.drop_last:
            return rows // self.batch_size
        return -(-rows // self.batch_size)

    def _shard_order(self, epoch: int) -> List[int]:
        if not self.shuffle or len(self.shard_ids) <= 1:
            return list(self.shard_ids)
        perm = np.random.default_rng((self.seed, epoch, 0)).permutation(
            len(self.shard_ids))
        return [self.shard_ids[i] for i in perm]

    def _inshard_order(self, epoch: int, shard_id: int) -> np.ndarray:
        rows = self.store.shard_rows(shard_id)
        if not self.shuffle:
            return np.arange(rows)
        key = (self.seed, epoch) if self._single_shard else \
            (self.seed, epoch, 1 + shard_id)
        return np.random.default_rng(key).permutation(rows)

    def _epoch_plan(self, epoch: int) -> List[Tuple[int, int, int, int]]:
        """(shard_pos, shard_id, start, stop) windows in stream order.
        Already-quarantined shards are excluded up front; a shard that fails
        verification mid-epoch is quarantined at open time and its windows
        deliver zero rows (see ``_read_plan``)."""
        plan = []
        for pos, sid in enumerate(self._shard_order(epoch)):
            if sid in self.quarantined:
                continue
            rows = self.store.shard_rows(sid)
            w = self.window_rows or rows
            for start in range(0, rows, w):
                plan.append((pos, sid, start, min(start + w, rows)))
        return plan

    # -- reading ---------------------------------------------------------------
    def _rec(self):
        return self.recorder if self.recorder is not None else get_recorder()

    def _quarantine(self, sid: int, err: BaseException) -> None:
        self.quarantined.add(sid)
        rec = self._rec()
        rec.event("quarantine", data={"shard": int(sid), "error": repr(err)})
        rec.add("stream.quarantined_shards")
        self.log_fn(f"[streaming] QUARANTINED shard {sid}: {err} — its rows "
                    f"are dropped from this and every later epoch "
                    f"({self._quarantined_rows()} rows quarantined total)")

    def _read_shard(self, sid: int) -> Dict[str, np.ndarray]:
        """Open (and optionally crc-verify) one shard with transient-IO
        retries. :class:`ShardCorruptionError` is deterministic and
        propagates immediately; ``OSError`` backs off exponentially."""
        rec = self._rec()
        attempt = 0
        while True:
            try:
                with rec.span("shard_read", shard=sid):
                    cols = self.store.open_shard(sid, columns=self.keys)
                    if self.verify_checksums:
                        with rec.span("crc_verify", shard=sid):
                            self.store.verify(sid, columns=self.keys)
                rec.add("stream.bytes_read",
                        sum(np.asarray(v).nbytes for v in cols.values()))
                stored = getattr(self.store, "shard_stored_nbytes", None)
                if stored is not None:  # absent on bare-dict test doubles
                    rec.add("stream.bytes_stored",
                            sum(stored(sid, k) for k in cols))
                return cols
            except ShardCorruptionError:
                raise
            except OSError as e:
                if attempt >= self.io_retries:
                    raise
                delay = self.io_retry_backoff * (2 ** attempt)
                attempt += 1
                rec.add("stream.io_retries")
                self.log_fn(f"[streaming] transient IO error on shard {sid} "
                            f"(attempt {attempt}/{self.io_retries + 1}): "
                            f"{e!r}; retrying in {delay:.2f}s")
                with rec.span("io_retry_wait", shard=sid, attempt=attempt):
                    time.sleep(delay)

    def _read_plan(self, epoch: int,
                   entries: Sequence[Tuple[Tuple[int, int, int, int], int]],
                   start: int = 0
                   ) -> Iterator[Tuple[int, int, Dict[str, np.ndarray]]]:
        """Materialize plan windows in order; ``entries`` pairs each plan
        entry with how many leading rows to drop (resume skip). Yields
        ``(entry_index, shard_pos, block)`` so a restarted producer can
        resume from the first undelivered entry."""
        cached_sid, cols, perm = None, None, None
        for i in range(start, len(entries)):
            (pos, sid, win_start, win_stop), drop = entries[i]
            if sid != cached_sid:
                cached_sid = sid
                try:
                    cols = self._read_shard(sid)
                    perm = self._inshard_order(epoch, sid)
                except ShardCorruptionError as e:
                    if self.corrupt_policy != "skip":
                        raise
                    self._quarantine(sid, e)
                    cols = None
            if cols is None:  # quarantined mid-epoch: zero rows delivered
                continue
            rows = perm[win_start + drop:win_stop]
            if rows.size == 0:
                continue
            yield i, pos, {k: np.asarray(v[rows]) for k, v in cols.items()}

    def _block_stream(self, epoch, entries):
        """``_read_plan`` behind a bounded background read-ahead thread,
        with a consumer-side watchdog: a producer that dies is restarted
        (``watchdog_restarts`` times) from its first undelivered entry;
        after that the original exception propagates, traceback intact.
        :meth:`close` beats the watchdog unconditionally — no restart ever
        happens after it."""
        if self._closed:
            raise RuntimeError("StreamingClickLogLoader is closed")
        if self.read_ahead <= 0:
            for _, pos, block in self._read_plan(epoch, entries):
                if self._closed:
                    raise RuntimeError(
                        "StreamingClickLogLoader.close() was called "
                        "mid-epoch")
                yield pos, block
            return
        q: queue.Queue = queue.Queue(maxsize=self.read_ahead)
        stop = threading.Event()
        self._iter_stop = stop
        progress = {"next": 0}  # first entry index not yet queued

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(start):
            try:
                for i, pos, block in self._read_plan(epoch, entries,
                                                     start=start):
                    if not put((pos, block)):
                        return
                    # After a successful put the only exception sources are
                    # in the next _read_plan iteration, so a restart from
                    # `next` never re-reads (or drops) a delivered window.
                    progress["next"] = i + 1
                put(_DONE)
            except BaseException as e:  # surfaced on the consumer side
                put(_WorkerError(e))

        def start_worker():
            t = threading.Thread(target=worker, args=(progress["next"],),
                                 daemon=True, name="store-read-ahead")
            t.start()
            return t

        thread = start_worker()
        restarts_left = self.watchdog_restarts
        rec = self._rec()
        try:
            while True:
                # Queue-stall time = how long the consumer sat waiting on the
                # producer: the direct measure of an IO-bound epoch. The
                # depth gauge after the get shows how much read-ahead is
                # actually banked.
                t_wait = time.monotonic()
                while True:
                    try:
                        item = q.get(timeout=0.2)
                        break
                    except queue.Empty:
                        # A cross-thread close() while the producer is gone
                        # must not leave this get() parked forever.
                        if stop.is_set():
                            raise RuntimeError(
                                "StreamingClickLogLoader.close() was "
                                "called mid-epoch — read-ahead shut down")
                rec.add("stream.queue_stall_s", time.monotonic() - t_wait)
                rec.gauge("stream.queue_depth", q.qsize())
                if item is _DONE:
                    return
                if isinstance(item, _WorkerError):
                    err = item.error
                    # Shutdown wins: after close() a dead producer is
                    # surfaced, never resurrected (a restart would read
                    # shards for an epoch nobody is consuming).
                    if (stop.is_set() or restarts_left <= 0
                            or isinstance(err, ShardCorruptionError)):
                        raise err
                    thread.join(timeout=5.0)
                    if thread.is_alive():
                        # The "dead" producer is actually wedged, not dead
                        # (its error came from a helper it spawned or it
                        # hung in teardown): starting a clone would race
                        # two producers into one queue. Fail loudly.
                        raise err
                    restarts_left -= 1
                    rec.event("watchdog_restart",
                              data={"error": repr(err),
                                    "plan_entry": progress["next"],
                                    "restarts_left": restarts_left})
                    rec.add("stream.watchdog_restarts")
                    self.log_fn(
                        f"[streaming] read-ahead producer died ({err!r});"
                        f" restarting from plan entry "
                        f"{progress['next']} "
                        f"({restarts_left} restarts left)")
                    thread = start_worker()
                    continue
                yield item
        finally:
            stop.set()
            # Abandoning the iterator mid-epoch must not leak the producer:
            # stop makes its pending put() bail, so the join is prompt.
            thread.join(timeout=10.0)

    # -- iteration -------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch per call, resuming from ``self.state`` (as in
        ``ClickLogLoader``); advances the cursor as batches are consumed."""
        epoch = self.state.epoch
        nb = self.batches_per_epoch
        if self.state.step < nb:
            # Resume arithmetic: skip whole windows that precede the cursor
            # row, and drop windows past the epoch's step cap (a host with
            # surplus rows — shard-granular placement — must neither read
            # nor buffer them). Pure arithmetic, no IO. Quarantined shards
            # are already absent from the plan, so the cursor row indexes
            # the *delivered* stream — a resume after a skip-policy
            # quarantine (persisted in state_dict) lands on the same batch.
            skip = self.state.step * self.batch_size
            need = (nb * self.batch_size if self.drop_last
                    else self.n - self._quarantined_rows())
            entries, cum = [], 0
            for entry in self._epoch_plan(epoch):
                rows = entry[3] - entry[2]
                if cum + rows <= skip:
                    cum += rows
                    continue
                if cum >= need:
                    break
                entries.append((entry, max(skip - cum, 0)))
                cum += rows
            parts: List[Dict[str, np.ndarray]] = []
            buffered = 0
            rec = self._rec()
            blocks = self._block_stream(epoch, entries)
            try:
                for shard_pos, block in blocks:
                    parts.append(block)
                    buffered += next(iter(block.values())).shape[0]
                    while buffered >= self.batch_size and self.state.step < nb:
                        batch = _take_rows(parts, self.batch_size)
                        buffered -= self.batch_size
                        self.state.step += 1
                        self.state.shard = shard_pos
                        rec.add("stream.sessions", self.batch_size)
                        yield batch
                    if self.state.step >= nb:
                        break  # epoch cap reached; don't read surplus windows
                if (not self.drop_last and buffered > 0
                        and self.state.step < nb):
                    batch = _take_rows(parts, buffered)
                    self.state.step += 1
                    rec.add("stream.sessions", buffered)
                    yield batch
            finally:
                blocks.close()  # stops the read-ahead thread
        self.state = StreamingLoaderState(epoch=epoch + 1, step=0, shard=0)

    def epochs(self, n_epochs: int):
        start = self.state.epoch
        while self.state.epoch < start + n_epochs:
            yield from iter(self)

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self):
        d = self.state.to_dict()
        if self.quarantined:
            # The quarantine set is part of the stream definition: a resume
            # that forgot it would re-count the corrupt shard's rows in the
            # cursor arithmetic and land on the wrong batch.
            d["quarantined"] = sorted(self.quarantined)
        return d

    def load_state_dict(self, d):
        self.state = StreamingLoaderState.from_dict(d)
        self.quarantined = set(int(s) for s in d.get("quarantined", ()))
