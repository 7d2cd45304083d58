"""Deterministic batch loading and the host-to-device prefetcher.

``split_sessions``, ``LoaderState`` and ``ClickLogLoader`` are copied from
``repro.data.loader`` (numpy only, but that module imports JAX); the
loader gathers a batch's rows with ``np.take``, which gives the bytes of
the reference's fancy indexing. ``DevicePrefetcher``
is the port of the reference's, with both of its modes: a staging thread
(``overlap=True``, the default) or the consumer's own thread. On a mesh it
stages one rank's rows of each batch (``shard=``).
"""
from __future__ import annotations

import collections
import dataclasses
import queue as queue_mod
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.recorder import get_recorder

MODEL_KEYS = ("positions", "query_doc_ids", "clicks", "mask",
              "query_doc_features", "bias_features")


def split_sessions(data: Dict[str, np.ndarray], fractions=(0.8, 0.1, 0.1),
                   seed: int = 0):
    """Shuffle-split a session dict into train/val/test dicts.

    The last split takes the exact remainder (independent per-fraction
    rounding could overlap splits or silently drop tail sessions); the
    splits always partition the input.
    """
    n = data["positions"].shape[0]
    order = np.random.default_rng(seed).permutation(n)
    sizes = [int(round(n * frac)) for frac in fractions[:-1]]
    sizes.append(n - sum(sizes))
    if sizes[-1] < 0:
        raise ValueError(f"fractions {fractions} overflow {n} sessions")
    assert sum(sizes) == n, (sizes, n)
    out = []
    start = 0
    for size in sizes:
        idx = order[start:start + size]
        out.append({k: v[idx] for k, v in data.items()})
        start += size
    return tuple(out)


@dataclasses.dataclass
class LoaderState:
    epoch: int = 0
    step: int = 0  # batch index within the epoch

    def to_dict(self):
        return {"epoch": self.epoch, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(epoch=int(d["epoch"]), step=int(d["step"]))


class ClickLogLoader:
    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 host_id: int = 0, host_count: int = 1,
                 include_keys: Optional[Tuple[str, ...]] = None):
        keys = include_keys or tuple(k for k in data if k in MODEL_KEYS)
        self.data = {k: data[k] for k in keys}
        n = next(iter(self.data.values())).shape[0]
        # host shard: contiguous slice per host
        per_host = n // host_count
        lo, hi = host_id * per_host, (host_id + 1) * per_host
        self.data = {k: v[lo:hi] for k, v in self.data.items()}
        self.n = per_host
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.state = LoaderState()

    @property
    def batches_per_epoch(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n)
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Resumes from self.state; advances it as batches are consumed."""
        return self.iter_rows(0, 1)

    def iter_rows(self, index: int, count: int
                  ) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch for rank ``index`` of ``count`` data-parallel ranks:
        every rank draws the same global batches in the same order, and
        only rows ``[index * B / count, (index + 1) * B / count)`` of each
        are gathered (:func:`shard_rows`: a batch that ``count`` does not
        divide, the ``drop_last=False`` tail, goes whole to rank 0 and
        empty to the others). ``(0, 1)`` is the whole batch."""
        while True:
            order = self._epoch_order(self.state.epoch)
            nb = self.batches_per_epoch
            while self.state.step < nb:
                i = self.state.step
                idx = order[i * self.batch_size:(i + 1) * self.batch_size]
                self.state.step += 1
                yield {k: np.take(v, shard_rows(idx, index, count), axis=0)
                       for k, v in self.data.items()}
            self.state = LoaderState(epoch=self.state.epoch + 1, step=0)
            return  # one epoch per call

    def epochs(self, n_epochs: int):
        start = self.state.epoch
        while self.state.epoch < start + n_epochs:
            yield from iter(self)

    # -- checkpointing -----------------------------------------------------------
    def state_dict(self):
        return self.state.to_dict()

    def load_state_dict(self, d):
        self.state = LoaderState.from_dict(d)


def shard_rows(rows, index: int, count: int):
    """Rank ``index``'s part of a batch's ``rows`` (an array or a
    sequence) among ``count`` data-parallel ranks: the ``index``-th of
    ``count`` equal blocks, or, where ``count`` does not divide them, all
    of them on rank 0 and none elsewhere."""
    n = len(rows)
    if n % count:
        return rows if index == 0 else rows[:0]
    step = n // count
    return rows[index * step:(index + 1) * step]


class _PinnedRing:
    """``slots`` sets of pinned host buffers, used in turn as the staging
    area of host-to-device copies. A slot is refilled only after the copy
    out of it has completed (its event); a slot whose shapes or types do
    not fit the item is allocated anew (``allocs`` counts such sets)."""

    def __init__(self, slots: int, pinned=None):
        self._slots: List[Tuple[Dict[str, torch.Tensor], object]] = \
            [({}, None)] * slots
        self._next = 0
        self.allocs = 0
        self._pinned = pinned or (lambda shape, dtype: torch.empty(
            shape, dtype=dtype, pin_memory=True))

    def take(self, like: Dict[str, Tuple[tuple, torch.dtype]]):
        """The next slot's buffers, shaped as ``like`` (key -> (shape,
        dtype)), once the copy out of them has finished."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        buffers, done = self._slots[i]
        if done is not None:
            done.synchronize()
        if {k: (tuple(b.shape), b.dtype) for k, b in buffers.items()} != like:
            buffers = {k: self._pinned(shape, dtype)
                       for k, (shape, dtype) in like.items()}
            self.allocs += 1
        self._slots[i] = (buffers, None)
        return i, buffers

    def copied(self, i: int, done) -> None:
        """Mark slot ``i``'s copy out as recorded by event ``done``."""
        self._slots[i] = (self._slots[i][0], done)


class DevicePrefetcher:
    """Keeps ``size`` items on the device ahead of the consumer.

    Iterating yields ``(device_batch, loader_state)`` pairs, or with
    ``chunk_batches=N`` ``(chunk, loader_state, n)`` triples where each key
    holds ``n <= N`` consecutive host batches stacked to ``(n, B, ...)``.
    ``loader_state`` is the loader's resume point recorded when the item
    (the chunk's last batch) was produced. A batch whose shapes differ from
    the chunk being gathered (the ``drop_last=False`` tail) flushes the
    chunk and starts its own, so every chunk is rectangular.

    With ``overlap=True`` (the default) the whole host side (pulling the
    loader's batches, stacking a chunk, the copy to the device and the
    resume state) runs on a staging thread that feeds a bounded queue of
    ``size`` finished items, so the consumer only pops them. Items,
    payloads and resume states are those of ``overlap=False``, where the
    same work runs on the consumer's thread (one producer, a FIFO queue).
    An exception on the staging thread is raised on the consumer with its
    own traceback. Abandoning the iteration stops and joins the thread,
    which closes the loader's generator: the thread that ran it.

    On CUDA each item is stacked into one of ``size + 1`` pinned host
    buffers used in turn, and copied to the device with ``non_blocking=True``
    on a high-priority stream of the prefetcher's own (never one that a
    CUDA graph is captured on), which records an event. The
    consumer's stream waits on that event when the item is handed over, and
    each tensor is marked as used there (``record_stream``), so the caching
    allocator does not hand its memory out again before the consumer's work
    on it has run.

    ``shard=(index, count)`` stages rank ``index``'s rows of every batch
    among ``count`` data-parallel ranks (:func:`shard_rows`: JAX's ``P(None,
    'data')`` block): every rank draws the same global batches, and the
    staging thread gathers and copies only its own rows (through the
    loader's ``iter_rows`` where its class has one, else by slicing each
    batch).

    The staging (or, inline, the consumer's) thread records detail spans
    on ``recorder`` (else the global recorder), each tagged with the
    ``item`` it builds, the item's index in this iteration:
    ``prefetch.batch`` (one pull from the loader: a batch's gather, or
    the end of its epoch), ``prefetch.pin`` (the stack into the item's
    host buffers; on the card the pinned ring's slot, once its last copy
    has ended), ``prefetch.copy`` (the copy to the device; on the card its
    enqueue) and ``prefetch.queue_full`` (blocked on a full queue); and
    the detail counters ``prefetch.items`` and ``prefetch.bytes``.
    """

    def __init__(self, loader, size: int = 2, device="cuda",
                 chunk_batches: Optional[int] = None, overlap: bool = True,
                 shard: Optional[Tuple[int, int]] = None, recorder=None):
        if size < 1:
            raise ValueError(f"prefetch size must be >= 1, got {size}")
        if chunk_batches is not None and chunk_batches < 1:
            raise ValueError(
                f"chunk_batches must be >= 1, got {chunk_batches}")
        self.loader = loader
        self.size = size
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names the caller's current card; the staging thread's
            # own current card is card 0, whichever the process uses
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.chunk_batches = chunk_batches
        self.overlap = overlap
        self.shard = None if shard is None or shard[1] == 1 else tuple(shard)
        self.recorder = recorder

    def _rec(self):
        return self.recorder if self.recorder is not None else get_recorder()

    # -- host-side item stream (shared by both modes) ------------------------
    def _groups(self, rec):
        """The loader's batches, grouped into items: ``(batches, state,
        n)`` with ``n`` None outside chunk mode. The loader's generator is
        created at the first ``next()``: on the staging thread in overlap
        mode, which therefore also closes it."""
        item = 0

        def pull():
            with rec.span("prefetch.batch", detail=True, item=item):
                return next(it), get_state()

        if self.shard is None:
            it = iter(self.loader)
        elif hasattr(type(self.loader), "iter_rows"):
            # the loader's own (a proxy that forwards attributes, such as
            # a fault injector, is iterated and sliced instead)
            it = self.loader.iter_rows(*self.shard)
        else:
            it = ({k: shard_rows(v, *self.shard) for k, v in batch.items()}
                  for batch in self.loader)
        get_state = getattr(self.loader, "state_dict", lambda: None)
        if self.chunk_batches is None:
            while True:
                try:
                    batch, state = pull()
                except StopIteration:
                    return
                yield [batch], state, None
                item += 1
        pushback = []  # one-batch lookahead for the shape-change flush
        while True:
            batches, state, sig = [], None, None
            while len(batches) < self.chunk_batches:
                if pushback:
                    got = pushback.pop()
                else:
                    try:
                        got = pull()
                    except StopIteration:
                        break
                batch, s = got
                bsig = {k: (v.shape, v.dtype) for k, v in batch.items()}
                if sig is not None and bsig != sig:
                    pushback.append(got)
                    break
                sig = bsig
                batches.append(batch)
                state = s
            if not batches:
                return
            yield batches, state, len(batches)
            item += 1

    def _items(self, rec):
        """Finished items: ``(tensors, event, state, n)``; ``event`` marks
        the end of the tensors' copy to the card (None on the CPU)."""
        groups = self._groups(rec)
        try:
            if self.device.type == "cuda":
                ring = _PinnedRing(self.size + 1)
                # High priority: PyTorch hands streams out of one pool per
                # priority, round robin, and captures on default-priority
                # ones (torch.cuda.graph's capture stream, the warm-up's
                # side stream). A copy stream from that pool would in time
                # be the stream being captured, and the copy would enter
                # the graph.
                stream = torch.cuda.Stream(self.device, priority=-1)
            for item, (batches, state, n) in enumerate(groups):
                if self.device.type == "cuda":
                    tensors, done = self._put_cuda(batches, n, ring, stream,
                                                   rec, item)
                else:
                    tensors, done = self._put_host(batches, n, rec, item), None
                rec.add("prefetch.items", detail=True)
                rec.add("prefetch.bytes", sum(t.nbytes for t in
                                              tensors.values()), detail=True)
                yield tensors, done, state, n
        finally:
            groups.close()

    def _put_host(self, batches, n, rec, item):
        with rec.span("prefetch.pin", detail=True, item=item):
            if n is None:
                (batch,) = batches
                host = {k: np.ascontiguousarray(v) for k, v in batch.items()}
            else:
                host = {k: np.stack([b[k] for b in batches])
                        for k in batches[0]}
        with rec.span("prefetch.copy", detail=True, item=item):
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in host.items()}

    def _put_cuda(self, batches, n, ring, stream, rec, item):
        """Stack ``batches`` into the ring's next pinned slot and copy it to
        the card on ``stream``; returns the device tensors and the copy's
        event."""
        first = batches[0]
        lead = () if n is None else (n,)
        like = {k: (lead + tuple(v.shape),
                    torch.from_numpy(np.empty(0, v.dtype)).dtype)
                for k, v in first.items()}
        with rec.span("prefetch.pin", detail=True, item=item):
            slot, pinned = ring.take(like)
            for k, buf in pinned.items():
                host = buf.numpy()
                if n is None:
                    np.copyto(host, first[k])
                else:
                    np.stack([b[k] for b in batches], out=host)
        with rec.span("prefetch.copy", detail=True, item=item), \
                torch.cuda.stream(stream):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the prefetcher's copy stream is being "
                                   "captured into a CUDA graph")
            out = {k: buf.to(self.device, non_blocking=True)
                   for k, buf in pinned.items()}
            done = torch.cuda.Event()
            done.record(stream)
        ring.copied(slot, done)
        return out, done

    def _handed(self, item):
        """The item as the consumer gets it: its stream waits for the copy,
        and each tensor is marked as used on that stream."""
        tensors, done, state, n = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in tensors.values():
                t.record_stream(consumer)
        return (tensors, state) if n is None else (tensors, state, n)

    # -- execution modes -----------------------------------------------------
    def _pump(self, items):
        """Inline mode: prime ``size`` items, then refill one ahead of each
        yield, all on the consumer's thread (``overlap=False``)."""
        queue = collections.deque()
        try:
            for item in items:
                queue.append(item)
                if len(queue) >= self.size:
                    break
            while queue:
                nxt = next(items, None)
                if nxt is not None:  # refill before handing back to compute
                    queue.append(nxt)
                yield self._handed(queue.popleft())
        finally:
            items.close()

    def _staged(self, items, rec):
        """Overlap mode: the item stream runs on a staging thread feeding a
        bounded queue; the consumer only pops finished items."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.size)
        stop = threading.Event()
        done = object()
        fail = []  # [exception], raised on the consumer
        sent = [0]  # items sent, so the index of the next

        def send(item) -> bool:
            if stop.is_set():
                return False
            try:
                q.put_nowait(item)
                return True
            except queue_mod.Full:
                pass
            with rec.span("prefetch.queue_full", detail=True, item=sent[0]):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue_mod.Full:
                        continue
            return False

        def run():
            try:
                for item in items:
                    if not send(item):
                        return
                    sent[0] += 1
                send(done)
            except BaseException as e:  # noqa: BLE001 - raised on the consumer
                fail.append(e)
                send(done)
            finally:
                items.close()  # run here, so closed here

        thread = threading.Thread(target=run, daemon=True,
                                  name="device-prefetch")
        thread.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.2)
                except queue_mod.Empty:
                    if not thread.is_alive() and q.empty() and not fail:
                        return  # ended without a result: nothing to raise
                    continue
                if item is done:
                    if fail:
                        raise fail[0]  # its own traceback
                    return
                yield self._handed(item)
        finally:
            stop.set()
            thread.join(timeout=10.0)

    def __iter__(self):
        rec = self._rec()
        if self.overlap:
            yield from self._staged(self._items(rec), rec)
        else:
            yield from self._pump(self._items(rec))
