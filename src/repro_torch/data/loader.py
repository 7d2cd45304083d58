"""Deterministic batch loading and the host-to-device prefetcher.

``split_sessions``, ``LoaderState`` and ``ClickLogLoader`` are copied from
``repro.data.loader`` (numpy only, but that module imports JAX).
``DevicePrefetcher`` is the port of its inline mode: host batches (or chunks
of ``chunk_batches`` stacked batches) are copied to the device from pinned
memory with ``non_blocking=True``, so the copy of the next item overlaps the
steps already queued on the device. The overlap staging thread waits for a
later slice.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

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
        while True:
            order = self._epoch_order(self.state.epoch)
            nb = self.batches_per_epoch
            while self.state.step < nb:
                i = self.state.step
                idx = order[i * self.batch_size:(i + 1) * self.batch_size]
                self.state.step += 1
                yield {k: v[idx] for k, v in self.data.items()}
            self.state = LoaderState(epoch=self.state.epoch + 1, step=0)
            return  # one epoch per __iter__ call

    def epochs(self, n_epochs: int):
        start = self.state.epoch
        while self.state.epoch < start + n_epochs:
            yield from iter(self)

    # -- checkpointing -----------------------------------------------------------
    def state_dict(self):
        return self.state.to_dict()

    def load_state_dict(self, d):
        self.state = LoaderState.from_dict(d)


class DevicePrefetcher:
    """Keeps ``size`` items on the device ahead of the consumer.

    Iterating yields ``(device_batch, loader_state)`` pairs, or with
    ``chunk_batches=N`` ``(chunk, loader_state, n)`` triples where each key
    holds ``n <= N`` consecutive host batches stacked to ``(n, B, ...)``.
    ``loader_state`` is the loader's resume point recorded when the item
    (the chunk's last batch) was produced. A batch whose shapes differ from
    the chunk being gathered (the ``drop_last=False`` tail) flushes the
    chunk and starts its own, so every chunk is rectangular.
    """

    def __init__(self, loader, size: int = 2, device="cuda",
                 chunk_batches: Optional[int] = None):
        if size < 1:
            raise ValueError(f"prefetch size must be >= 1, got {size}")
        if chunk_batches is not None and chunk_batches < 1:
            raise ValueError(
                f"chunk_batches must be >= 1, got {chunk_batches}")
        self.loader = loader
        self.size = size
        self.device = torch.device(device)
        self.chunk_batches = chunk_batches

    def _put(self, batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        return out

    def _items(self):
        it = iter(self.loader)
        get_state = getattr(self.loader, "state_dict", lambda: None)
        if self.chunk_batches is None:
            for batch in it:
                yield (self._put(batch), get_state())
            return
        pushback = []  # one-batch lookahead for the shape-change flush
        while True:
            batches, state, sig = [], None, None
            while len(batches) < self.chunk_batches:
                if pushback:
                    item = pushback.pop()
                else:
                    try:
                        item = (next(it), get_state())
                    except StopIteration:
                        break
                batch, s = item
                bsig = {k: (v.shape, v.dtype) for k, v in batch.items()}
                if sig is not None and bsig != sig:
                    pushback.append(item)
                    break
                sig = bsig
                batches.append(batch)
                state = s
            if not batches:
                return
            chunk = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
            yield (self._put(chunk), state, len(batches))

    def __iter__(self):
        """Prime ``size`` items, then refill one ahead of each yield."""
        items = self._items()
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
                yield queue.popleft()
        finally:
            items.close()
