"""The port's loader and prefetcher against JAX's, on the CPU.

``ClickLogLoader`` (``np.take`` gathers) batch for batch against
``repro.data.ClickLogLoader``'s fancy indexing; ``DevicePrefetcher``'s
staging thread (``overlap=True``) item for item against its inline mode and
against JAX's prefetcher; errors on the thread raised on the consumer;
abandoning an iteration joins the thread and closes the loader's generator
there. These mirror ``tests/test_store.py``'s overlap tests with an
in-memory loader. The pinned ring's reuse rule is checked with stand-in
buffers and events (the card's copies run in ``chip_smoke.py``).
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import ClickLogLoader as JaxLoader
from repro.data import DevicePrefetcher as JaxPrefetcher
from repro_torch.data import (ClickLogLoader, DevicePrefetcher,
                              SyntheticConfig, generate_click_log)
from repro_torch.data.loader import _PinnedRing


@pytest.fixture(scope="module")
def data():
    cfg = SyntheticConfig(n_sessions=1000, n_queries=50, docs_per_query=12,
                          positions=10, behavior="dbn", seed=5, n_features=3)
    log, _ = generate_click_log(cfg)
    keys = ("positions", "query_doc_ids", "clicks", "mask",
            "query_doc_features")
    return {k: log[k] for k in keys}


def _equal(a, b, same_dtype=True):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        assert x.dtype == y.dtype or not same_dtype, k
        assert np.array_equal(x, y), k


LOADERS = {
    "shuffled": dict(batch_size=64, seed=3),
    "in_order_drop_last_false": dict(batch_size=96, shuffle=False,
                                     drop_last=False),
    "shuffled_drop_last_false": dict(batch_size=128, seed=1,
                                     drop_last=False),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_matches_jax_batch_for_batch_over_two_epochs(data, name):
    ours, theirs = (cls(data, **LOADERS[name])
                    for cls in (ClickLogLoader, JaxLoader))
    got, want = list(ours.epochs(2)), list(theirs.epochs(2))
    assert len(got) == len(want) == 2 * ours.batches_per_epoch
    for a, b in zip(got, want):
        _equal(a, b)
    assert ours.state_dict() == theirs.state_dict() == {"epoch": 2,
                                                        "step": 0}


def test_loader_resumes_mid_epoch_as_jax_does(data):
    ours = ClickLogLoader(data, batch_size=64, seed=7, drop_last=False)
    theirs = JaxLoader(data, batch_size=64, seed=7, drop_last=False)
    for loader in (ours, theirs):
        loader.load_state_dict({"epoch": 1, "step": 5})
    got, want = list(iter(ours)), list(iter(theirs))
    assert len(got) == len(want) == ours.batches_per_epoch - 5
    for a, b in zip(got, want):
        _equal(a, b)


def _stream(prefetcher):
    out = []
    for item in prefetcher:
        payload, rest = item[0], item[1:]
        out.append(({k: v.numpy() for k, v in payload.items()}, rest))
    return out


@pytest.mark.parametrize("chunk_batches", [None, 4])
def test_overlap_gives_the_inline_item_stream(data, chunk_batches):
    def make(overlap):
        loader = ClickLogLoader(data, batch_size=96, seed=2, drop_last=False)
        return DevicePrefetcher(loader, size=3, device="cpu",
                                chunk_batches=chunk_batches, overlap=overlap)

    inline, staged = _stream(make(False)), _stream(make(True))
    assert [rest for _, rest in inline] == [rest for _, rest in staged]
    for (a, _), (b, _) in zip(inline, staged):
        _equal(a, b)
    if chunk_batches:
        # 10 full batches and the 40-row tail: 4 + 4 + 2, then the tail
        assert [rest[1] for _, rest in staged] == [4, 4, 2, 1]


@pytest.mark.parametrize("chunk_batches", [None, 3])
def test_overlap_matches_jax_prefetcher(data, chunk_batches):
    def loader(cls):
        return cls(data, batch_size=96, seed=4, drop_last=False)

    ours = _stream(DevicePrefetcher(loader(ClickLogLoader), device="cpu",
                                    chunk_batches=chunk_batches))
    theirs = list(JaxPrefetcher(loader(JaxLoader),
                                chunk_batches=chunk_batches))
    assert len(ours) == len(theirs)
    for (payload, rest), item in zip(ours, theirs):
        # JAX's device_put makes int64 ids int32 (x64 is off)
        _equal(payload, item[0], same_dtype=False)
        assert rest == tuple(item[1:])


class _Failing:
    """A loader whose third batch raises on the thread that iterates it."""

    def __init__(self, data):
        self.inner = ClickLogLoader(data, batch_size=64, shuffle=False)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i == 2:
                raise_in_loader()
            yield batch


def raise_in_loader():
    raise OSError("shard unreadable")


@pytest.mark.parametrize("chunk_batches", [None, 2])
def test_a_loader_error_on_the_thread_is_raised_on_the_consumer(
        data, chunk_batches):
    prefetcher = DevicePrefetcher(_Failing(data), size=2, device="cpu",
                                  chunk_batches=chunk_batches)
    with pytest.raises(OSError, match="shard unreadable") as info:
        list(prefetcher)
    assert "raise_in_loader" in [entry.name for entry in info.traceback]


class _Watched:
    """A loader that records which thread closes its epoch generator."""

    def __init__(self, data):
        self.inner = ClickLogLoader(data, batch_size=32, seed=0)
        self.closed_on = None

    def __iter__(self):
        try:
            yield from self.inner
        finally:
            self.closed_on = threading.current_thread().name


def test_abandoning_an_iteration_joins_the_thread_and_closes_the_loader(
        data):
    loader = _Watched(data)
    it = iter(DevicePrefetcher(loader, size=2, device="cpu",
                               chunk_batches=2))
    next(it)
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        live = [t for t in threading.enumerate()
                if t.name == "device-prefetch" and t.is_alive()]
        if not live:
            break
        time.sleep(0.02)
    assert not live, "the staging thread outlived the iteration"
    assert loader.closed_on == "device-prefetch"
    # the consumer got 2 items; the thread ran at most size + 1 ahead
    assert 2 * 2 <= loader.inner.state.step <= (2 + 2 + 1) * 2


class _Event:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def synchronize(self):
        self.log.append(("wait", self.name))


def test_pinned_ring_reuses_a_slot_only_after_its_copy_and_refits_shapes():
    made = []

    def pinned(shape, dtype):
        made.append(shape)
        return torch.empty(shape, dtype=dtype)

    ring = _PinnedRing(3, pinned=pinned)
    like = {"clicks": ((4, 8, 10), torch.float32)}
    log = []
    first = []
    for i in range(3):
        slot, buffers = ring.take(like)
        assert slot == i and log == []
        first.append(buffers["clicks"])
        ring.copied(slot, _Event(log, i))
    slot, buffers = ring.take(like)  # slot 0 again: waits for copy 0
    assert slot == 0 and log == [("wait", 0)]
    assert buffers["clicks"] is first[0]
    ring.copied(slot, _Event(log, 3))
    tail = {"clicks": ((1, 8, 10), torch.float32)}
    slot, buffers = ring.take(tail)  # the tail chunk: slot 1, refitted
    assert slot == 1 and log[-1] == ("wait", 1)
    assert tuple(buffers["clicks"].shape) == (1, 8, 10)
    assert made == [(4, 8, 10)] * 3 + [(1, 8, 10)]
