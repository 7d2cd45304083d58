"""The streaming loader: port against JAX on the CPU, to the bit.

The same store (written once by the port, which writes JAX's bytes:
``test_torch_store.py``) feeds the port's ``StreamingClickLogLoader`` and
JAX's; the batch streams must be equal to the bit for shuffle on and off,
1 and 3 shards, read windows, 2 hosts, ``drop_last`` off, a mid-epoch
``state_dict`` resume, a quarantined corrupt shard, transient read errors
retried and a read-ahead producer restarted by the watchdog. Beside that,
the port's own contract as JAX's tests pin it: a single-shard store
replays the in-memory loader, the loader plugs into the overlapped
``DevicePrefetcher`` unchanged, ``close()`` from another thread wins over
the watchdog, an abandoned or preempted epoch leaves no producer thread
running, and a Trainer fed from a store trains to the bit as one fed from
memory.
"""
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import SessionStore as JaxStore
from repro.data import StreamingClickLogLoader as JaxStreaming
from repro.testing import FlakyShardReads as JaxFlaky
from repro_torch import optim
from repro_torch.core import MODEL_REGISTRY, EmbeddingParameterConfig
from repro_torch.data import (ClickLogLoader, DevicePrefetcher, SessionStore,
                              ShardCorruptionError, StreamingClickLogLoader,
                              SyntheticConfig, generate_click_log,
                              write_session_store)
from repro_torch.testing import (FlakyShardReads, KillSwitch,
                                 corrupt_shard_file)
from repro_torch.train import Trainer
from repro_torch.train.capture import tree_leaves

N = 1000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def log():
    cfg = SyntheticConfig(n_sessions=N, n_queries=25, docs_per_query=12,
                          positions=8, behavior="dbn", seed=13)
    data, _ = generate_click_log(cfg)
    return cfg, data


@pytest.fixture(scope="module")
def stores(tmp_path_factory, log):
    """One shard, three shards (400, 400, 200 rows), five shards."""
    _, data = log
    root = tmp_path_factory.mktemp("stores")
    return {n: str(write_session_store(data, str(root / f"s{n}"),
                                       shard_rows=rows,
                                       codec="auto").directory)
            for n, rows in ((1, N), (3, 400), (5, 200))}


def _stream(loader, epochs=1):
    return [b for _ in range(epochs) for b in loader]


def assert_streams_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert np.asarray(x[k]).tobytes() == np.asarray(y[k]).tobytes()


def _pair(where, **kw):
    return (StreamingClickLogLoader(where, log_fn=lambda s: None, **kw),
            JaxStreaming(where, log_fn=lambda s: None, **kw))


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("window_rows", [None, 64])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_stream_equals_jax(stores, shuffle, shards, window_rows, drop_last):
    port, ref = _pair(stores[shards], batch_size=96, shuffle=shuffle,
                      seed=4, window_rows=window_rows, drop_last=drop_last)
    assert port.batches_per_epoch == ref.batches_per_epoch
    assert_streams_equal(_stream(port, 2), _stream(ref, 2))
    assert port.state_dict() == ref.state_dict()


@pytest.mark.parametrize("host_id", [0, 1])
def test_host_sharded_stream_equals_jax(stores, host_id):
    port, ref = _pair(stores[5], batch_size=64, seed=2, host_id=host_id,
                      host_count=2)
    assert port.shard_ids == ref.shard_ids == list(range(host_id, 5, 2))
    # epochs capped at the smaller host's rows: both hosts in step
    assert port.batches_per_epoch == ref.batches_per_epoch == 400 // 64
    assert_streams_equal(_stream(port), _stream(ref))


@pytest.mark.parametrize("read_ahead", [0, 2])
@pytest.mark.parametrize("window_rows", [None, 100])
def test_mid_epoch_resume_equals_jax_and_the_uninterrupted_stream(
        stores, read_ahead, window_rows):
    kw = dict(batch_size=80, seed=7, window_rows=window_rows,
              read_ahead=read_ahead)
    whole = _stream(StreamingClickLogLoader(stores[3], **kw))
    port, ref = _pair(stores[3], **kw)
    head = [b for _, b in zip(range(6), port)]
    for _, _ in zip(range(6), ref):
        pass
    state = port.state_dict()
    assert state == ref.state_dict() and state["step"] == 6
    resumed, jax_resumed = _pair(stores[3], **kw)
    resumed.load_state_dict(state)
    jax_resumed.load_state_dict(state)
    tail = _stream(resumed)
    assert_streams_equal(head + tail, whole)
    assert_streams_equal(tail, _stream(jax_resumed))


def test_quarantined_shard_equals_jax_and_the_fault_free_stream_less_it(
        tmp_path, log):
    _, data = log
    where = str(tmp_path / "s")
    write_session_store(data, where, shard_rows=250, codec="auto")
    expected = StreamingClickLogLoader(where, batch_size=50, seed=3)
    expected.load_state_dict({"epoch": 0, "step": 0, "quarantined": [2]})
    want = _stream(expected)
    corrupt_shard_file(where, shard=2, column="clicks", seed=1)
    kw = dict(batch_size=50, seed=3, verify_checksums=True,
              corrupt_policy="skip")
    port, ref = _pair(where, **kw)
    got = _stream(port)
    assert_streams_equal(got, _stream(ref))
    assert_streams_equal(got, want)
    assert port.quarantined == ref.quarantined == {2}
    assert len(got) == (1000 - 250) // 50
    # the quarantine rides the state: a resume skips the shard up front
    state = port.state_dict()
    assert state["quarantined"] == [2]
    again = StreamingClickLogLoader(where, **kw)
    again.load_state_dict(state)
    assert again.batches_per_epoch == (1000 - 250) // 50


@pytest.mark.parametrize("fail_times", [1, 2])
def test_flaky_reads_retried_equal_jax(stores, fail_times):
    kw = dict(batch_size=100, seed=1, io_retries=2, io_retry_backoff=0.001,
              log_fn=lambda s: None)
    port = StreamingClickLogLoader(
        FlakyShardReads(SessionStore(stores[3]), fail_times=fail_times),
        **kw)
    ref = JaxStreaming(JaxFlaky(JaxStore(stores[3]), fail_times=fail_times),
                       **kw)
    got = _stream(port)
    assert_streams_equal(got, _stream(ref))
    assert_streams_equal(got, _stream(StreamingClickLogLoader(
        stores[3], batch_size=100, seed=1)))
    assert port.store.failures == fail_times


def test_retries_exhausted_raise(stores):
    loader = StreamingClickLogLoader(
        FlakyShardReads(SessionStore(stores[3]), fail_times=3),
        batch_size=100, io_retries=1, io_retry_backoff=0.001,
        log_fn=lambda s: None, read_ahead=0)
    with pytest.raises(OSError):
        _stream(loader)


class _DiesOnce(FlakyShardReads):
    """The read-ahead producer's store: its second shard open raises an
    error that is not an ``OSError`` (so the loader's IO retry lets it
    through) once; the watchdog restarts the producer."""

    def __init__(self, store):
        super().__init__(store, fail_times=0)
        self.died = False

    def open_shard(self, index, columns=None):
        self.calls += 1
        if self.calls == 2 and not self.died:
            self.died = True
            raise RuntimeError("producer dies")
        return self._store.open_shard(index, columns=columns)


def test_producer_restart_equals_jax_and_the_clean_stream(stores):
    kw = dict(batch_size=90, seed=5, log_fn=lambda s: None)
    port = StreamingClickLogLoader(_DiesOnce(SessionStore(stores[3])), **kw)
    got = _stream(port)
    assert port.store.died
    assert_streams_equal(got, _stream(JaxStreaming(stores[3], **kw)))
    # a second death is not restarted: the original error surfaces
    dying = StreamingClickLogLoader(_DiesOnce(SessionStore(stores[3])),
                                    watchdog_restarts=0, **kw)
    with pytest.raises(RuntimeError, match="producer dies"):
        _stream(dying)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_single_shard_store_replays_the_in_memory_loader(
        stores, log, shuffle, drop_last):
    _, data = log
    keys = ("positions", "query_doc_ids", "clicks", "mask")
    memory = ClickLogLoader({k: data[k] for k in keys}, batch_size=96,
                            shuffle=shuffle, seed=8, drop_last=drop_last)
    stream = StreamingClickLogLoader(stores[1], batch_size=96,
                                     shuffle=shuffle, seed=8,
                                     drop_last=drop_last)
    assert_streams_equal(_stream(stream, 2), _stream(memory, 2))


def test_constructor_refusals_match_jax(stores):
    for kw in (dict(host_count=2, drop_last=False),
               dict(host_count=2, corrupt_policy="skip"),
               dict(corrupt_policy="ignore"), dict(window_rows=0),
               dict(host_count=7)):
        with pytest.raises(ValueError):
            StreamingClickLogLoader(stores[5], batch_size=10, **kw)
        with pytest.raises(ValueError):
            JaxStreaming(stores[5], batch_size=10, **kw)
    with pytest.raises(KeyError):
        StreamingClickLogLoader(stores[1], batch_size=10,
                                include_keys=("nope",))


def test_verify_checksums_raises_on_a_corrupt_shard(tmp_path, log):
    _, data = log
    where = str(tmp_path / "s")
    write_session_store(data, where, shard_rows=500)
    corrupt_shard_file(where, shard=1, seed=2)
    assert len(_stream(StreamingClickLogLoader(where, batch_size=100))) == 10
    with pytest.raises(ShardCorruptionError):
        _stream(StreamingClickLogLoader(where, batch_size=100,
                                        verify_checksums=True))


def _reader_threads():
    return [t for t in threading.enumerate()
            if t.name in ("store-read-ahead", "device-prefetch")
            and t.is_alive()]


@pytest.mark.parametrize("overlap", [True, False])
def test_prefetcher_over_the_stream_equals_it_with_resume_states(
        stores, overlap):
    loader = StreamingClickLogLoader(stores[3], batch_size=64, seed=2)
    want = _stream(StreamingClickLogLoader(stores[3], batch_size=64, seed=2))
    got, states = [], []
    for chunk, state, n in DevicePrefetcher(loader, device="cpu",
                                            chunk_batches=4,
                                            overlap=overlap):
        got.extend({k: v[i].numpy() for k, v in chunk.items()}
                   for i in range(n))
        states.append(state["step"])
    assert_streams_equal(got, want)
    assert states == [4, 8, 12, 15]


def test_abandoned_epoch_joins_the_producer_and_the_staging_thread(stores):
    loader = StreamingClickLogLoader(stores[5], batch_size=40, seed=0,
                                     window_rows=20, read_ahead=1)
    items = iter(DevicePrefetcher(loader, device="cpu", chunk_batches=2))
    next(items)
    assert _reader_threads()
    items.close()
    deadline = time.time() + 5
    while _reader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _reader_threads()


def test_close_from_another_thread_wins_over_the_watchdog(stores):
    """``close()`` from the trainer thread while the prefetcher's staging
    thread consumes the epoch: the producer, which then dies, is never
    restarted, and the consumer sees the shutdown."""
    class Slow(FlakyShardReads):
        def open_shard(self, index, columns=None):
            time.sleep(0.05)
            if self.calls >= 1:
                self.calls += 1
                raise RuntimeError("dies after close")
            self.calls += 1
            return self._store.open_shard(index, columns=columns)

    loader = StreamingClickLogLoader(
        Slow(SessionStore(stores[5]), fail_times=0), batch_size=100,
        seed=0, watchdog_restarts=3, read_ahead=1, log_fn=lambda s: None)
    items = iter(DevicePrefetcher(loader, device="cpu", chunk_batches=1))
    next(items)
    threading.Thread(target=loader.close).start()
    with pytest.raises(RuntimeError):
        for _ in items:
            pass
    assert loader.store.calls <= 3  # no restart after close
    with pytest.raises(RuntimeError, match="closed"):
        next(iter(loader))
    deadline = time.time() + 5
    while _reader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _reader_threads()


def _ubm(cfg):
    return MODEL_REGISTRY["ubm"](
        query_doc_pairs=cfg.n_query_doc_pairs, positions=cfg.positions,
        attraction=EmbeddingParameterConfig(parameters=cfg.n_query_doc_pairs),
        device="cpu")


def test_a_trainer_fed_from_a_store_trains_as_one_fed_from_memory(
        stores, log):
    cfg, data = log
    keys = ("positions", "query_doc_ids", "clicks", "mask")
    runs = []
    for loader in (ClickLogLoader({k: data[k] for k in keys},
                                  batch_size=100, seed=0),
                   StreamingClickLogLoader(stores[1], batch_size=100,
                                           seed=0)):
        model = _ubm(cfg)
        trainer = Trainer(optim.adamw(3e-3, weight_decay=1e-4), epochs=2,
                          chunk_batches=4, device="cpu",
                          log_fn=lambda s: None)
        history = trainer.train(model, loader)
        runs.append(([r["train_loss"] for r in history],
                     [p.detach().clone() for p in model.parameters()]
                     + tree_leaves(trainer._final_state.opt_state)))
    (l0, t0), (l1, t1) = runs
    assert l0 == l1
    for a, b in zip(t0, t1, strict=True):
        assert torch.equal(a, b)


def test_a_preempted_trainer_leaves_no_producer_running(stores, log):
    cfg, _ = log
    loader = KillSwitch(StreamingClickLogLoader(
        stores[5], batch_size=50, seed=0, window_rows=25, read_ahead=2),
        after_batches=5, sig=signal.SIGTERM)
    trainer = Trainer(optim.adamw(3e-3), epochs=1, chunk_batches=2,
                      device="cpu", handle_preemption=True,
                      log_fn=lambda s: None)
    assert trainer.train(_ubm(cfg), loader) == []
    assert loader.fired
    assert 0 < trainer._final_state.global_step < 20
    deadline = time.time() + 5
    while _reader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _reader_threads()
