"""``configs.clax_baidu.serve_bulk``'s pinned staging (``data.staging``)
on the CPU: the pinned allocator stood in by plain tensors filled with a
sentinel (so a byte no piece reaches shows) and the card's events by
stand-ins that log their waits, injected as the model's staging. The
pieces cover every byte; the answers equal the pageable route's to the
bit, are the caller's own and outlive later calls; the counters count
calls and one staging set a shape; a fill waits for the copies out of the
set before it."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import core, obs
from repro_torch.configs import clax_baidu
from repro_torch.data import staging
from repro_torch.configs.clax_baidu import serve_bulk

K, PAIRS = 10, 500
CPU = torch.device("cpu")


class _Done:
    """A stand-in event: its wait is logged."""

    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append("wait")


class _Stand:
    """The pinned allocator and the event recorder, stood in: every
    allocation is kept (filled with 7) and every record and wait logged."""

    def __init__(self):
        self.made, self.log = [], []

    def pinned(self, shape, dtype):
        self.made.append(torch.full(shape, 7, dtype=dtype))
        return self.made[-1]

    def mark(self, device):
        assert device == CPU
        self.log.append("mark")
        return _Done(self.log)

    def staging(self):
        return staging.PinnedStaging(pinned=self.pinned, mark=self.mark)


@pytest.fixture()
def recorder():
    """A fresh global recorder for the test, the old one put back."""
    before = obs.get_recorder()
    try:
        yield obs.set_recorder(obs.Recorder())
    finally:
        obs.set_recorder(before)


def _model(seed=0):
    """A small DBN with its parameters moved off their constant init, so
    every session scores its own."""
    model = core.MODEL_REGISTRY["dbn"](query_doc_pairs=PAIRS, positions=K,
                                       device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, dtype=p.dtype))
    return model


def _batch(rows, seed):
    rng = np.random.default_rng(seed)
    return {"positions": np.tile(np.arange(1, K + 1, dtype=np.int32),
                                 (rows, 1)),
            "query_doc_ids": rng.integers(0, PAIRS, (rows, K)).astype(
                np.int32),
            "mask": rng.random((rows, K)) < 0.8}


def _pin(model):
    """Serve ``model`` through stood-in pinned staging; the stand."""
    stand = _Stand()
    staging._STAGING[model] = stand.staging()
    return stand


@pytest.mark.parametrize("rows, piece", [(37, 64), (3, 1 << 20), (37, 3),
                                         (64, 640)],
                         ids=["not_a_multiple", "under_one_piece",
                              "piece_under_an_element", "a_multiple"])
def test_the_pieces_cover_every_byte(monkeypatch, rows, piece):
    """int32 and bool arrays, whether or not a piece divides them, in
    pieces larger than the batch or smaller than an element: the staging
    set and the device tensors hold every byte of the batch."""
    monkeypatch.setattr(staging, "PIECE_BYTES", piece)
    stand = _Stand()
    host = _batch(rows, seed=rows)
    inputs, allocated = stand.staging().copy_in(host, CPU)
    assert allocated and stand.log == ["mark"]
    assert [tuple(b.shape) for b in stand.made] == [(rows, K)] * 3
    for (k, v), staged in zip(host.items(), stand.made):
        want = torch.from_numpy(v)
        assert inputs[k].dtype == staged.dtype == want.dtype
        assert torch.equal(staged, want), k
        assert torch.equal(inputs[k], want), k


def test_a_non_contiguous_batch_is_served_as_its_contiguous_copy(
        monkeypatch, recorder):
    monkeypatch.setattr(staging, "PIECE_BYTES", 100)
    model = _model()
    wide = _batch(96, seed=1)
    batch = {"positions": np.asfortranarray(wide["positions"][:48]),
             "query_doc_ids": wide["query_doc_ids"][::2],
             "mask": wide["mask"][1::2]}
    assert not any(v.flags.c_contiguous for v in batch.values())
    want = serve_bulk(model, batch)  # the CPU's route: no staging
    _pin(model)
    got = serve_bulk(model, batch)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_an_answer_is_the_callers_own_and_outlives_later_calls(
        monkeypatch, recorder):
    monkeypatch.setattr(staging, "PIECE_BYTES", 96)
    model = _model()
    batches = [_batch(40, seed=s) for s in range(4)]
    want = [serve_bulk(model, b) for b in batches]
    assert want[0].tobytes() != want[1].tobytes()
    _pin(model)
    got = [serve_bulk(model, b) for b in batches]  # three calls after the 1st
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    for i in range(len(got)):
        for j in range(i):
            assert not np.shares_memory(got[i], got[j])


def test_counters_count_the_calls_and_one_staging_set_a_shape(recorder):
    """Three calls, a new shape, then it again: one set a shape; every
    fill after the first waits for the copies out of the set (its event),
    every answer for the device."""
    model = _model()
    stand = _pin(model)
    for rows in (40, 40, 40, 24, 24):
        serve_bulk(model, _batch(rows, seed=rows))
    counters = recorder.detail_snapshot()
    assert counters["serve_bulk.calls"] == 5
    assert counters["serve_bulk.pinned_calls"] == 5
    assert counters["serve_bulk.pinned_allocs"] == 2
    sets = [tuple(b.shape) for b in stand.made if b.dtype == torch.bool]
    assert sets == [(40, K), (24, K)]
    call = ["mark", "mark", "wait"]  # the copy in's event, the answer's
    assert stand.log == call + (["wait"] + call) * 4
    spans = list(recorder.tracer.spans)
    for c in (s for s in spans if s.name == "serve_bulk"):
        assert [s.name for s in spans if s.parent_id == c.span_id] == [
            "serve_bulk.copy_in", "serve_bulk.predict", "serve_bulk.copy_out"]


def test_the_cpu_route_takes_no_staging(recorder):
    model = _model()
    serve_bulk(model, _batch(16, seed=0))
    assert model not in staging._STAGING
    assert set(recorder.detail_snapshot()) == {
        "serve_bulk.calls", "serve_bulk.sessions", "serve_bulk.bytes_in",
        "serve_bulk.bytes_out"}


def test_callers_on_threads_share_the_staging_set(monkeypatch, recorder):
    """Eight threads serve their own batches through one model's set, with
    the interpreter switching threads every microsecond: each answer is
    its batch's (a fill of one call between another's fill and copy would
    score the wrong sessions). Pieces of 4 bytes give the threads many
    places to interleave."""
    monkeypatch.setattr(staging, "PIECE_BYTES", 4)
    model = _model()
    batches = [_batch(32, seed=s) for s in range(8)]
    want = [serve_bulk(model, b) for b in batches]
    _pin(model)
    got, errors = [None] * len(batches), []

    def serve(i):
        try:
            for _ in range(5):
                got[i] = serve_bulk(model, batches[i])
        except Exception as exc:  # raised on the test's thread below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert recorder.detail_snapshot()["serve_bulk.pinned_calls"] == 40
