"""Observability: port against JAX on the CPU.

The port's copies of ``repro.obs.events``, ``sinks`` and ``spans`` and its
ports of the recorder, ``TelemetryDrain`` and ``ProfileWindow`` against
JAX's:

* events, sinks, spans and the recorder behave as JAX's tests pin them;
* the port's own tracing: spans mirrored into a collecting
  ``torch.profiler`` (and no range made while none is), span and parent
  ids per thread in the Chrome trace, detail spans and counters kept out
  of the sinks, one clock whose export agrees with the profiler's, and a
  Trainer's chunk and prefetch spans tagged with matching chunks and
  items;
* ``TelemetryDrain`` accumulates and emits exactly what JAX's does from the
  same per-chunk payloads (scalar and ``(R,)`` sums, skips, extra series);
* the engine's telemetry (``grad_norm``, ``param_norm``, ``lr``) matches
  JAX's at 1e-5 for DBN and UBM, single and R = 2, with the parameters
  equal to the bit to ``telemetry=False``; telemetry on and off never share
  a captured graph;
* a small Trainer run emits JAX's sequence of (kind, name, step, epoch,
  replica), values within 1e-5 (span durations aside), every line valid;
* the profiler window opens and closes at JAX's steps and writes a trace;
* the streaming loader's spans, counters and events equal JAX's;
* the launcher's store path (``--store-dir --ingest``) trains to JAX's
  launcher's records on the same flags at 1e-5, its JSONL valid.
"""
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import obs as jobs
from repro import optim as jopt
from repro.data import StreamingClickLogLoader as JaxStreaming
from repro.data import SessionStore as JaxStore
from repro.launch import train as jax_launch
from repro.testing import FlakyShardReads as JaxFlaky
from repro.train import StepWatchdog as JaxWatchdog
from repro.train import TrainEngine as JaxEngine
from repro.train import Trainer as JaxTrainer
from repro_torch import core as tcore
from repro_torch import obs
from repro_torch import optim
from repro_torch.data import (ClickLogLoader, SessionStore,
                              StreamingClickLogLoader, SyntheticConfig,
                              generate_click_log, split_sessions,
                              write_session_store)
from repro_torch.launch import train as torch_launch
from repro_torch.obs import (ConsoleReporter, JsonlSink, MemorySink,
                             ProfileWindow, Recorder, SpanTracer,
                             TelemetryDrain, make_event, parse_profile_steps,
                             read_jsonl, validate_event)
from repro_torch.obs.telemetry import stage
from repro_torch.testing import FlakyShardReads, corrupt_shard_file
from repro_torch.train import StepWatchdog, TrainEngine, Trainer
from repro_torch.train.capture import ChunkGraphs, tree_leaves

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def log():
    cfg = SyntheticConfig(n_sessions=1200, n_queries=120, docs_per_query=10,
                          positions=6, behavior="dbn", seed=5)
    data, _ = generate_click_log(cfg)
    return cfg, split_sessions(data, (0.8, 0.1, 0.1), seed=5)


def _models(name, cfg):
    def attraction(mod):
        return mod.EmbeddingParameterConfig(
            parameters=cfg.n_query_doc_pairs,
            compression=mod.Compression.HASH, compression_ratio=2.0,
            baseline_correction=True, init_logit=-2.0)

    kw = dict(query_doc_pairs=cfg.n_query_doc_pairs, positions=cfg.positions)
    jm = jcore.MODEL_REGISTRY[name](attraction=attraction(jcore), **kw)
    tm = tcore.MODEL_REGISTRY[name](attraction=attraction(tcore),
                                    device="cpu", **kw)
    return jm, tm


def _chunk(train, n=4, batch=96):
    batches = list(ClickLogLoader(train, batch_size=batch, seed=1))[:n]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _quiet(*_):
    pass


def _strip(e):
    return {k: v for k, v in e.items() if k != "t"}


# -- events, sinks, spans, the recorder ---------------------------------------

EVENT_CASES = [
    ("metric", "train_step", 0.25, dict(step=3, epoch=0)),
    ("event", "quarantine", None, dict(data={"shard": 2})),
    ("span", "epoch", 1.5, dict(epoch=1, replica=0)),
    ("counters", "counters", None, dict(data={"a": 1.0}, step=np.int64(4))),
    ("process", "process", None, dict(data={"rss_bytes": 5})),
    ("epoch", "epoch_record", None, dict(data={"train_loss": 0.5},
                                         shard=np.int32(3),
                                         log_dir="prof", ok=True)),
]


@pytest.mark.parametrize("kind,name,value,fields", EVENT_CASES,
                         ids=[c[1] for c in EVENT_CASES])
def test_make_event_equals_jax(kind, name, value, fields):
    port = make_event(kind, name, value, t=1.0, **fields)
    ref = jobs.make_event(kind, name, value, t=1.0, **fields)
    assert port == ref
    assert validate_event(json.loads(json.dumps(port))) == port


BAD_EVENTS = [
    [], {"kind": "metric", "name": "x"}, {"kind": "nope", "name": "x", "t": 0},
    {"kind": "metric", "name": "", "t": 0},
    {"kind": "metric", "name": "x", "t": "now"},
    {"kind": "metric", "name": "x", "t": 0, "value": "1"},
    {"kind": "metric", "name": "x", "t": 0, "step": 1.5},
    {"kind": "metric", "name": "x", "t": 0, "data": [1]},
    {"kind": "metric", "name": "x", "t": 0, "tags": "a"},
]


@pytest.mark.parametrize("bad", BAD_EVENTS, ids=range(len(BAD_EVENTS)))
def test_validate_event_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        validate_event(bad)
    with pytest.raises(ValueError):
        jobs.validate_event(bad)
    assert obs.EVENT_KINDS == jobs.EVENT_KINDS


def test_sinks_round_trip_and_rate_limit(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = JsonlSink(path, flush_every=2)
    mem = MemorySink()
    lines = []
    console = ConsoleReporter(log_fn=lines.append, every=3)
    rec = Recorder([sink, mem, console])
    for i in range(7):
        rec.metric("loss", float(i), step=i)
    rec.event("quarantine", data={"shard": 1})
    rec.close()
    sink.emit(make_event("metric", "late"))  # after close: dropped
    back = read_jsonl(path)
    assert [_strip(e) for e in back] == [_strip(e) for e in mem.events]
    assert back == jobs.read_jsonl(path)
    assert mem.series("loss") == [float(i) for i in range(7)]
    assert len(mem.by_name("quarantine")) == 1 and len(mem) == 8
    assert len(lines) == 3 + 1  # steps 0, 3, 6 and the event


def test_spans_nest_keep_a_ring_and_export_chrome_traces(tmp_path):
    tracer = SpanTracer(capacity=3)
    with tracer.span("outer", epoch=0):
        with tracer.span("inner"):
            pass
    with pytest.raises(RuntimeError):
        with tracer.span("failing"):
            raise RuntimeError("boom")
    with tracer.span("last"):
        pass
    assert [s.name for s in tracer.spans] == ["outer", "failing", "last"]
    path = str(tmp_path / "trace.json")
    assert tracer.export_chrome_trace(path) == 3
    with open(path) as f:
        trace = json.load(f)
    assert [e["name"] for e in trace["traceEvents"]] == [
        "outer", "failing", "last"]
    assert all(e["ph"] == "X" and e["dur"] >= 0
               for e in trace["traceEvents"])


def test_recorder_counts_gauges_and_forwards_spans():
    off = Recorder()
    assert not off.enabled
    with off.span("x"):
        pass
    off.metric("y", 1.0)
    assert len(off.tracer.spans) == 1
    sink = MemorySink()
    rec = Recorder([sink])
    rec.add("bytes", 10)
    rec.add("bytes", 5)
    rec.gauge("depth", 2)
    with rec.span("read", shard=1):
        pass
    rec.flush_counters(step=3)
    (c,) = sink.by_kind("counters")
    assert c["data"] == {"bytes": 15, "depth:gauge": 2} and c["step"] == 3
    (s,) = sink.by_kind("span")
    assert s["tags"] == {"shard": 1} and s["value"] >= 0


def test_process_stats_are_host_only_without_cuda():
    stats = Recorder().process_stats()
    assert set(stats) == {"rss_bytes"} and stats["rss_bytes"] > 0
    sink = MemorySink()
    Recorder([sink]).process_stats(epoch=0)
    (e,) = sink.by_kind("process")
    assert e["epoch"] == 0 and set(e["data"]) == set(
        jobs.Recorder().process_stats())


def test_recorder_is_thread_safe_under_producer_emits():
    sink = MemorySink()
    rec = Recorder([sink])

    def produce():
        for _ in range(500):
            rec.add("n")
            rec.event("tick")

    threads = [threading.Thread(target=produce) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert rec.counters["n"] == 2000 and len(sink) == 2000


def test_global_recorder_configure_and_restore():
    before = obs.get_recorder()
    try:
        sink = MemorySink()
        rec = obs.configure(sinks=[sink])
        assert obs.get_recorder() is rec
        with obs.span("global"):
            pass
        assert sink.by_name("global")
    finally:
        obs.set_recorder(before)


# -- the port's own tracing: profiler mirror, ids, detail spans, clock -------

def test_span_mirrors_into_a_collecting_profiler_only(monkeypatch):
    import torch.autograd.profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    made = []
    real = autograd_profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(autograd_profiler, "record_function", counting)
    rec = Recorder()
    with rec.span("unprofiled", detail=True):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("serve_bulk", detail=True, call=0):
            with rec.span("serve_bulk.copy_in", detail=True):
                pass
        with rec.span("epoch", epoch=0):
            pass
    assert made == ["serve_bulk", "serve_bulk.copy_in", "epoch"]
    names = [e.name for e in prof.events()]
    for name in made:
        assert names.count(name) == 1
    assert "unprofiled" not in names
    with rec.span("after", detail=True):
        pass
    assert len(made) == 3 and len(rec.tracer.spans) == 5


def test_span_ids_nest_per_thread_and_the_export_carries_them(tmp_path):
    rec = Recorder()
    ready = threading.Barrier(2)

    def work(tag):
        with rec.span("outer", detail=True, item=tag):
            ready.wait()  # both threads hold an open span at once
            with rec.span("inner", detail=True):
                with rec.span("coarse", shard=tag):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = list(rec.tracer.spans)
    by_id = {s.span_id: s for s in spans}
    assert len(by_id) == 6 and all(s.span_id > 0 for s in spans)
    for s in spans:
        if s.name == "outer":
            assert s.parent_id is None
            continue
        parent = by_id[s.parent_id]
        assert parent.thread_id == s.thread_id
        assert parent.name == {"inner": "outer", "coarse": "inner"}[s.name]
        if s.name == "inner":  # a detail span takes its parent's request
            assert s.tags == {"item": parent.tags["item"]}
        else:  # a coarse span keeps its tags as given
            assert s.tags == {"shard": by_id[parent.parent_id].tags["item"]}
    path = str(tmp_path / "trace.json")
    assert rec.export_chrome_trace(path) == 6
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    for e, s in zip(events, spans):
        assert e["args"]["span_id"] == s.span_id
        assert e["args"]["parent_id"] == s.parent_id
        assert e["tid"] == s.thread_id
        assert e["cat"] == ("clax" if s.name == "coarse" else "clax.detail")


def test_spans_and_detail_counters_from_many_threads_lose_nothing():
    """More threads than cores, switching as often as the interpreter
    allows: every span gets its own id and its own thread's parent, and no
    detail count is lost."""
    rec = Recorder(span_capacity=100_000)
    threads_n, each = 4 * (os.cpu_count() or 1), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(each):
                with rec.span("outer", detail=True, item=t):
                    with rec.span("inner", detail=True):
                        rec.add("n", detail=True)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = list(rec.tracer.spans)
    by_id = {s.span_id: s for s in spans}
    assert len(spans) == len(by_id) == 2 * threads_n * each
    assert rec.detail_snapshot() == {"n": threads_n * each}
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent_id]
            assert parent.name == "outer"
            assert parent.thread_id == s.thread_id
            assert s.tags["item"] == parent.tags["item"]
        else:
            assert s.parent_id is None


def test_detail_spans_and_counters_reach_the_ring_not_the_sinks(tmp_path):
    sink = MemorySink()
    rec = Recorder([sink])
    with rec.span("serve_bulk", detail=True, call=7):
        with rec.span("serve_batch", model="dbn"):
            pass
    rec.add("serve_bulk.calls", detail=True)
    rec.add("serve_bulk.bytes_in", 40, detail=True)
    rec.add("stream.sessions", 5)
    rec.flush_counters()
    assert [s.name for s in rec.tracer.spans] == ["serve_batch",
                                                  "serve_bulk"]
    assert [e["name"] for e in sink.by_kind("span")] == ["serve_batch"]
    (c,) = sink.by_kind("counters")
    assert c["data"] == {"stream.sessions": 5}
    assert rec.detail_snapshot() == {"serve_bulk.calls": 1,
                                     "serve_bulk.bytes_in": 40}
    path = str(tmp_path / "trace.json")
    assert rec.export_chrome_trace(path) == 5
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert {e["name"]: e["args"]["value"] for e in events
            if e["ph"] == "C"} == {"serve_bulk.calls": 1,
                                   "serve_bulk.bytes_in": 40,
                                   "stream.sessions": 5}


def test_spans_keep_one_clock_and_export_epoch_microseconds(tmp_path):
    """Starts and lengths from ``perf_counter``; the export adds the one
    offset taken when the tracer was made, so a span's exported start is
    where the profiler's own export puts the range it opened."""
    import time

    from torch.profiler import ProfilerActivity, profile

    rec = Recorder()
    before = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("train.chunk", detail=True, chunk=0):
            time.sleep(0.002)
    (s,) = rec.tracer.spans
    assert before <= s.t_start <= time.perf_counter()
    assert s.duration >= 0.002
    assert rec.tracer.wall(s.t_start) == pytest.approx(time.time(), abs=5.0)
    ours = rec.tracer.chrome_trace()["traceEvents"][0]["ts"]
    path = str(tmp_path / "prof.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        exported = json.load(f)
    base_us = exported.get("baseTimeNanoseconds", 0) / 1e3
    (theirs,) = [e["ts"] + base_us for e in exported["traceEvents"]
                 if e.get("name") == "train.chunk" and e.get("ph") == "X"]
    assert abs(ours - theirs) < 1000.0  # within 1 ms
    # a staging thread's span that starts later exports later

    def stage():
        with rec.span("prefetch.pin", detail=True):
            pass

    t = threading.Thread(target=stage)
    t.start()
    t.join()
    a, b = rec.tracer.chrome_trace()["traceEvents"]
    assert b["ts"] >= a["ts"] + a["dur"] and b["tid"] != a["tid"]


def test_trainer_records_chunk_and_prefetch_spans_with_matching_tags(log):
    cfg, (train, _, _) = log
    _, tm = _models("dbn", cfg)
    rec = Recorder()
    trainer = Trainer(optim.adamw(0.05), epochs=1, chunk_batches=2,
                      device="cpu", recorder=rec, log_fn=_quiet)
    loader = ClickLogLoader(train, batch_size=96, seed=0)
    trainer.train(tm, loader)
    spans = list(rec.tracer.spans)
    by_id = {s.span_id: s for s in spans}
    chunks = [s for s in spans if s.name == "train.chunk"]
    worked = [c for c in chunks if "n" in c.tags]
    n_batches = loader.batches_per_epoch
    assert [c.tags["n"] for c in worked] == [2] * (n_batches // 2) + (
        [1] if n_batches % 2 else [])
    # chunk = the chunk's first global step; the end of input is a chunk
    # span of its own, with no n
    assert [c.tags["chunk"] for c in chunks] == [
        2 * i for i in range(len(worked))] + [n_batches]
    for i, c in enumerate(chunks):
        kids = sorted((s for s in spans if s.parent_id == c.span_id),
                      key=lambda s: s.t_start)
        want = ["train.wait_input"] if c not in worked else (
            ["train.wait_input", "train.step"]
            + (["train.drain"] if i > 0 else []))
        assert [k.name for k in kids] == want
        assert kids[0].tags == {"item": i, "chunk": c.tags["chunk"]}
        assert all(k.tags["chunk"] == c.tags["chunk"] for k in kids)
        assert all(k.thread_id == c.thread_id for k in kids)
    (last_drain,) = [s for s in spans if s.name == "train.drain"
                     and by_id[s.parent_id].name == "epoch"]
    assert last_drain.tags == {"chunk": worked[-1].tags["chunk"]}
    # the staging thread built item k of the chunk that waited for item k
    staged = [s for s in spans if s.name.startswith("prefetch.")]
    assert {s.thread_id for s in staged} != {chunks[0].thread_id}
    for name in ("prefetch.pin", "prefetch.copy"):
        assert sorted(s.tags["item"] for s in spans if s.name == name) == \
            list(range(len(worked)))
    batches = [s.tags["item"] for s in spans if s.name == "prefetch.batch"]
    for k, c in enumerate(worked):
        assert batches.count(k) == c.tags["n"]
    assert {s.name for s in staged} <= {"prefetch.batch", "prefetch.pin",
                                        "prefetch.copy",
                                        "prefetch.queue_full"}
    assert rec.detail_snapshot() == {
        "train.chunks": len(worked), "prefetch.items": len(worked),
        "prefetch.bytes": sum(v[:n_batches * 96].nbytes
                              for k, v in train.items()
                              if k in loader.data)}


def test_inline_prefetcher_records_its_spans_on_the_consumer():
    from repro_torch.data import DevicePrefetcher

    data = {"clicks": np.zeros((40, 3), np.float32)}
    rec = Recorder()
    items = list(DevicePrefetcher(ClickLogLoader(data, batch_size=10),
                                  device="cpu", chunk_batches=2,
                                  overlap=False, recorder=rec))
    assert len(items) == 2
    names = [s.name for s in rec.tracer.spans]
    assert "prefetch.queue_full" not in names
    assert {s.thread_id for s in rec.tracer.spans} == {
        threading.get_ident()}
    assert sorted(s.tags["item"] for s in rec.tracer.spans
                  if s.name == "prefetch.pin") == [0, 1]
    assert rec.detail_snapshot() == {"prefetch.items": 2,
                                     "prefetch.bytes": 40 * 3 * 4}


# -- the drain -----------------------------------------------------------------

def _payload(case, n=5, R=2):
    rng = np.random.default_rng(0)
    shape = (n,) if "replicas" not in case else (n, R)
    out = {"loss": rng.normal(size=shape).astype(np.float32)}
    if "skipped" in case:
        out["skipped"] = rng.random(shape) < 0.3
    if "extras" in case:
        out["grad_norm"] = rng.random(shape).astype(np.float32)
        out["param_norm"] = rng.random(shape).astype(np.float32)
        out["lr"] = np.full(shape, 0.01, np.float32)
    return out


DRAIN_CASES = ["scalar", "scalar_skipped", "scalar_extras",
               "replicas", "replicas_skipped_extras"]


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("case", DRAIN_CASES)
def test_drain_accumulates_and_emits_as_jax(case, every):
    R = 2 if "replicas" in case else None
    sinks = MemorySink(), jobs.MemorySink()
    port = TelemetryDrain(replicas=R, recorder=Recorder([sinks[0]]),
                          every=every, epoch=1)
    ref = jobs.TelemetryDrain(replicas=R, recorder=jobs.Recorder([sinks[1]]),
                              every=every, epoch=1)
    for c, seed_step in enumerate((0, 5, 10)):
        payload = _payload(case)
        payload["loss"] = payload["loss"] + np.float32(c)
        port.drain(stage({k: torch.from_numpy(v)
                          for k, v in payload.items()}), seed_step)
        host = payload if len(payload) > 1 else payload["loss"]
        ref.drain(host, first_step=seed_step)
    assert port.n_batches == ref.n_batches == 15
    assert port.aux() == ref.aux()
    assert np.array_equal(np.asarray(port.mean_loss()),
                          np.asarray(ref.mean_loss()))
    assert [_strip(e) for e in sinks[0].events] == [
        _strip(e) for e in sinks[1].events]
    if R is None:  # a Python float, loss by loss, round-tripping JSON
        assert isinstance(port.aux()["train_loss"], float)
    resumed = TelemetryDrain(replicas=R)
    resumed.load(json.loads(json.dumps(port.aux())))
    assert resumed.aux() == port.aux()


# -- the engine ----------------------------------------------------------------

ENGINE_CASES = [("dbn", None, {}), ("ubm", None, {}), ("dbn", 2, {}),
                ("ubm", 2, {}),
                ("dbn", None, dict(nonfinite_guard=True)),
                ("dbn", None, dict(sparse_tables=True, sparse_table_kwargs=dict(
                    lr=0.05, weight_decay=1e-4)))]


@pytest.mark.parametrize("name,replicas,kw", ENGINE_CASES,
                         ids=["dbn", "ubm", "dbn_r2", "ubm_r2", "dbn_guard",
                              "dbn_sparse"])
def test_engine_telemetry_matches_jax_and_keeps_the_bits(log, name, replicas,
                                                         kw):
    cfg, (train, _, _) = log
    chunk = _chunk(train)
    if kw.get("nonfinite_guard"):
        chunk["clicks"][2] = np.nan  # the third step skips
    lrs = [0.05, 0.02]
    inject = replicas is not None
    jm, _ = _models(name, cfg)
    jeng = JaxEngine(jm, jopt.adamw(0.05, weight_decay=1e-4,
                                    inject_lr=inject),
                     chunk_batches=4, replicas=replicas, telemetry=True,
                     **kw)
    if replicas is None:
        jparams = jm.init(jax.random.PRNGKey(0))
        jstate = jeng.init_opt_state(jparams)
    else:
        jparams = jeng.init_replica_params([0, 1])
        jstate = jeng.set_replica_lrs(jeng.init_opt_state(jparams), lrs)
    _, _, jout = jeng.step(jparams, jstate, chunk)
    jout = jax.device_get(jout)

    runs = []
    for telemetry in (False, True):
        _, tm = _models(name, cfg)
        eng = TrainEngine(tm, optim.adamw(0.05, weight_decay=1e-4,
                                          inject_lr=inject),
                          chunk_batches=4, replicas=replicas,
                          telemetry=telemetry, **kw)
        if replicas is None:
            state = eng.init_opt_state()
        else:
            eng.init_replica_params([0, 1])
            state = eng.set_replica_lrs(eng.init_opt_state(), lrs)
        state, out = eng.step(state, {k: torch.from_numpy(v)
                                      for k, v in chunk.items()})
        leaves = (eng.replica_params if replicas is not None
                  else list(tm.parameters()))
        runs.append((out, [t.detach().clone() for t in leaves]))
    (off, p_off), (on, p_on) = runs
    for a, b in zip(p_off, p_on, strict=True):
        assert torch.equal(a, b)
    want = {"loss", "grad_norm", "param_norm"} | (
        {"lr"} if inject else set()) | (
        {"skipped"} if kw.get("nonfinite_guard") else set())
    assert set(on) == set(jout) == want
    loss_off = off["loss"] if isinstance(off, dict) else off
    np.testing.assert_array_equal(on["loss"].numpy(), loss_off.numpy())
    shape = (4,) if replicas is None else (4, replicas)
    for key in want - {"loss", "skipped"}:
        assert tuple(on[key].shape) == shape
        np.testing.assert_allclose(on[key].numpy(), jout[key], rtol=REL,
                                   err_msg=key)
    if "skipped" in want:
        np.testing.assert_array_equal(on["skipped"].numpy(), jout["skipped"])


FROZEN_CASES = {
    "dense": {},
    "dense_guard": dict(nonfinite_guard=True),
    "sparse": dict(sparse_tables=True, sparse_table_kwargs=dict(
        lr=0.05, weight_decay=1e-4)),
    "sparse_guard": dict(nonfinite_guard=True, sparse_tables=True,
                         sparse_table_kwargs=dict(lr=0.05,
                                                  weight_decay=1e-4)),
    "dense_lr_schedule": {},   # per-replica lrs retuned between the chunks
    "dense_scheduled_optimizer": {},   # adamw over a cosine schedule
}


@pytest.mark.parametrize("case", list(FROZEN_CASES))
def test_frozen_replica_reports_its_would_be_update_as_jax(log, case):
    """ROADMAP C.4: a sweep's frozen replica reports the ``param_norm`` (and
    ``lr``) of the update it would make, as JAX's vmapped step takes its
    telemetry before the active mask, with the guard's ``ok`` applied; its
    parameters, moments and count stay as they were, to the bit. One chunk
    all active, then a chunk with replica 1 frozen (R = 2, DBN)."""
    cfg, (train, _, _) = log
    kw = FROZEN_CASES[case]
    batches = list(ClickLogLoader(train, batch_size=96, seed=1))[:8]
    chunks = [{k: np.stack([b[k] for b in batches[i:i + 4]])
               for k in batches[0]} for i in (0, 4)]
    if kw.get("nonfinite_guard"):
        chunks[1]["clicks"][2] = np.nan  # the frozen chunk's third step skips
    sparse = "sparse" in case
    lrs = [[0.05, 0.02], [0.03, 0.01] if case == "dense_lr_schedule"
           else [0.05, 0.02]]

    def optimizer(mod):
        if case == "dense_scheduled_optimizer":
            return mod.adamw(mod.cosine_decay(0.05, 6, alpha=0.1),
                             weight_decay=1e-4)
        return mod.adamw(0.05, weight_decay=1e-4, inject_lr=not sparse)

    jm, tm = _models("dbn", cfg)
    jeng = JaxEngine(jm, optimizer(jopt), chunk_batches=4, replicas=2,
                     telemetry=True, **kw)
    jparams = jeng.init_replica_params([0, 1])
    jstate = jeng.init_opt_state(jparams)
    eng = TrainEngine(tm, optimizer(optim), chunk_batches=4, replicas=2,
                      telemetry=True, **kw)
    eng.init_replica_params([0, 1])
    state = eng.init_opt_state()
    outs = []
    for c, (chunk, active) in enumerate(zip(chunks, ([True, True],
                                                     [True, False]))):
        if case.startswith("dense") and "scheduled" not in case:
            jstate = jeng.set_replica_lrs(jstate, lrs[c])
            eng.set_replica_lrs(state, lrs[c])
        jparams, jstate, jout = jeng.step(jparams, jstate, chunk,
                                          active=np.asarray(active))
        if c == 1:
            frozen = [t[1].clone() for t in eng.replica_params
                      + tree_leaves(state)]
        state, out = eng.step(state, {k: torch.from_numpy(v)
                                      for k, v in chunk.items()},
                              active=active)
        outs.append((out, jax.device_get(jout)))
    for t, before in zip(eng.replica_params + tree_leaves(state), frozen,
                         strict=True):
        assert torch.equal(t[1], before)
    for out, jout in outs:
        assert set(out) == set(jout)
        for key in set(out) - {"skipped"}:
            np.testing.assert_allclose(out[key].numpy(), jout[key],
                                       rtol=REL, err_msg=key)
        if "skipped" in out:
            np.testing.assert_array_equal(out["skipped"].numpy(),
                                          jout["skipped"])
    # the frozen replica's would-be update is not its frozen parameters
    frozen_norm = float(torch.sqrt(sum(torch.sum(t[1].double() ** 2)
                                       for t in eng.replica_params)))
    assert abs(float(outs[1][0]["param_norm"][-1, 1]) - frozen_norm) > 1e-4


class _StandIn:
    """Stand-in graphs: a replay runs the captured body over the static
    buffers."""

    class Graph:
        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            self.fn()

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        return self.Graph(fn)

    def kernels(self, graph):
        return {}


def _in_place(opt):
    """``opt`` with its state updated in place, as its fused pass on the
    card does (a captured chunk refuses an optimizer that makes new
    state)."""
    def update(grads, state, params=None):
        updates, new = opt.update(grads, state, params)
        for a, b in zip(tree_leaves(state), tree_leaves(new), strict=True):
            if a is not b:
                a.copy_(b)
        return updates, state
    return opt._replace(update=update)


def test_telemetry_on_and_off_never_share_a_graph(log):
    cfg, (train, _, _) = log
    _, tm = _models("dbn", cfg)
    eng = TrainEngine(tm, _in_place(optim.adamw(0.05)), chunk_batches=4)
    state = eng.init_opt_state()
    eng.graphs = ChunkGraphs(eng._chunk_body, backend=_StandIn())
    chunk = {k: torch.from_numpy(v) for k, v in _chunk(train).items()}
    _, out = eng._replayed(state, chunk)
    assert isinstance(out, torch.Tensor)
    eng.telemetry = True
    _, out = eng._replayed(state, chunk)
    assert {"grad_norm", "param_norm"} <= set(out)
    _, out = eng._replayed(state, chunk)  # a replay of the telemetry graph
    assert {"grad_norm", "param_norm"} <= set(out)
    eng.telemetry = False
    _, out = eng._replayed(state, chunk)
    assert isinstance(out, torch.Tensor)
    assert (eng.graphs.captures, eng.graphs.replays) == (2, 2)


# -- the Trainer's event stream -----------------------------------------------

def _key(e):
    return (e["kind"], e["name"], e.get("step"), e.get("epoch"),
            e.get("replica"))


@pytest.mark.parametrize("replicas", [None, 2])
def test_trainer_event_stream_equals_jax(tmp_path, log, replicas):
    cfg, (train, val, _) = log
    jm, tm = _models("dbn", cfg)
    lrs = [0.05, 0.02] if replicas else None

    def loaders():
        return (ClickLogLoader(train, batch_size=96, seed=0),
                ClickLogLoader(val, batch_size=64, shuffle=False,
                               drop_last=False))

    common = dict(epochs=2, patience=5, chunk_batches=4, telemetry=True,
                  checkpoint_every_steps=4, replicas=replicas,
                  replica_lrs=lrs, log_fn=_quiet, obs_every=1)
    sinks = MemorySink(), jobs.MemorySink()
    port = Trainer(optim.adamw(0.05, weight_decay=1e-4,
                               inject_lr=bool(replicas)),
                   device="cpu", recorder=Recorder([sinks[0]]),
                   checkpoint_dir=str(tmp_path / "p"), **common)
    ref = JaxTrainer(jopt.adamw(0.05, weight_decay=1e-4,
                                inject_lr=bool(replicas)),
                     recorder=jobs.Recorder([sinks[1]]),
                     checkpoint_dir=str(tmp_path / "j"), **common)
    port.train(tm, *loaders())
    ref.train(jm, *loaders())
    got, want = sinks[0].events, sinks[1].events
    assert [_key(e) for e in got] == [_key(e) for e in want]
    for e in got:
        validate_event(json.loads(json.dumps(e)))
    for a, b in zip(got, want):
        if a["kind"] == "metric":
            np.testing.assert_allclose(a["value"], b["value"], rtol=REL)
            assert set(a["data"]) == set(b["data"])
            for k in a["data"]:
                np.testing.assert_allclose(a["data"][k], b["data"][k],
                                           rtol=REL, err_msg=k)
        elif a["kind"] == "epoch":
            rec_a, rec_b = a["data"], b["data"]
            assert set(rec_a) == set(rec_b)
            for k in rec_a:
                if k != "seconds":
                    np.testing.assert_allclose(rec_a[k], rec_b[k], rtol=REL,
                                               err_msg=k)
        elif a["kind"] in ("span", "process"):
            assert a.get("tags") == b.get("tags")


def test_watchdog_violation_event_equals_jax():
    sinks = MemorySink(), jobs.MemorySink()
    for wd in (StepWatchdog(0.01, recorder=Recorder([sinks[0]])),
               JaxWatchdog(0.01, recorder=jobs.Recorder([sinks[1]]))):
        wd.check(0.005, step=4)
        wd.check(0.5, step=8)
        assert wd.violations == 1
    assert [_strip(e) for e in sinks[0].events] == [
        _strip(e) for e in sinks[1].events]


# -- the profiler window -------------------------------------------------------

def test_parse_profile_steps_refuses_what_jax_refuses():
    assert parse_profile_steps("10:20") == jobs.parse_profile_steps(
        "10:20") == (10, 20)
    for bad in ("10", "20:10", "a:b", "-1:5", "1:2:3"):
        with pytest.raises(ValueError):
            parse_profile_steps(bad)
        with pytest.raises(ValueError):
            jobs.parse_profile_steps(bad)


@pytest.mark.parametrize("window,chunk", [((8, 16), 4), ((2, 5), 2),
                                          ((0, 100), 4), ((5, 6), 3)])
def test_profile_window_opens_and_closes_at_jax_steps(tmp_path, monkeypatch,
                                                      window, chunk):
    import jax.profiler

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    sinks = MemorySink(), jobs.MemorySink()
    prof = str(tmp_path / "prof")
    port = ProfileWindow(*window, log_dir=prof, recorder=Recorder([sinks[0]]))
    ref = jobs.ProfileWindow(*window, log_dir=prof,
                             recorder=jobs.Recorder([sinks[1]]))
    for w in (port, ref):
        for step in range(0, 24, chunk):
            w.before_chunk(step)
            w.after_chunk(step + chunk)
        w.close(24)
    assert [_strip(e) for e in sinks[0].events] == [
        _strip(e) for e in sinks[1].events]
    assert [e["name"] for e in sinks[0].events] == ["profile_start",
                                                    "profile_stop"]
    with open(port.path) as f:
        json.load(f)


def test_profile_window_around_a_trainer_run(tmp_path, log):
    cfg, (train, _, _) = log
    _, tm = _models("ubm", cfg)
    sink = MemorySink()
    trainer = Trainer(optim.adamw(0.05), epochs=1, chunk_batches=2,
                      device="cpu", recorder=Recorder([sink]),
                      profile_steps="2:5", profile_dir=str(tmp_path / "p"),
                      log_fn=_quiet)
    trainer.train(tm, ClickLogLoader(train, batch_size=96, seed=0))
    (start,), (stop,) = (sink.by_name("profile_start"),
                         sink.by_name("profile_stop"))
    assert (start["step"], stop["step"]) == (2, 6)
    (trace,) = os.listdir(str(tmp_path / "p"))
    with open(os.path.join(str(tmp_path / "p"), trace)) as f:
        assert json.load(f)["traceEvents"]


# -- the streaming data plane --------------------------------------------------

@pytest.fixture()
def store_dir(tmp_path, log):
    _, (train, _, _) = log
    where = str(tmp_path / "store")
    write_session_store(train, where, shard_rows=240, codec="auto")
    return where


def _counters(rec):
    return {k: v for k, v in rec.counters_snapshot().items()
            if k != "stream.queue_stall_s" and not k.endswith(":gauge")}


STREAM_CASES = ["clean", "flaky", "quarantine", "restart"]


@pytest.mark.parametrize("case", STREAM_CASES)
def test_streaming_telemetry_equals_jax(store_dir, case):
    if case == "quarantine":
        corrupt_shard_file(store_dir, shard=1, column="clicks", seed=1)
    kw = dict(batch_size=50, seed=3, verify_checksums=True,
              log_fn=_quiet, io_retry_backoff=0.001)
    if case == "quarantine":
        kw["corrupt_policy"] = "skip"
    if case == "flaky":
        kw["io_retries"] = 3
    if case == "restart":
        kw.update(io_retries=0, watchdog_restarts=1)
    fails = {"flaky": 2, "restart": 1}.get(case, 0)
    sinks = MemorySink(), jobs.MemorySink()
    recs = Recorder([sinks[0]]), jobs.Recorder([sinks[1]])
    port = StreamingClickLogLoader(
        FlakyShardReads(SessionStore(store_dir), fail_times=fails),
        recorder=recs[0], **kw)
    ref = JaxStreaming(JaxFlaky(JaxStore(store_dir), fail_times=fails),
                       recorder=recs[1], **kw)
    assert len(list(port)) == len(list(ref)) > 0
    assert _counters(recs[0]) == _counters(recs[1])

    def shape(sink):
        out = []
        for e in sink.events:
            data = {k: v for k, v in e.get("data", {}).items()
                    if k != "error"}
            out.append((e["kind"], e["name"], e.get("tags"), data))
        return sorted(out, key=repr)

    assert shape(sinks[0]) == shape(sinks[1])
    names = {e["name"] for e in sinks[0].events}
    assert "shard_read" in names and "crc_verify" in names
    assert {"flaky": "io_retry_wait", "quarantine": "quarantine",
            "restart": "watchdog_restart", "clean": "shard_read"}[case] in names


# -- the launcher --------------------------------------------------------------

def _records(lines):
    import ast

    return [ast.literal_eval(line[len("[trainer] "):]) for line in lines
            if line.startswith("[trainer] {")]


def test_launcher_store_path_trains_to_jax_records(tmp_path, capsys,
                                                   monkeypatch):
    flags = ["--sessions", "3000", "--epochs", "2", "--batch", "256",
             "--chunk-batches", "4", "--ingest", "--chunk-sessions", "300",
             "--shard-rows", "500", "--store-codec", "auto",
             "--obs-every", "2"]
    port_metrics = str(tmp_path / "p.jsonl")
    trace = str(tmp_path / "trace.json")
    results = torch_launch.main(flags + [
        "--store-dir", str(tmp_path / "ps"), "--device", "cpu",
        "--metrics-out", port_metrics, "--trace-out", trace])
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + flags + [
        "--store-dir", str(tmp_path / "js"), "--metrics-out",
        str(tmp_path / "j.jsonl")])
    jax_recorder = jobs.get_recorder()
    try:
        jax_launch.main()
    finally:  # JAX's launcher leaves its recorder configured
        jobs.set_recorder(jax_recorder)
    jax_out = capsys.readouterr().out.splitlines()
    mine, theirs = _records(port_out), _records(jax_out)
    assert len(mine) == len(theirs) == 2
    for a, b in zip(mine, theirs):
        for k in ("train_loss", "val_ll", "val_ppl", "val_cond_ppl"):
            np.testing.assert_allclose(a[k], b[k], rtol=REL, err_msg=k)
    assert all(np.isfinite(results[k]) for k in ("ll", "ppl", "cond_ppl"))
    events = read_jsonl(port_metrics)
    ref_events = jobs.read_jsonl(str(tmp_path / "j.jsonl"))
    assert sorted({(e["kind"], e["name"]) for e in events} - {
        ("roofline", "chunk_step")}) == sorted({(e["kind"], e["name"])
                                                for e in ref_events})
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert obs.get_recorder().sinks == []  # the launcher restored it
