"""The per-layer metrics that read the program's own spans and counters:
each reader on a hand-built trace (a known answer, and None where the
program put no spans there, as a program without them gives), the
readers on a CPU profile of the program itself, ``serve_bulk``'s
counters against the batch, and the program's results equal to the bit
with a profiler collecting and without."""
import numpy as np
import pytest
import torch

import run
import tiny
from loops.serve_bulk import served_batches
from yardstick import inputs
from yardstick.trace import MARK, Trace

SEED = 3_000_000_019
MAIN, STAGING = 1, 2
SERVE = "clax-dbn-baidu.serve_bulk"
TRAIN = "clax-dbn-baidu.train"
READERS = ["serve_copy_in_gb_per_s", "serve_enqueue_ms_per_call",
           "serve_idle_in_call_pct", "input_wait_ms_per_step",
           "prefetch_pin_ms_per_step", "drain_wait_ms_per_step"]


@pytest.fixture()
def recorder():
    """A fresh global recorder for the test, the old one put back."""
    from repro_torch import obs

    before = obs.get_recorder()
    try:
        yield obs.set_recorder(obs.Recorder())
    finally:
        obs.set_recorder(before)


def _serve_trace():
    """Two calls in a window of 1 s: each 0.2 s, its copy in 0.05 s and
    its enqueue 0.05 s, the device busy 0.13 s of it; a host op between
    calls and another thread's span that are no call's."""
    host, device = [], []
    for t0 in (0.1, 0.5):
        host += [("serve_bulk", t0, t0 + 0.2, MAIN),
                 ("serve_bulk.copy_in", t0, t0 + 0.05, MAIN),
                 ("serve_bulk.predict", t0 + 0.05, t0 + 0.1, MAIN),
                 ("param.lookup", t0 + 0.06, t0 + 0.08, MAIN),
                 ("serve_bulk.copy_out", t0 + 0.1, t0 + 0.2, MAIN)]
        device += [("Memcpy HtoD", t0 + 0.02, t0 + 0.05, True),
                   ("kernel", t0 + 0.05, t0 + 0.15, False)]
    host += [("aten::copy_", 0.35, 0.4, MAIN),
             ("serve_bulk.predict", 0.8, 0.9, STAGING)]
    device += [("kernel", 0.32, 0.42, False)]
    return Trace(device, host, (0.0, 1.0), MAIN)


def _train_trace():
    """Chunks of 2 steps: one begun before the window, two whole, and the
    last still open when the profiler stopped (closed at the window's
    end); the staging thread pins two items."""
    host = [("train.chunk", -0.05, 0.1, MAIN),
            ("train.wait_input", -0.05, 0.0, MAIN)]
    for t0, wait, drain in ((0.1, 0.02, 0.01), (0.3, 0.04, 0.03)):
        host += [("train.chunk", t0, t0 + 0.2, MAIN),
                 ("train.wait_input", t0, t0 + wait, MAIN),
                 ("train.step", t0 + wait, t0 + 0.1, MAIN),
                 ("train.drain", t0 + 0.1, t0 + 0.1 + drain, MAIN)]
    host += [("train.chunk", 0.5, 1.0, MAIN),
             ("train.wait_input", 0.5, 0.6, MAIN),
             ("train.step", 0.6, 0.7, MAIN),
             ("train.drain", 0.7, 1.0, MAIN),
             ("prefetch.pin", 0.05, 0.07, STAGING),
             ("prefetch.pin", 0.25, 0.29, STAGING),
             ("prefetch.pin", 0.95, 1.2, STAGING),
             ("prefetch.batch", 0.2, 0.25, STAGING)]
    return Trace([("kernel", 0.1, 0.2, False)], host, (0.0, 1.0), MAIN)


#: reader -> (trace, the answer)
KNOWN = {
    # 1e9 bytes a call over 0.05 s
    "serve_copy_in_gb_per_s": (_serve_trace, 20.0),
    "serve_enqueue_ms_per_call": (_serve_trace, 50.0),
    # each call open 0.2 s, the device busy 0.13 s of it
    "serve_idle_in_call_pct": (_serve_trace, 14.0),
    # two whole chunks of 2 steps
    "input_wait_ms_per_step": (_train_trace, (20 + 40) / 4),
    "drain_wait_ms_per_step": (_train_trace, (10 + 30) / 4),
    # the pins wholly inside the window, over the chunk's 2 steps
    "prefetch_pin_ms_per_step": (_train_trace, (20 + 40) / 2 / 2),
}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_known_answer(name, recorder):
    recorder.add("serve_bulk.calls", 2, detail=True)
    recorder.add("serve_bulk.bytes_in", 2e9, detail=True)
    make, want = KNOWN[name]
    ctx = {"trace": make(), "chunk": 2, "calls_traced": 2}
    assert run._reader(name)(ctx) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_the_programs_spans(name, recorder):
    """A program without the spans (as the parent of this change) gives a
    trace of device work and runtime calls only: every reader returns
    None and none raises; so without a trace, or without the counters."""
    read = run._reader(name)
    bare = Trace([("kernel", 0.1, 0.2, False)],
                 [("cudaLaunchKernel", 0.1, 0.11, MAIN),
                  ("portbench.gather", 0.2, 0.3, STAGING)], (0.0, 1.0), MAIN)
    assert read({"trace": bare, "chunk": 2, "calls_traced": 2}) is None
    assert read({"trace": None, "chunk": 2, "calls_traced": 2}) is None
    if name == "serve_copy_in_gb_per_s":  # spans but no counters
        assert read({"trace": _serve_trace(), "calls_traced": 2}) is None


def test_call_tail_reader_reads_every_call_of_the_window():
    """``serve_call_ms_p95.whole_call`` is the 95th percentile of all the
    window's host-timed calls (numpy's, as the end-to-end metric), and
    nothing without calls."""
    read = run._reader("serve_call_ms_p95.whole_call")
    calls = [0.004] * 90 + [0.012] * 10
    assert read({"call_s": calls}) == pytest.approx(
        float(np.percentile(calls, 95)) * 1e3, rel=1e-12)
    assert read({"call_s": []}) is None and read({}) is None


def test_a_traced_tiny_serving_run_reports_its_call_tail():
    """The serving loop hands its call times to the readers: a traced run
    of the tiny DBN cell reports the tail in its per-layer line."""
    result, lines = run.execute(tiny.cell(SERVE), SEED, 0.3, True,
                                device="cpu", builder=tiny.builder)
    assert result["correct"], lines
    tail = result["metrics"]["serve_call_ms_p95.whole_call"]
    assert tail["unit"] == "ms" and tail["value"] > 0


def _model_and_batch(workload, seed=SEED):
    cell = tiny.cell(workload)
    pool = inputs.make_pool(cell.config, cell.traffic, seed)
    model = inputs.build_model(cell.config, seed, "cpu", tiny.builder)
    return cell, pool, model


def test_serve_bulk_counts_the_batch_and_nests_its_spans(recorder):
    from repro_torch.configs.clax_baidu import serve_bulk

    cell, pool, model = _model_and_batch(SERVE)
    batches = served_batches(pool, cell.traffic)
    for b in batches[:2]:
        out = serve_bulk(model, b)
    counters = recorder.detail_snapshot()
    assert counters == {
        "serve_bulk.calls": 2,
        "serve_bulk.sessions": 2 * len(out),
        "serve_bulk.bytes_in": sum(v.nbytes for b in batches[:2]
                                   for v in b.values()),
        "serve_bulk.bytes_out": 2 * out.nbytes}
    spans = list(recorder.tracer.spans)
    calls = [s for s in spans if s.name == "serve_bulk"]
    assert [c.tags["call"] for c in calls] == [c.span_id for c in calls]
    by_id = {s.span_id: s for s in spans}
    for c in calls:
        kids = [s.name for s in spans if s.parent_id == c.span_id]
        assert kids == ["serve_bulk.copy_in", "serve_bulk.predict",
                        "serve_bulk.copy_out"]
    lookups = [s for s in spans if s.name == "param.lookup"]
    assert len(lookups) == 2 * 2  # the DBN's two tables a call
    for s in lookups:
        assert by_id[s.parent_id].name == "serve_bulk.predict"
        assert s.tags["table"] == tiny.ROWS
        assert s.tags["call"] == by_id[by_id[s.parent_id].parent_id].tags[
            "call"]
    assert not recorder.sinks and all(s.detail for s in spans)


def _profile():
    """A CPU profiler of every thread with the benchmark's window mark."""
    from torch.profiler import ProfilerActivity, profile, record_function

    try:
        from torch._C._profiler import _ExperimentalConfig

        prof = profile(activities=[ProfilerActivity.CPU],
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
    except (ImportError, TypeError):
        prof = profile(activities=[ProfilerActivity.CPU])
    return prof, record_function(MARK)


def _serve_and_train(profiled: bool):
    """One tiny served batch and two tiny chunks trained, from the same
    seed, with or without a profiler collecting."""
    from repro_torch.configs.clax_baidu import serve_bulk
    from repro_torch.data import ClickLogLoader
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer

    cell, pool, model = _model_and_batch(SERVE)
    tcell, tpool, tmodel = _model_and_batch(TRAIN)
    B = tcell.traffic["batch"]
    loader = ClickLogLoader({k: v[:4 * B] for k, v in tpool.items()},
                            batch_size=B, seed=5)
    trainer = Trainer(adamw(3e-3, weight_decay=1e-4), epochs=1,
                      chunk_batches=2, device="cpu",
                      log_fn=lambda _: None)
    prof, mark = _profile()
    if profiled:
        prof.__enter__()
        mark.__enter__()
    answer = serve_bulk(model, served_batches(pool, cell.traffic)[0])
    history = trainer.train(tmodel, loader)
    if profiled:
        mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        names = {e.name for e in prof.events()}
        assert {"serve_bulk.predict", "train.chunk",
                "train.step"} <= names
    params = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    return answer, history[0]["train_loss"], params


def test_a_collecting_profiler_leaves_the_results_equal_to_the_bit():
    plain = _serve_and_train(False)
    traced = _serve_and_train(True)
    np.testing.assert_array_equal(plain[0], traced[0])
    assert plain[1] == traced[1]
    assert plain[2].keys() == traced[2].keys()
    for k in plain[2]:
        assert torch.equal(plain[2][k], traced[2][k]), k


def test_readers_read_a_cpu_profile_of_the_program(recorder):
    """The program's ranges reach a real profiler's trace under their
    names: the serving readers and the Trainer's (the staging thread's
    too, where the profiler sees every thread) find them."""
    from repro_torch.configs.clax_baidu import serve_bulk
    from repro_torch.data import ClickLogLoader
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer

    cell, pool, model = _model_and_batch(SERVE)
    batches = served_batches(pool, cell.traffic)
    tcell, tpool, tmodel = _model_and_batch(TRAIN)
    B = tcell.traffic["batch"]
    trainer = Trainer(adamw(3e-3), epochs=1, chunk_batches=2, device="cpu",
                      log_fn=lambda _: None)
    loader = ClickLogLoader({k: v[:12 * B] for k, v in tpool.items()},
                            batch_size=B, seed=5)
    prof, mark = _profile()
    with prof:
        with mark:
            for b in batches[:3]:
                serve_bulk(model, b)
            trainer.train(tmodel, loader)
    trace = Trace.from_profiler(prof)
    ctx = {"trace": trace, "chunk": 2, "calls_traced": 3}
    assert run._reader("serve_enqueue_ms_per_call")(ctx) > 0
    assert run._reader("serve_copy_in_gb_per_s")(ctx) > 0
    for name in ("input_wait_ms_per_step", "drain_wait_ms_per_step"):
        assert run._reader(name)(ctx) >= 0
    pin = run._reader("prefetch_pin_ms_per_step")(ctx)
    staged = {th for n, _, _, th in trace.host if n == "prefetch.pin"}
    assert (pin is None) == (not staged)
    if staged:
        assert pin > 0 and staged != {trace.main_thread}
