"""The training slice as a whole, port against JAX on the CPU.

The same small synthetic DBN-behaviour log, a hash-compressed table of a
few thousand rows, AdamW(3e-3, wd=1e-4) and one epoch: the engines' per-step
losses agree within 1e-4 relative, and the Trainers' train loss, val
LL/ppl/cond_ppl and test metrics within 1e-4. The port's chunked engine is
bitwise equal to its per-step loop, and the launcher runs to its test print
on the CPU.

The card's route, one CUDA-graph replay per chunk (``train/capture.py``),
runs here through a stand-in graph whose replay runs the captured body over
its static buffers: the engine's and the evaluation's bodies are held to
the bit against their loops, and the signature keying, the rebinding to a
new state, the refusal of an optimizer that moves its state, and the
release of dropped engines, models and their graphs are checked. The real
capture runs only on the card (``chip_smoke.py``).
"""
import gc
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro import optim as jopt
from repro.data import DevicePrefetcher as JaxPrefetcher
from repro.train import TrainEngine as JaxEngine
from repro.train import Trainer as JaxTrainer
from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch.data import (ClickLogLoader, DevicePrefetcher,
                              SyntheticConfig, generate_click_log,
                              split_sessions)
from repro_torch.convert import load_jax_params
from repro_torch.launch import train as launch_train
from repro_torch.train import TrainEngine, Trainer
from repro_torch.train import capture
from repro_torch.train.capture import ChunkGraphs, tree_leaves

BATCH = 128
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def log():
    cfg = SyntheticConfig(n_sessions=2000, n_queries=250, docs_per_query=20,
                          positions=10, behavior="dbn", seed=3)
    data, _ = generate_click_log(cfg)
    return cfg, split_sessions(data, (0.8, 0.1, 0.1), seed=3)


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


def _loaders(split, batch=BATCH, **kw):
    return ClickLogLoader(split, batch_size=batch, seed=0, **kw)


def test_engine_per_step_losses_match_jax(log):
    cfg, (train, _, _) = log
    jm, tm = _models("dbn", cfg)
    jengine = JaxEngine(jm, jopt.adamw(3e-3, weight_decay=1e-4),
                        chunk_batches=4)
    params = jm.init(jax.random.PRNGKey(0))
    jstate = jengine.init_opt_state(params)
    jlosses = []
    for chunk, _, _ in JaxPrefetcher(_loaders(train), chunk_batches=4,
                                     overlap=False):
        params, jstate, losses = jengine.step(params, jstate, chunk)
        jlosses.extend(np.asarray(losses).tolist())
    tengine = TrainEngine(tm, topt.adamw(3e-3, weight_decay=1e-4),
                          chunk_batches=4)
    tstate = tengine.init_opt_state()
    tlosses = []
    for chunk, _, _ in DevicePrefetcher(_loaders(train), device="cpu",
                                        chunk_batches=4):
        tstate, losses = tengine.step(tstate, chunk)
        tlosses.extend(losses.tolist())
    assert len(tlosses) == len(jlosses) == len(train["clicks"]) // BATCH
    np.testing.assert_allclose(tlosses, jlosses, rtol=REL)


@pytest.mark.parametrize("name", ["dbn", "dctr"])
def test_trainers_match_jax(log, name):
    cfg, (train, val, test) = log
    jm, tm = _models(name, cfg)
    jtrainer = JaxTrainer(jopt.adamw(3e-3, weight_decay=1e-4), epochs=1,
                          chunk_batches=4, log_fn=lambda s: None)
    ttrainer = Trainer(topt.adamw(3e-3, weight_decay=1e-4), epochs=1,
                       chunk_batches=4, device="cpu", log_fn=lambda s: None)

    def evals(split):
        return ClickLogLoader(split, batch_size=64, shuffle=False,
                              drop_last=False)

    (jrec,) = jtrainer.train(jm, _loaders(train), evals(val))
    (trec,) = ttrainer.train(tm, _loaders(train), evals(val))
    for key in ("train_loss", "val_ll", "val_ppl", "val_cond_ppl"):
        np.testing.assert_allclose(trec[key], jrec[key], rtol=REL,
                                   err_msg=key)
    jtest = jtrainer.test(jm, evals(test))
    ttest = ttrainer.test(tm, evals(test))
    for key in ("ll", "ppl", "cond_ppl"):
        np.testing.assert_allclose(ttest[key], jtest[key], rtol=REL)
        np.testing.assert_allclose(ttest["per_rank"][key],
                                   jtest["per_rank"][key], rtol=REL)


def test_chunked_engine_is_bitwise_equal_to_per_step_loop(log):
    cfg, (train, _, _) = log
    runs = []
    for chunk_batches in (1, 4):
        _, tm = _models("dbn", cfg)
        engine = TrainEngine(tm, topt.adamw(3e-3, weight_decay=1e-4),
                             chunk_batches=chunk_batches)
        state = engine.init_opt_state()
        losses = []
        # 12 batches: chunks of 4 + a trailing partial chunk
        loader = _loaders({k: v[:12 * 110] for k, v in train.items()},
                          batch=110)
        for chunk, _, n in DevicePrefetcher(loader, device="cpu",
                                            chunk_batches=chunk_batches):
            state, out = engine.step(state, chunk)
            assert out.shape == (n,)
            losses.extend(out.tolist())
        runs.append((losses, [p.detach().clone() for p in tm.parameters()],
                     state))
    (l1, p1, s1), (l4, p4, s4) = runs
    assert l1 == l4
    for a, b in zip(p1, p4):
        assert torch.equal(a, b)
    for a, b in zip(s1[0].mu + s1[0].nu, s4[0].mu + s4[0].nu):
        assert torch.equal(a, b)


def test_prefetcher_flushes_the_odd_tail_into_its_own_chunk(log):
    _, (train, _, _) = log
    loader = ClickLogLoader({k: v[:250] for k, v in train.items()},
                            batch_size=100, shuffle=False, drop_last=False)
    items = list(DevicePrefetcher(loader, device="cpu", chunk_batches=4))
    assert [n for _, _, n in items] == [2, 1]
    assert items[0][0]["clicks"].shape == (2, 100, 10)
    assert items[1][0]["clicks"].shape == (1, 50, 10)
    assert items[-1][1] == {"epoch": 0, "step": 3}
    assert items[0][0]["mask"].dtype == torch.bool


def test_trainer_refuses_a_model_on_another_device(log):
    cfg, (train, _, _) = log
    _, tm = _models("dbn", cfg)
    trainer = Trainer(topt.adamw(3e-3), epochs=1, device="meta")
    with pytest.raises(ValueError, match="trainer runs on meta"):
        trainer.train(tm, _loaders(train))


def test_launcher_runs_to_its_test_print_on_cpu(capsys):
    results = launch_train.main([
        "--model", "dbn", "--sessions", "1500", "--epochs", "2",
        "--batch", "128", "--compression", "hash", "--ratio", "2",
        "--chunk-batches", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] test:" in out
    assert all(np.isfinite(results[k]) for k in ("ll", "ppl", "cond_ppl"))
    assert 1.0 < results["ppl"] < 2.0


@pytest.mark.parametrize("name", ["dbn", "ubm"])
def test_sparse_table_trainers_match_jax(log, name):
    """Trainer(sparse_tables=True): the hashed tables take lazy AdamW in
    both packages; train loss and val metrics within the file's 1e-4."""
    cfg, (train, val, _) = log
    jm, tm = _models(name, cfg)
    kwargs = dict(sparse_tables=True,
                  sparse_table_kwargs=dict(lr=3e-3, weight_decay=1e-4))
    jtrainer = JaxTrainer(jopt.adamw(3e-3, weight_decay=1e-4), epochs=1,
                          chunk_batches=4, log_fn=lambda s: None, **kwargs)
    ttrainer = Trainer(topt.adamw(3e-3, weight_decay=1e-4), epochs=1,
                       chunk_batches=4, device="cpu", log_fn=lambda s: None,
                       **kwargs)
    evals = ClickLogLoader(val, batch_size=64, shuffle=False, drop_last=False)
    (jrec,) = jtrainer.train(jm, _loaders(train), evals)
    (trec,) = ttrainer.train(tm, _loaders(train), evals)
    for key in ("train_loss", "val_ll", "val_ppl", "val_cond_ppl"):
        np.testing.assert_allclose(trec[key], jrec[key], rtol=REL,
                                   err_msg=key)


class _Replay:
    def __init__(self, fn, python_runs):
        # a CUDA graph keeps no Python: only the replaying stand-in keeps fn
        self.fn = fn if python_runs else None

    def replay(self):
        if self.fn is not None:
            self.fn()


class _StandInGraphs:
    """``CudaGraphs``' stand-in on the CPU. ``python_runs=True``: capture
    keeps the body and runs nothing, and a replay runs it over the static
    buffers, computing what a CUDA graph's replay computes. ``False``: the
    body runs (its Python, as during a real capture) only at capture, and a
    replay runs nothing, as a device replay runs no Python."""

    def __init__(self, python_runs=True):
        self.python_runs = python_runs

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        if not self.python_runs:
            fn()
        return _Replay(fn, self.python_runs)


def _copy_into(old, new):
    for a, b in zip(tree_leaves(old), tree_leaves(new), strict=True):
        if a is not b:
            a.copy_(b)


def _in_place(opt):
    """``opt`` with its state updated in place, as its fused pass on the
    card does; the CPU chain makes new state tensors, which a captured
    chunk refuses."""
    def update(grads, state, params=None):
        updates, new = opt.update(grads, state, params)
        _copy_into(state, new)
        return updates, state
    return opt._replace(update=update)


SPARSE = dict(sparse_tables=True,
              sparse_table_kwargs=dict(lr=3e-3, weight_decay=1e-4))


def _chunks(train):
    # 13 batches of 120 and a 40-row tail: chunks of 4, 4, 4, 1, then the
    # tail alone; three signatures, (4, 120) replayed twice
    loader = ClickLogLoader({k: v[:1600] for k, v in train.items()},
                            batch_size=120, seed=0, drop_last=False)
    return [c for c, _, _ in DevicePrefetcher(loader, device="cpu",
                                              chunk_batches=4)]


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_captured_chunk_body_is_bitwise_equal_to_the_loop(log, route):
    """The loop (the CPU's route, with the chain) against the captured
    body replayed through the stand-in (with the optimizer updating its
    state in place, as on the card)."""
    cfg, (train, _, _) = log
    kwargs = SPARSE if route == "sparse" else {}
    chunks = _chunks(train)
    runs = []
    for captured in (False, True):
        _, tm = _models("dbn", cfg)
        opt = topt.adamw(3e-3, weight_decay=1e-4)
        engine = TrainEngine(tm, _in_place(opt) if captured else opt,
                             chunk_batches=4, **kwargs)
        state = engine.init_opt_state()
        leaves = tree_leaves(state)
        if captured:
            engine.graphs = ChunkGraphs(engine._chunk_body,
                                        backend=_StandInGraphs())
        losses = []
        for chunk in chunks:
            if captured:
                out_state, out = engine._replayed(state, chunk)
                assert out_state is state  # updated where it lies
            else:
                state, out = engine.step(state, chunk)
            losses.extend(out.tolist())
        if captured:
            assert all(a is b for a, b in zip(leaves, tree_leaves(state)))
            assert (engine.graphs.captures, engine.graphs.replays) == (3, 2)
        runs.append((losses, [p.detach().clone() for p in tm.parameters()],
                     tree_leaves(state)))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert len(l0) == 14 and l0 == l1
    for a, b in zip(p0 + s0, p1 + s1, strict=True):
        assert torch.equal(a, b)


def test_a_captured_chunk_refuses_an_optimizer_that_moves_its_state(log):
    """A graph replays the state at the addresses it captured: an optimizer
    that returns new state tensors (the CPU chain) raises in the body
    instead of training on state the replays never see."""
    cfg, (train, _, _) = log
    _, tm = _models("dbn", cfg)
    engine = TrainEngine(tm, topt.adamw(3e-3), chunk_batches=4)
    engine.graphs = ChunkGraphs(engine._chunk_body, backend=_StandInGraphs())
    with pytest.raises(RuntimeError, match="in place"):
        engine._replayed(engine.init_opt_state(), _chunks(train)[0])


def test_graphs_are_keyed_by_signature_and_bound_tensors():
    """A tail chunk (another n, another batch) gets a graph of its own, as
    JAX retraces per shape; other bound tensors (another optimizer state)
    drop every graph and capture anew; a carry (an output named like an
    input) is written back into the input's static buffer; the body is
    given the bound tree."""
    acc = torch.zeros(3)
    seen = []

    def body(x, bound):
        seen.append(bound)
        return {"x": x["x"] + bound[0], "total": x["x"].sum()}

    graphs = ChunkGraphs(body, backend=_StandInGraphs())
    full, tail = torch.ones(4, 3), torch.ones(1, 3)
    first = graphs({"x": full}, [acc])
    assert seen[0][0] is acc
    acc += 1
    out = graphs({"x": full}, [acc])
    assert torch.equal(first["x"], full) and torch.equal(out["x"], full + 1)
    again = graphs({"x": out["x"]}, [acc])  # the carry: no copy in
    assert torch.equal(again["x"], full + 2) and again["x"] is out["x"]
    graphs({"x": tail}, [acc])
    graphs({"x": tail}, [acc])
    assert (graphs.captures, graphs.replays) == (2, 3)
    graphs({"x": tail}, [torch.zeros(3)])  # another state: captured anew
    graphs({"x": full}, [torch.zeros(3)])  # and the old graphs are gone
    assert (graphs.captures, graphs.replays) == (4, 3)


class _CountingGraphs(_StandInGraphs):
    """A stand-in whose n-th graph holds the kernel nodes {"k": 1, "g<n>":
    n} and that records which graphs were asked for their kernels."""

    def __init__(self):
        super().__init__()
        self.made, self.asked = 0, []

    def capture(self, fn):
        graph = super().capture(fn)
        self.made += 1
        graph.n = self.made
        return graph

    def kernels(self, graph):
        self.asked.append(graph.n)
        return Counter({"k": 1, f"g{graph.n}": graph.n})


def test_replays_count_their_graphs_kernel_nodes_while_counting(
        monkeypatch):
    """While ``capture.replayed_kernels`` is a Counter each replay adds its
    graph's kernel nodes to it (asked of the backend once per graph); the
    warm-up and capture add nothing, and with it None nothing is asked."""
    backend = _CountingGraphs()
    graphs = ChunkGraphs(lambda x, b: {"y": x["x"] * 2}, backend=backend)
    x, tail = torch.ones(4), torch.ones(1)
    graphs({"x": x})
    graphs({"x": x})  # a replay, not counted
    assert backend.asked == []
    counts = Counter()
    monkeypatch.setattr(capture, "replayed_kernels", counts)
    graphs({"x": tail})  # warm-up and capture: nothing replayed
    assert counts == Counter()
    for _ in range(3):
        graphs({"x": x})
    graphs({"x": tail})
    assert counts == Counter({"k": 4, "g1": 3, "g2": 2})
    assert backend.asked == [1, 2]
    z = torch.zeros(1)
    graphs({"x": x}, [z])  # rebound: captured anew
    graphs({"x": x}, [z])
    assert counts == Counter({"k": 5, "g1": 3, "g2": 2, "g3": 3})
    assert backend.asked == [1, 2, 3]


def test_chunk_graphs_keep_nothing_of_what_they_were_bound_to():
    """Only the bound tensors' addresses are kept: once the caller drops
    what it bound (a model, an optimizer state), it is collected."""
    class Bound:
        pass

    graphs = ChunkGraphs(lambda x, b: {"y": x["x"] * 2},
                         backend=_StandInGraphs(python_runs=False))
    bound, z = Bound(), torch.zeros(1)
    ref = weakref.ref(bound)
    graphs({"x": torch.ones(2)}, (bound, [z]))
    graphs({"x": torch.ones(2)}, (bound, [z]))
    del bound
    gc.collect()
    assert ref() is None and graphs.captures == 1


def test_set_injected_lr_writes_into_the_existing_tensor(log):
    """A captured step reads the lr at its tensor's address: retuning keeps
    the tensor (so the graph is kept, not captured anew) and the next
    replay trains at the new lr, as the loop does."""
    state = topt.adamw(0.1, inject_lr=True).init([torch.ones(3)])
    lr = topt.get_injected_lr(state)
    assert topt.set_injected_lr(state, 0.003) is state
    assert topt.get_injected_lr(state) is lr
    assert lr.item() == np.float32(0.003)

    cfg, (train, _, _) = log
    chunks = _chunks(train)[:3]
    runs = []
    for captured in (False, True):
        _, tm = _models("dbn", cfg)
        opt = topt.adamw(3e-3, weight_decay=1e-4, inject_lr=True)
        engine = TrainEngine(tm, _in_place(opt) if captured else opt,
                             chunk_batches=4)
        state = engine.init_opt_state()
        if captured:
            engine.graphs = ChunkGraphs(engine._chunk_body,
                                        backend=_StandInGraphs())
        losses = []
        for i, chunk in enumerate(chunks):
            if i == 2:
                state = topt.set_injected_lr(state, 1e-2)
            state, out = (engine._replayed if captured else engine.step)(
                state, chunk)
            losses.extend(out.tolist())
        if captured:
            assert (engine.graphs.captures, engine.graphs.replays) == (1, 2)
        runs.append((losses, [p.detach().clone() for p in tm.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def _evals(split, batch=64):
    return ClickLogLoader(split, batch_size=batch, shuffle=False,
                          drop_last=False)


@pytest.mark.parametrize("name", ["dbn", "ubm"])
def test_chunked_evaluate_matches_jax(log, name):
    """Evaluation in chunks of 4 (200 sessions in batches of 64: a chunk of
    3 and the 8-row tail alone) against JAX's chunked Trainer.evaluate at
    the same parameters."""
    cfg, (_, val, _) = log
    jm, tm = _models(name, cfg)
    rng = np.random.default_rng(11)  # parameters away from the init
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.5 * rng.standard_normal(
            np.shape(x))).astype(np.float32),
        jax.device_get(jm.init(jax.random.PRNGKey(0))))
    load_jax_params(tm, params)
    jtrainer = JaxTrainer(jopt.adamw(3e-3), epochs=1, chunk_batches=4,
                          log_fn=lambda s: None)
    ttrainer = Trainer(topt.adamw(3e-3), epochs=1, chunk_batches=4,
                       device="cpu", log_fn=lambda s: None)
    want = jtrainer.evaluate(jm, jax.tree_util.tree_map(jnp.asarray, params),
                             _evals(val), per_rank=True)
    got = ttrainer.evaluate(tm, _evals(val), per_rank=True)
    for key in ("ll", "ppl", "cond_ppl"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
        np.testing.assert_allclose(got["per_rank"][key],
                                   want["per_rank"][key], rtol=1e-6)


def test_captured_evaluation_body_is_bitwise_equal_to_the_loop(log):
    cfg, (train, val, _) = log
    _, tm = _models("dbn", cfg)
    engine = TrainEngine(tm, topt.adamw(3e-2), chunk_batches=4)
    state = engine.init_opt_state()
    for chunk in _chunks(train)[:2]:  # parameters away from their init
        state, _ = engine.step(state, chunk)
    trainer = Trainer(topt.adamw(3e-3), chunk_batches=4, device="cpu")
    want = trainer.evaluate(tm, _evals(val, 32), per_rank=True)
    step = trainer._eval_step(tm)
    step.graphs = ChunkGraphs(step._body, backend=_StandInGraphs())
    for _ in range(2):  # the second pass replays every signature
        metric_state = None
        for chunk, _, _ in DevicePrefetcher(_evals(val, 32), device="cpu",
                                            chunk_batches=4):
            if metric_state is None:
                metric_state = step.metrics.init_state(10)
            metric_state = step.replayed(tm, metric_state, chunk)
        got = {k: v.item() for k, v in
               step.metrics.compute(metric_state).items()}
        assert got == {k: want[k] for k in got}
        per = step.metrics.compute_per_rank(metric_state)
        assert {k: v.tolist() for k, v in per.items()} == want["per_rank"]
    # 200 sessions in batches of 32: chunks of 4 and 2, then the 8-row tail
    assert (step.graphs.captures, step.graphs.replays) == (3, 3)


def test_evaluation_cache_lets_a_dropped_model_go(log):
    """The Trainer keeps a model's evaluation step (and, on the card, its
    graphs) only while the model lives: a model evaluated and then dropped
    is collected, and its entry goes with it."""
    cfg, (_, val, _) = log
    trainer = Trainer(topt.adamw(3e-3), chunk_batches=4, device="cpu")
    _, tm = _models("dbn", cfg)
    trainer.evaluate(tm, _evals(val))
    step = trainer._eval_step(tm)
    step.graphs = ChunkGraphs(step._body,
                              backend=_StandInGraphs(python_runs=False))
    chunk = next(iter(DevicePrefetcher(_evals(val), device="cpu",
                                       chunk_batches=4)))[0]
    step.replayed(tm, step.metrics.init_state(10), chunk)  # a capture
    ref = weakref.ref(tm)
    assert len(trainer._eval_cache) == 1
    del tm, step
    gc.collect()
    assert ref() is None
    assert len(trainer._eval_cache) == 0


def test_evaluation_cache_keeps_the_last_few_models(log):
    cfg, (_, val, _) = log
    trainer = Trainer(topt.adamw(3e-3), chunk_batches=4, device="cpu")
    models = [_models("ubm", cfg)[1] for _ in range(5)]
    steps = [trainer._eval_step(m) for m in models]
    assert len(trainer._eval_cache) == 4
    assert trainer._eval_step(models[-1]) is steps[-1]
    assert trainer._eval_step(models[0]) is not steps[0]  # evicted first
    got = trainer.evaluate(models[1], _evals(val))
    assert got == Trainer(topt.adamw(3e-3), chunk_batches=4,
                          device="cpu").evaluate(models[1], _evals(val))


def test_dropped_engines_and_models_free_their_graphs_at_once(log):
    """No reference cycle holds a graph: with the cyclic collector off, a
    dropped engine frees its graphs, and a dropped model its evaluation
    step, as soon as the last reference goes (a graph the collector freed
    later could land inside another capture, and void it)."""
    cfg, (train, val, _) = log
    _, tm = _models("dbn", cfg)
    engine = TrainEngine(tm, _in_place(topt.adamw(3e-3)), chunk_batches=4)
    engine.graphs = ChunkGraphs(engine._chunk_body,
                                backend=_StandInGraphs(python_runs=False))
    engine._replayed(engine.init_opt_state(), _chunks(train)[0])
    trainer = Trainer(topt.adamw(3e-3), chunk_batches=4, device="cpu")
    trainer.evaluate(tm, _evals(val))
    step = trainer._eval_step(tm)
    step.graphs = ChunkGraphs(step._body,
                              backend=_StandInGraphs(python_runs=False))
    chunk = next(iter(DevicePrefetcher(_evals(val), device="cpu",
                                       chunk_batches=4)))[0]
    step.replayed(tm, step.metrics.init_state(10), chunk)
    gc.collect()
    refs = [weakref.ref(x) for x in (engine.graphs, step.graphs, tm)]
    gc.disable()
    try:
        del engine, step, tm
        assert [r() for r in refs] == [None, None, None]
        assert len(trainer._eval_cache) == 0
        _, tm = _models("dbn", cfg)  # a Trainer dropped: its steps go too
        trainer.evaluate(tm, _evals(val))
        ref = weakref.ref(trainer._eval_step(tm).graphs)
        del trainer
        assert ref() is None
    finally:
        gc.enable()
