"""The training slice as a whole, port against JAX on the CPU.

The same small synthetic DBN-behaviour log, a hash-compressed table of a
few thousand rows, AdamW(3e-3, wd=1e-4) and one epoch: the engines' per-step
losses agree within 1e-4 relative, and the Trainers' train loss, val
LL/ppl/cond_ppl and test metrics within 1e-4. The port's chunked engine is
bitwise equal to its per-step loop, and the launcher runs to its test print
on the CPU.
"""
import numpy as np
import pytest
import torch

import jax

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
from repro_torch.launch import train as launch_train
from repro_torch.train import TrainEngine, Trainer

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
