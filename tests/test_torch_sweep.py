"""Replica sweeps, the non-finite guard and bit-exact resume in the port
(``TrainEngine(replicas=R, nonfinite_guard=...)``, ``Trainer``'s run
contract), on the CPU.

Against JAX: replica r of a port sweep matches JAX's vmapped sweep at 1e-5
(losses and parameters, JAX's replica params carried over with
``select_replica`` and ``convert``), and a guarded chunk skips the step
JAX's skips. Within the port, to the bit: replica r equals a standalone
engine with the same seed and learning rate (dense and sparse routes,
guard on and off); per-replica early stopping equals sequential Trainers; a
guarded run over a poisoned batch equals a run without it; a resumed run
(at an epoch's end, mid-epoch after a preemption through the overlap
prefetcher, a sweep with a stopped replica) equals the uninterrupted one,
history included; the launcher's SIGKILL drill ends on the uninterrupted
run's numbers. The cases of ``tests/test_sweep.py`` that are not about
the mesh are here too.
"""
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import optim as jopt
from repro.data import DevicePrefetcher as JaxPrefetcher
from repro.train import TrainEngine as JaxEngine
from repro.train import select_replica as jax_select_replica
from repro_torch import core as tcore
from repro_torch import optim
from repro_torch.convert import load_jax_params
from repro_torch.data import (ClickLogLoader, DevicePrefetcher,
                              SyntheticConfig, generate_click_log,
                              split_sessions)
from repro_torch.launch import train as launch_train
from repro_torch.testing import KillSwitch, NonFiniteBatchInjector
from repro_torch.train import (TrainEngine, Trainer, TrainState,
                               select_replica, stack_replicas)
from repro_torch.train.capture import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pbm_log():
    cfg = SyntheticConfig(n_sessions=2200, n_queries=25, docs_per_query=12,
                          positions=6, behavior="pbm", seed=13)
    data, _ = generate_click_log(cfg)
    train, val, _ = split_sessions(data, (0.8, 0.1, 0.1), seed=0)
    return cfg, train, val


@pytest.fixture(scope="module")
def tower_log():
    cfg = SyntheticConfig(n_sessions=1000, n_queries=20, docs_per_query=10,
                          positions=5, behavior="pbm", seed=3, n_features=8)
    data, _ = generate_click_log(cfg)
    train, val, _ = split_sessions(data, (0.8, 0.1, 0.1), seed=0)
    return cfg, train, val


def _quiet(*_):
    pass


def _model(cfg, seed=0):
    return tcore.PositionBasedModel(query_doc_pairs=cfg.n_query_doc_pairs,
                                    positions=cfg.positions, init_prob=0.2,
                                    device="cpu", seed=seed)


def _tower(cfg, seed=0):
    return tcore.PositionBasedModel(
        positions=cfg.positions,
        attraction=tcore.MLPParameterConfig(features=8, hidden=(16,)),
        device="cpu", seed=seed)


def _loader(data, batch=256, **kw):
    return ClickLogLoader(data, batch_size=batch, seed=5, **kw)


def _val(data):
    return ClickLogLoader(data, batch_size=128, shuffle=False,
                          drop_last=False)


def _chunks(loader, n=4):
    return [c for c, _, _ in DevicePrefetcher(loader, device="cpu",
                                              chunk_batches=n)]


def _equal(a, b):
    ta, tb = tree_leaves(a), tree_leaves(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def _run_single(model, opt, chunks, **kw):
    engine = TrainEngine(model, opt, chunk_batches=4, **kw)
    state = engine.init_opt_state()
    outs = []
    for chunk in chunks:
        state, out = engine.step(state, chunk)
        outs.append(out)
    return engine, state, outs


# -- the sweep engine ----------------------------------------------------------

def test_no_replica_step_rejects_active_mask(pbm_log):
    cfg, train, _ = pbm_log
    engine = TrainEngine(_model(cfg), optim.adamw(0.05))
    state = engine.init_opt_state()
    with pytest.raises(ValueError, match="active"):
        engine.step(state, _chunks(_loader(train), 2)[0],
                    active=np.ones(1, bool))


def test_a_sweep_needs_its_stacked_parameters_first(pbm_log):
    cfg, train, _ = pbm_log
    engine = TrainEngine(_model(cfg), optim.adamw(0.05), replicas=2)
    with pytest.raises(ValueError, match="init_replica_params"):
        engine.init_opt_state()
    with pytest.raises(ValueError, match="seeds"):
        engine.init_replica_params([0, 1, 2])
    with pytest.raises(ValueError, match="replicas"):
        TrainEngine(_model(cfg), optim.adamw(0.05), replicas=0)


@pytest.mark.parametrize("attraction", [
    tcore.LinearParameterConfig(features=8),
    tcore.MLPParameterConfig(features=8, hidden=(16, 4)),
    tcore.DeepCrossParameterConfig(features=8, cross_layers=2,
                                   deep_layers=1)])
def test_replica_r_starts_as_the_model_built_with_seed_r(attraction):
    """Every leaf of replica r, the towers and the tables, equals the
    parameter of the model built with ``seed=seeds[r]``, to the bit."""
    def model(seed):
        return tcore.PositionBasedModel(positions=5, attraction=attraction,
                                        device="cpu", seed=seed)

    seeds = [3, 0, 7]
    engine = TrainEngine(model(0), optim.adamw(0.05), replicas=3)
    params = engine.init_replica_params(seeds)
    for r, seed in enumerate(seeds):
        for name, p in model(seed).named_parameters():
            leaf = select_replica(params, r)
            for key in name.replace("parts.", "", 1).split("."):
                leaf = leaf[key]
            assert torch.equal(leaf, p.detach()), (seed, name)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(select_replica(params, 0)["attraction"]),
        tree_leaves(select_replica(params, 1)["attraction"])))


def test_init_replica_params_refuses_a_parameter_no_seed_draws(pbm_log):
    cfg, _, _ = pbm_log
    model = _model(cfg)
    model.extra = torch.nn.Linear(2, 2)
    engine = TrainEngine(model, optim.adamw(0.05), replicas=2)
    with pytest.raises(ValueError, match="extra.weight"):
        engine.init_replica_params([0, 1])


@pytest.mark.parametrize("guard", [False, True])
def test_replica_r_is_bitwise_a_standalone_run(tower_log, guard):
    """Distinct seeds and learning rates: replica r's losses, parameters,
    moments and step count equal those of a single engine over a model
    built with seed r at lr r, to the bit."""
    cfg, train, _ = tower_log
    seeds, lrs = [0, 1, 2], [0.05, 0.02, 0.01]
    chunks = _chunks(_loader(train, 128))
    engine = TrainEngine(_tower(cfg), optim.adamw(0.99, inject_lr=True),
                         chunk_batches=4, replicas=3, nonfinite_guard=guard)
    params = engine.init_replica_params(seeds)
    state = engine.set_replica_lrs(engine.init_opt_state(), lrs)
    losses = []
    for chunk in chunks:
        state, out = engine.step(state, chunk)
        losses.append(out["loss"] if guard else out)
        assert losses[-1].shape == (chunk["clicks"].shape[0], 3)
    losses = torch.cat(losses)
    for r, (seed, lr) in enumerate(zip(seeds, lrs)):
        model = _tower(cfg, seed)
        _, single, outs = _run_single(model, optim.adamw(lr), chunks,
                                      nonfinite_guard=guard)
        want = torch.cat([o["loss"] if guard else o for o in outs])
        assert torch.equal(losses[:, r], want)
        ours = select_replica(params, r)
        theirs = dict(model.named_parameters())
        for name, p in theirs.items():
            path = name.replace("parts.", "", 1).split(".")
            leaf = ours
            for key in path:
                leaf = leaf[key]
            assert torch.equal(leaf, p.detach()), name
        _equal(select_replica(state, r)[0], single[0])


def test_replica_r_matches_jax_sweep(tower_log):
    """An R=3 sweep with distinct learning rates, from JAX's replica
    parameters: every replica's losses and final parameters within 1e-5 of
    JAX's vmapped sweep (each replica read with ``select_replica`` and
    carried into a port model with ``convert``)."""
    cfg, train, _ = tower_log
    lrs = [0.05, 0.02, 0.08]
    jm = jcore.PositionBasedModel(
        positions=cfg.positions,
        attraction=jcore.MLPParameterConfig(features=8, hidden=(16,)))
    jengine = JaxEngine(jm, jopt.adamw(0.99, inject_lr=True),
                        chunk_batches=4, replicas=3)
    jparams = jengine.init_replica_params([0, 7, 13])
    jstate = jengine.set_replica_lrs(jengine.init_opt_state(jparams), lrs)
    engine = TrainEngine(_tower(cfg), optim.adamw(0.99, inject_lr=True),
                         chunk_batches=4, replicas=3)
    engine.init_replica_params([0, 0, 0])
    for r in range(3):
        model = _tower(cfg)
        load_jax_params(model, jax.device_get(jax_select_replica(jparams, r)))
        with torch.no_grad():
            for leaf, p in zip(engine.replica_params, model.parameters()):
                leaf[r].copy_(p)
    state = engine.set_replica_lrs(engine.init_opt_state(), lrs)
    jlosses, tlosses = [], []
    # 800 sessions in 8 batches of 100: chunks of 4, one signature
    for (jchunk, _, _), (tchunk, _, _) in zip(
            JaxPrefetcher(_loader(train, 100), chunk_batches=4),
            DevicePrefetcher(_loader(train, 100), device="cpu",
                             chunk_batches=4)):
        jparams, jstate, jl = jengine.step(jparams, jstate, jchunk)
        state, tl = engine.step(state, tchunk)
        jlosses.append(np.asarray(jl))
        tlosses.append(tl.numpy())
    np.testing.assert_allclose(np.concatenate(tlosses),
                               np.concatenate(jlosses), atol=1e-5)
    for r in range(3):
        model = _tower(cfg)
        load_jax_params(model, jax.device_get(jax_select_replica(jparams, r)))
        for leaf, p in zip(engine.replica_params, model.parameters()):
            np.testing.assert_allclose(leaf[r].numpy(), p.detach().numpy(),
                                       atol=1e-5)


def test_sparse_tables_sweep_matches_standalone_runs(pbm_log):
    """Seeds only (the lazy-AdamW lr is shared): each replica of a sparse
    sweep is bit for bit a standalone sparse run."""
    cfg, train, _ = pbm_log
    kw = dict(sparse_tables=True,
              sparse_table_kwargs=dict(lr=0.05, weight_decay=0.0))
    chunks = _chunks(_loader(train))
    engine = TrainEngine(_model(cfg), optim.adamw(0.05, weight_decay=0.0),
                         chunk_batches=4, replicas=2, **kw)
    engine.init_replica_params([0, 9])
    state = engine.init_opt_state()
    assert state["sparse"]["attraction/table"].count.shape == (2,)
    for chunk in chunks:
        state, _ = engine.step(state, chunk)
    model = _model(cfg)
    _, single, _ = _run_single(model, optim.adamw(0.05, weight_decay=0.0),
                               chunks, **kw)
    for r in range(2):
        for leaf, p in zip(engine.replica_params, model.parameters()):
            assert torch.equal(leaf[r], p.detach())
        _equal(select_replica(state, r), single)


def test_a_frozen_replica_keeps_parameters_moments_and_count(pbm_log):
    cfg, train, _ = pbm_log
    chunks = _chunks(_loader(train, 128))  # 13 batches: 4, 4, 4, 1
    engine = TrainEngine(_model(cfg), optim.adamw(0.05), chunk_batches=4,
                         replicas=3)
    engine.init_replica_params([0, 1, 2])
    state = engine.init_opt_state()
    state, _ = engine.step(state, chunks[0])
    before = [t.clone() for t in engine.replica_params + tree_leaves(state)]
    state, _ = engine.step(state, chunks[1], active=[True, False, True])
    after = engine.replica_params + tree_leaves(state)
    for b, a in zip(before, after):
        assert torch.equal(b[1], a[1])  # replica 1 frozen, to the bit
    for b, a in zip(before, engine.replica_params):
        assert not torch.equal(b[0], a[0])  # replica 0 trained on
    assert [int(c) for c in state[0].count] == [8, 4, 8]
    # the mask persists until the next one
    state, _ = engine.step(state, chunks[2])
    assert [int(c) for c in state[0].count] == [12, 4, 12]


def test_set_replica_lrs_refusals(pbm_log):
    cfg, _, _ = pbm_log
    engine = TrainEngine(_model(cfg), optim.adamw(0.05), replicas=2)
    engine.init_replica_params([0, 1])
    with pytest.raises(ValueError, match="inject_lr"):
        engine.set_replica_lrs(engine.init_opt_state(), [0.05, 0.01])
    engine = TrainEngine(_model(cfg), optim.adamw(0.05, weight_decay=0.0,
                                                  inject_lr=True),
                         replicas=2, sparse_tables=True,
                         sparse_table_kwargs=dict(lr=0.05, weight_decay=0.0))
    engine.init_replica_params([0, 1])
    with pytest.raises(NotImplementedError, match="sparse"):
        engine.set_replica_lrs(engine.init_opt_state(), [0.05, 0.01])
    with pytest.raises(ValueError, match="replicas=R"):
        TrainEngine(_model(cfg), optim.adamw(0.05)).set_replica_lrs({}, [1])


def test_trainer_replica_knob_validation():
    with pytest.raises(ValueError, match="replica"):
        Trainer(optim.adamw(0.05), replica_lrs=[0.1, 0.2], device="cpu")
    with pytest.raises(ValueError, match="replica_seeds"):
        Trainer(optim.adamw(0.05), replicas=3, replica_seeds=[1, 2],
                device="cpu")


def test_replica_histories_diverge_across_seeds(tower_log):
    cfg, train, _ = tower_log
    trainer = Trainer(optim.adamw(0.05), epochs=2, patience=100,
                      log_fn=_quiet, chunk_batches=4, replicas=4,
                      replica_seeds=[0, 1, 2, 3], device="cpu")
    history = trainer.train(_tower(cfg), _loader(train, 128))
    first = history[0]["train_loss"]
    assert isinstance(first, list) and len(first) == 4
    assert len(set(first)) == 4, f"replica losses identical: {first}"
    assert history[0]["active"] == [True] * 4


def test_default_replica_seeds_count_up_from_the_trainer_seed(tower_log):
    """Replica r of ``Trainer(replicas=R, seed=s)`` starts as the model
    built with seed s + r (no epoch run: the initial state)."""
    cfg, train, _ = tower_log
    trainer = Trainer(optim.adamw(0.05), epochs=0, log_fn=_quiet,
                      chunk_batches=4, replicas=2, seed=5, device="cpu")
    assert trainer.train(_tower(cfg), _loader(train, 128)) == []
    params = trainer._final_state.params
    for r in range(2):
        want = _tower(cfg, 5 + r).parts["attraction"]
        got = params["attraction"]
        for name, p in want.named_parameters():
            leaf = got
            for key in name.split("."):
                leaf = leaf[key]
            assert torch.equal(leaf[r], p.detach()), name


def test_sweep_early_stopping_matches_sequential_trainers(pbm_log):
    """A replica that runs out of patience freezes in place; its final
    parameters and validation metrics equal the sequential Trainer's with
    the same learning rate, to the bit, also when one replica stops epochs
    before the other."""
    cfg, train, val = pbm_log
    lrs, epochs = [0.5, 0.01], 8
    seq_params, seq_vals, seq_epochs = [], [], []
    for lr in lrs:
        model = _model(cfg)
        t = Trainer(optim.adamw(lr), epochs=epochs, patience=1,
                    log_fn=_quiet, chunk_batches=4, device="cpu")
        h = t.train(model, _loader(train), _val(val))
        seq_params.append([p.detach().clone() for p in model.parameters()])
        seq_vals.append(h[-1]["val_ll"])
        seq_epochs.append(len(h))
    assert seq_epochs[0] != seq_epochs[1]
    sweep = Trainer(optim.adamw(0.99, inject_lr=True), epochs=epochs,
                    patience=1, log_fn=_quiet, chunk_batches=4, replicas=2,
                    replica_lrs=lrs, device="cpu")
    model = _model(cfg)
    h = sweep.train(model, _loader(train), _val(val))
    assert len(h) == max(seq_epochs)
    final = sweep._final_state.params
    for i in range(2):
        for leaf, want in zip(
                [final["attraction"]["table"], final["examination"]["table"]],
                seq_params[i]):
            assert torch.equal(leaf[i], want)
        assert h[seq_epochs[i] - 1]["val_ll"][i] == seq_vals[i]
        assert h[-1]["val_ll"][i] == seq_vals[i]
    stop_first = min(seq_epochs)
    i_first = seq_epochs.index(stop_first)
    assert h[stop_first - 1]["active"][i_first] is True
    assert h[stop_first]["active"][i_first] is False


def test_sweep_resume_keeps_stopped_replicas_frozen(tmp_path, pbm_log):
    cfg, train, val = pbm_log
    lrs, epochs = [0.5, 0.01], 8

    def make_trainer(n_epochs, ckpt_dir=None):
        return Trainer(optim.adamw(0.99, inject_lr=True), epochs=n_epochs,
                       patience=1, log_fn=_quiet, chunk_batches=4,
                       replicas=2, replica_lrs=lrs, checkpoint_dir=ckpt_dir,
                       device="cpu")

    full = make_trainer(epochs)
    h_full = full.train(_model(cfg), _loader(train), _val(val))
    stopped = [r["epoch"] for r in h_full if not all(r["active"])]
    assert stopped, "no replica stopped"
    e0 = stopped[0] - 1
    make_trainer(e0, str(tmp_path / "sweep")).train(
        _model(cfg), _loader(train), _val(val))
    resumed = make_trainer(epochs, str(tmp_path / "sweep"))
    h_resumed = resumed.train(_model(cfg), _loader(train), _val(val),
                              resume=True)
    strip = [{k: v for k, v in r.items() if k != "seconds"}
             for r in h_full]
    assert [{k: v for k, v in r.items() if k != "seconds"}
            for r in h_resumed] == strip
    _equal(full._final_state.params, resumed._final_state.params)
    _equal(full._final_state.opt_state, resumed._final_state.opt_state)


def test_select_replica_roundtrips_through_checkpoint(tmp_path, tower_log):
    cfg, train, val = tower_log
    trainer = Trainer(optim.adamw(0.05), epochs=2, patience=100,
                      log_fn=_quiet, chunk_batches=4, replicas=3,
                      replica_seeds=[0, 1, 2],
                      checkpoint_dir=str(tmp_path / "sweep"), device="cpu")
    model = _tower(cfg)
    trainer.train(model, _loader(train, 128))
    final = trainer._final_state
    like = {"params": final.params, "opt_state": final.opt_state}
    restored, aux, _ = trainer.ckpt.restore(like=like)
    _equal(like, restored)
    assert aux["epoch"] == 2 and aux["early_stop"]["active"] == [True] * 3
    single = Trainer(optim.adamw(0.05), log_fn=_quiet, device="cpu")
    sweep_metrics = trainer.evaluate(model, _val(val), params=final.params,
                                     replicas=3)
    for i in range(3):
        p_i = select_replica(restored["params"], i)
        out = single.evaluate(model, _val(val), params=p_i)
        assert out["ll"] == sweep_metrics["ll"][i]
        solo = trainer.test(model, _val(val), params=p_i)
        assert solo["ll"] == sweep_metrics["ll"][i]
        assert len(solo["per_rank"]["ppl"]) == cfg.positions
    full = trainer.test(model, _val(val))
    assert len(full["ll"]) == 3 and len(full["per_rank"]["ll"]) == 3
    _equal(stack_replicas([select_replica(restored["params"], i)
                           for i in range(3)]), final.params)


# -- the non-finite guard ------------------------------------------------------

def test_nonfinite_guard_skips_the_step_jax_skips(pbm_log):
    """A chunk with a NaN batch: the port's guarded engine reports JAX's
    skip flags and losses (NaN at the poisoned step, the rest within
    1e-5), and its parameters stay finite."""
    cfg, train, _ = pbm_log
    batches = list(iter(_loader(train)))[:4]
    batches[2] = dict(batches[2], clicks=np.full_like(batches[2]["clicks"],
                                                      np.nan))
    chunk = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jm = jcore.PositionBasedModel(query_doc_pairs=cfg.n_query_doc_pairs,
                                  positions=cfg.positions, init_prob=0.2)
    jengine = JaxEngine(jm, jopt.adamw(0.05), chunk_batches=4,
                        nonfinite_guard=True)
    jparams = jm.init(jax.random.PRNGKey(0))
    _, _, want = jengine.step(jparams, jengine.init_opt_state(jparams),
                              chunk)
    model = _model(cfg)
    engine = TrainEngine(model, optim.adamw(0.05), chunk_batches=4,
                         nonfinite_guard=True)
    state, got = engine.step(engine.init_opt_state(),
                             {k: torch.from_numpy(v)
                              for k, v in chunk.items()})
    assert got["skipped"].tolist() == np.asarray(want["skipped"]).tolist() \
        == [False, False, True, False]
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                               atol=1e-5)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert int(state[0].count) == 3


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_guarded_run_equals_the_run_without_the_poisoned_batch(pbm_log,
                                                               route):
    cfg, train, _ = pbm_log
    kw = (dict(sparse_tables=True,
               sparse_table_kwargs=dict(lr=0.05, weight_decay=1e-4))
          if route == "sparse" else {})
    batches = list(iter(_loader(train)))[:8]
    poisoned = batches[:5] + [dict(batches[5], clicks=np.full_like(
        batches[5]["clicks"], np.nan))] + batches[5:]

    def run(bs, guard):
        model = _model(cfg)
        engine = TrainEngine(model, optim.adamw(0.05), chunk_batches=3,
                             nonfinite_guard=guard, **kw)
        state = engine.init_opt_state()
        for lo in range(0, len(bs), 3):
            group = bs[lo:lo + 3]
            state, _ = engine.step(state, {
                k: torch.from_numpy(np.stack([b[k] for b in group]))
                for k in group[0]})
        return [p.detach() for p in model.parameters()], state

    p_guard, s_guard = run(poisoned, True)
    p_clean, s_clean = run(batches, False)
    for a, b in zip(p_guard, p_clean):
        assert torch.equal(a, b)
    _equal(s_guard, s_clean)


def test_trainer_nonfinite_guard_counts_and_stays_finite(pbm_log):
    cfg, train, _ = pbm_log
    model = _model(cfg)
    loader = NonFiniteBatchInjector(_loader(train, 64), at_steps=[2, 40])
    trainer = Trainer(optim.adamw(0.05), epochs=2, patience=100,
                      chunk_batches=3, nonfinite_guard=True, log_fn=_quiet,
                      device="cpu")
    history = trainer.train(model, loader)
    assert [r["skipped_steps"] for r in history] == [1, 1]
    assert all(np.isfinite(r["train_loss"]) for r in history)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_trainer_guard_off_poisoned_params_diverge(pbm_log):
    cfg, train, _ = pbm_log
    loader = NonFiniteBatchInjector(_loader(train, 64), at_steps=[2])
    trainer = Trainer(optim.adamw(0.05), epochs=1, patience=100,
                      chunk_batches=3, log_fn=_quiet, device="cpu")
    history = trainer.train(_model(cfg), loader)
    assert "skipped_steps" not in history[0]
    assert not np.isfinite(history[0]["train_loss"])


def test_nonfinite_guard_replicas(pbm_log):
    cfg, train, _ = pbm_log
    loader = NonFiniteBatchInjector(_loader(train, 64), at_steps=[1])
    trainer = Trainer(optim.adamw(0.05), epochs=1, patience=100, replicas=2,
                      chunk_batches=3, nonfinite_guard=True, log_fn=_quiet,
                      device="cpu")
    history = trainer.train(_model(cfg), loader)
    assert history[0]["skipped_steps"] == [1, 1]
    assert all(np.isfinite(v) for v in history[0]["train_loss"])


# -- bit-exact resume ----------------------------------------------------------

def _history(h):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in h]


def test_resume_at_an_epoch_end_is_bit_exact(tmp_path, pbm_log):
    cfg, train, val = pbm_log

    def run(epochs, ckpt_dir, resume=False):
        model = _model(cfg)
        trainer = Trainer(optim.adamw(0.01), epochs=epochs, patience=100,
                          checkpoint_dir=ckpt_dir, log_fn=_quiet,
                          chunk_batches=4, device="cpu")
        h = trainer.train(model, _loader(train), _val(val), resume=resume)
        return trainer._final_state, h

    full, h_full = run(4, str(tmp_path / "full"))
    run(2, str(tmp_path / "resume"))
    resumed, h_resumed = run(4, str(tmp_path / "resume"), resume=True)
    _equal(full.params, resumed.params)
    _equal(full.opt_state, resumed.opt_state)
    assert _history(h_resumed) == _history(h_full)
    assert (resumed.epoch, resumed.global_step) == (4, full.global_step)


@pytest.mark.parametrize("guard", [False, True])
def test_mid_epoch_preemption_resume_is_bit_exact(tmp_path, pbm_log, guard):
    """SIGTERM at batch 9 of a 6-batch epoch (the staging thread of the
    overlap prefetcher produces it ahead of the step that consumes it):
    the preemption checkpoint records the loader state of the last chunk
    consumed and the epoch's running sums, and a fresh Trainer resumed from
    it ends on the uninterrupted run's parameters, optimizer state and
    history, to the bit."""
    cfg, train, val = pbm_log

    def trainer(ckpt_dir):
        return Trainer(optim.adamw(0.02), epochs=3, patience=100,
                       checkpoint_dir=ckpt_dir, checkpoint_every_steps=4,
                       keep_checkpoints=1, handle_preemption=True,
                       chunk_batches=2, nonfinite_guard=guard, log_fn=_quiet,
                       device="cpu")

    base = NonFiniteBatchInjector(_loader(train), at_steps=[3] if guard
                                  else [])
    full = trainer(str(tmp_path / "full"))
    h_full = full.train(_model(cfg), base, _val(val))
    ckpt = str(tmp_path / "killed")
    before = signal.getsignal(signal.SIGTERM)
    killed = trainer(ckpt)
    loader = KillSwitch(NonFiniteBatchInjector(
        _loader(train), at_steps=[3] if guard else []), after_batches=9,
        sig=signal.SIGTERM)
    h_part = killed.train(_model(cfg), loader, _val(val))
    assert loader.fired and len(h_part) == 1
    assert signal.getsignal(signal.SIGTERM) is before
    step = killed.ckpt.latest_step()
    assert 6 < step < 18 and step % 2 == 0
    resumed = trainer(ckpt)
    h_resumed = resumed.train(_model(cfg), NonFiniteBatchInjector(
        _loader(train), at_steps=[]), _val(val), resume=True)
    assert _history(h_resumed) == _history(h_full)
    _equal(full._final_state.params, resumed._final_state.params)
    _equal(full._final_state.opt_state, resumed._final_state.opt_state)


def test_train_from_a_given_state_copies_it_in(pbm_log):
    cfg, train, _ = pbm_log
    donor = _model(cfg)
    t0 = Trainer(optim.adamw(0.05), epochs=1, log_fn=_quiet, chunk_batches=4,
                 device="cpu")
    t0.train(donor, _loader(train))
    model = _model(cfg)
    t1 = Trainer(optim.adamw(0.05), epochs=2, log_fn=_quiet, chunk_batches=4,
                 device="cpu")
    t1.train(model, _loader(train), state=TrainState(
        params=t0._final_state.params, opt_state=t0._final_state.opt_state,
        epoch=1, global_step=t0._final_state.global_step))
    t0.epochs = 2
    t0.train(donor, _loader(train), state=t0._final_state)
    for a, b in zip(model.parameters(), donor.parameters()):
        assert torch.equal(a, b)


# -- the launcher --------------------------------------------------------------

LAUNCH = ["--sessions", "3000", "--epochs", "3", "--batch", "256",
          "--compression", "hash", "--ratio", "10", "--device", "cpu"]


def test_launcher_validates_the_sweep_flags(capsys):
    for argv, msg in (
            (["--replica-lrs", "0.1"], "require --replicas"),
            (["--replicas", "2", "--replica-seeds", "1"], "exactly"),
            (["--replicas", "2", "--replica-lrs", "0.1", "0.2",
              "--sparse-tables"], "not supported"),
            (["--max-restarts", "1"], "requires --ckpt-dir")):
        with pytest.raises(SystemExit):
            launch_train.main(LAUNCH + argv)
        assert msg in capsys.readouterr().err


def test_launcher_trains_a_sweep_on_the_cpu(capsys):
    results = launch_train.main(LAUNCH + [
        "--replicas", "2", "--replica-lrs", "0.003", "0.01",
        "--nonfinite-guard", "--epochs", "1"])
    assert len(results["ll"]) == 2 and results["ll"][0] != results["ll"][1]
    out = capsys.readouterr().out
    assert "test replica 1:" in out and "skipped_steps" in out


def test_launcher_sigkill_drill_ends_on_the_uninterrupted_run(
        tmp_path, capfd, monkeypatch):
    """``--fault-kill-at-step 12 --max-restarts 1``: the supervised child
    dies at batch 12 (epoch 2, after epoch 1's checkpoint), the relaunched
    child resumes and ends on the uninterrupted run's epoch records and
    test metrics."""
    monkeypatch.setenv("PYTHONPATH", os.path.join(ROOT, "src"))

    def records(out):
        lines = out.splitlines()
        epochs = [line.split("'seconds'")[0] + line.split("'val_ll'")[1]
                  for line in lines if line.startswith("[trainer] {")]
        return epochs, [line for line in lines
                        if line.startswith("[train] test")]

    ckpt = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as exit_:
        launch_train.main(LAUNCH + ["--ckpt-dir", ckpt,
                                    "--fault-kill-at-step", "12",
                                    "--max-restarts", "1"])
    out = capfd.readouterr().out
    assert exit_.value.code == 0
    assert "relaunching" in out and "completed after 1 restart" in out
    assert "resumed at epoch=1" in out
    epochs, tests = records(out)
    launch_train.main(LAUNCH)
    want_epochs, want_tests = records(capfd.readouterr().out)
    assert epochs[-2:] == want_epochs[-2:] and tests == want_tests
