"""Sparse tables on meshes whose ``model`` axis is larger than one, on the
CPU.

One spawned gloo world of 8 ranks (``tests/_dist_worlds.py``,
``task_sparse8``) beside one JAX subprocess with
``--xla_force_host_platform_device_count=8``: the DBN whose 65,536-row
hashed tables ``clax_param_rule`` row-shards over ``model``, trained with
``sparse_tables=True`` (lazy AdamW on each rank's rows of the tables, the
moments sharded with them):

* on ``(2, 4)`` against JAX's ``(2, 4)`` sparse run: parameters,
  ``train_loss`` and ``val_ll`` at 1e-5, the tables really cut to 16,384
  rows a rank;
* on ``(8, 1)`` and ``(1, 8)`` against the port's single-process sparse
  run at 1e-5;
* a NaN in the attraction table's gradient on model rank 1 alone (rows
  only it owns) at step 1 of a chunk: every rank skips that step, and the
  parameters are the single process's over the chunk without that batch;
* telemetry's norms and the guard's flags against the single process's;
* a checkpoint of ``(2, 4)`` after epoch 1 (the sparse moments gathered
  to rank 0 as full tables) restored onto ``(1, 8)`` and onto one process,
  each trained on to the uninterrupted ``(2, 4)`` run at 1e-5.
"""
import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

import _dist_worlds as W
from repro_torch.train import CheckpointManager

TOL = 1e-5
ROWS = 1 << 16

JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from repro import optim
from repro.compat import make_auto_mesh
from repro.core import (Compression, DynamicBayesianNetwork,
                        EmbeddingParameterConfig)
from repro.data import (ClickLogLoader, SyntheticConfig, generate_click_log,
                        split_sessions)
from repro.train import Trainer

dcfg = SyntheticConfig(n_sessions=1600, n_queries=25, docs_per_query=12,
                       positions=6, behavior="dbn", seed=7)
data, _ = generate_click_log(dcfg)
train, val, _ = split_sessions(data, (0.8, 0.1, 0.1), seed=0)
emb = EmbeddingParameterConfig(parameters=655_360,
                               compression=Compression.HASH,
                               compression_ratio=10.0,
                               baseline_correction=True, init_logit=-2.0)
model = DynamicBayesianNetwork(positions=6, attraction=emb, satisfaction=emb)
trainer = Trainer(optim.adamw(0.01), epochs=2, patience=100,
                  log_fn=lambda *_: None, chunk_batches=4,
                  mesh=make_auto_mesh((2, 4), ("data", "model")),
                  sparse_tables=True,
                  sparse_table_kwargs=dict(lr=0.01, weight_decay=1e-4))
hist = trainer.train(
    model, ClickLogLoader(train, batch_size=256, seed=5),
    ClickLogLoader(val, batch_size=128, shuffle=False, drop_last=False))
params = trainer._final_state.params
assert params["attraction"]["table"].sharding.spec[0] == "model"
np.savez(sys.argv[1], **{
    ".".join(str(k.key) for k in path): np.asarray(v)
    for path, v in jax.tree_util.tree_leaves_with_path(params)})
with open(sys.argv[2], "w") as f:
    json.dump(hist, f)
print("JAX_SPARSE_OK")
"""


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory() as tmp:
        arrays, hist = os.path.join(tmp, "j.npz"), os.path.join(tmp, "h.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
            os.path.dirname(__file__), "..", "src"))
        proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, arrays,
                                 hist], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        ckpt = os.path.join(tmp, "ckpt")
        try:
            ranks = W.spawn("sparse8", 8, timeout=300, ckpt=ckpt)
            out, err = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        assert "JAX_SPARSE_OK" in out
        jax_params = dict(np.load(arrays))
        with open(hist) as f:
            jax_hist = json.load(f)
        # the single-process references, from the same numpy inputs
        train, val, _ = W.dbn_data()
        single = W.dbn_run(None, train, val, epochs=2, sparse=True)
        resumed = W.dbn_run(None, train, val, epochs=2, ckpt=ckpt,
                            resume=True, sparse=True)
        saved = CheckpointManager(ckpt).restore()[0]
        refs = {"telemetry": W.dbn_sparse_chunk(None, train),
                "skipped": W.dbn_sparse_chunk(None, train, which=(0, 2, 3))}
    np_of = {n: W._np(p) for n, p in single[1].items()}
    return SimpleNamespace(
        ranks=ranks, jax=jax_params, jax_hist=jax_hist,
        single=(single[0], np_of), refs=refs, saved=saved,
        resumed=(resumed[0], {n: W._np(p) for n, p in resumed[1].items()}))


def _close_params(got, want):
    assert set(got) == set(want)
    for name, v in got.items():
        np.testing.assert_allclose(v, want[name], rtol=TOL, atol=TOL,
                                   err_msg=name)


def _close_history(got, want, keys=("train_loss", "val_ll")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            assert abs(g[k] - w[k]) < TOL, (k, g[k], w[k])


def test_sparse_tables_on_2x4_match_jax(world):
    for r in world.ranks:
        history, params, rows = r[(2, 4)]
        assert rows == ROWS // 4  # really row-sharded
        _close_params(params, world.jax)
        _close_history(history, world.jax_hist)


@pytest.mark.parametrize("shape,rows", [((8, 1), ROWS), ((1, 8), ROWS // 8)])
def test_sparse_tables_match_the_single_process(world, shape, rows):
    want_h, want_p = world.single
    for r in world.ranks:
        history, params, local = r[shape]
        assert local == rows
        _close_params(params, want_p)
        _close_history(history, want_h)


def test_nan_in_one_model_ranks_rows_is_skipped_on_every_rank(world):
    """Only model rank 1 sees the NaN (its rows of the table's gradient);
    the flag reduced over ``model`` skips the step everywhere, and the
    chunk's parameters are those of the chunk without that batch."""
    _, want = world.refs["skipped"]
    for r in world.ranks:
        series, params = r["poisoned"]
        assert series["skipped"].tolist() == [False, True, False, False]
        assert np.isfinite(series["loss"]).all()
        _close_params(params, want)


def test_sparse_telemetry_is_global(world):
    """Every step's loss, grad_norm and param_norm on (2, 4): the single
    process's at 1e-5 (row gradients' and shards' sums of squares summed
    over ``model``)."""
    want, want_p = world.refs["telemetry"]
    assert set(want) == {"loss", "skipped", "grad_norm", "param_norm"}
    for r in world.ranks:
        got, params = r["telemetry"]
        assert not got["skipped"].any()
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        _close_params(params, want_p)


def test_checkpoint_holds_full_sparse_moments(world):
    for leaf in ("mu", "nu"):
        for table in ("attraction", "satisfaction"):
            key = f"opt_state/sparse/{table}/table/.{leaf}"
            assert world.saved[key].shape[0] == ROWS, key
    assert world.saved["params/attraction/table"].shape[0] == ROWS


@pytest.mark.parametrize("onto", ["1x8", "one_process"])
def test_sparse_checkpoint_of_2x4_restores(world, onto):
    for r in (world.ranks if onto == "1x8" else world.ranks[:1]):
        want_h, want_p = r[(2, 4)][:2]
        history, params = (r["elastic"] if onto == "1x8"
                           else world.resumed)
        assert len(history) == 2
        _close_history(history[1:], want_h[1:])
        _close_params(params, want_p)
