"""The port's Trainer on a mesh against JAX's 8-device runs, on the CPU.

Two spawned gloo worlds (``tests/_dist_worlds.py``) beside one JAX
subprocess with ``--xla_force_host_platform_device_count=8`` (as JAX's
``tests/test_engine.py`` runs its data-parallel script):

* a world of 8: the PBM of JAX's data-parallel script on the ``(8, 1)``
  mesh (parameters, ``train_loss`` and ``val_ll`` at 1e-5 against JAX's
  8-device run, the same on every rank) and the two ``ValueError``\\ s;
  masks of uneven counts across the ranks, equal at 1e-5 to the single
  process, where averaging the ranks' gradients by 1/dp is not; a NaN in
  one rank's rows, skipped by the guard on every rank, equal to the
  guarded single process; sparse tables on ``(8, 1)`` against the dense
  single process where every row is touched (1e-5: ROADMAP C, fact 1);
  the DBN whose 65,536-row hashed tables ``clax_param_rule`` row-shards
  on a ``(2, 4)`` mesh, against JAX's ``(2, 4)`` run at 1e-5; and its
  checkpoint after epoch 1 restored onto a ``(1, 8)`` mesh (each rank
  cutting the full tables to its rows) and trained on, against the
  uninterrupted ``(2, 4)`` run at 1e-5 (the sums run over other ranks);
* a world of 2: a checkpoint written after epoch 1 (rank 0, full
  tensors) restored by a single process and trained on, against the
  uninterrupted single run at 1e-5 (not to the bit: a world of 2 sums two
  halves of each batch's gradient where one process sums it whole), the
  checkpoint's leaves equal to the world's parameters to the bit; and a
  SIGTERM on rank 1 alone stopping both ranks at one step, with one
  checkpoint at that step.
"""
import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

import _dist_worlds
from repro_torch.train import CheckpointManager

TOL = 1e-5

JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from repro import optim
from repro.compat import make_auto_mesh
from repro.core import (Compression, DynamicBayesianNetwork,
                        EmbeddingParameterConfig, PositionBasedModel)
from repro.data import (ClickLogLoader, SyntheticConfig, generate_click_log,
                        split_sessions)
from repro.train import Trainer
from repro.launch.mesh import make_data_parallel_mesh

def flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}

out, hist = {}, {}
quiet = lambda *_: None
cfg = SyntheticConfig(n_sessions=2200, n_queries=25, docs_per_query=12,
                      positions=6, behavior="pbm", seed=13)
data, _ = generate_click_log(cfg)
train, val, _ = split_sessions(data, (0.8, 0.1, 0.1), seed=0)
model = PositionBasedModel(query_doc_pairs=cfg.n_query_doc_pairs,
                           positions=cfg.positions, init_prob=0.2)
mesh = make_data_parallel_mesh()
assert dict(mesh.shape) == {"data": 8, "model": 1}
trainer = Trainer(optim.adamw(0.05), epochs=2, patience=100, log_fn=quiet,
                  chunk_batches=4, mesh=mesh)
hist["pbm"] = trainer.train(
    model, ClickLogLoader(train, batch_size=256, seed=5),
    ClickLogLoader(val, batch_size=128, shuffle=False, drop_last=False))
out.update({"pbm/" + k: v for k, v in
            flat(trainer._final_state.params).items()})

dcfg = SyntheticConfig(n_sessions=1600, n_queries=25, docs_per_query=12,
                       positions=6, behavior="dbn", seed=7)
ddata, _ = generate_click_log(dcfg)
dtrain, dval, _ = split_sessions(ddata, (0.8, 0.1, 0.1), seed=0)
emb = EmbeddingParameterConfig(parameters=655_360,
                               compression=Compression.HASH,
                               compression_ratio=10.0,
                               baseline_correction=True, init_logit=-2.0)
model = DynamicBayesianNetwork(positions=6, attraction=emb, satisfaction=emb)
trainer = Trainer(optim.adamw(0.01), epochs=2, patience=100, log_fn=quiet,
                  chunk_batches=4,
                  mesh=make_auto_mesh((2, 4), ("data", "model")))
hist["dbn"] = trainer.train(
    model, ClickLogLoader(dtrain, batch_size=256, seed=5),
    ClickLogLoader(dval, batch_size=128, shuffle=False, drop_last=False))
params = trainer._final_state.params
assert params["attraction"]["table"].sharding.spec[0] == "model"
out.update({"dbn/" + k: v for k, v in flat(params).items()})
np.savez(sys.argv[1], **out)
with open(sys.argv[2], "w") as f:
    json.dump(hist, f)
print("JAX_DP_OK")
"""


def _run_jax(tmp):
    arrays, hist = os.path.join(tmp, "jax.npz"), os.path.join(tmp, "h.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, arrays, hist],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)

    def result():
        try:
            out, err = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        assert "JAX_DP_OK" in out
        with open(hist) as f:
            return dict(np.load(arrays)), json.load(f)

    return result


@pytest.fixture(scope="module")
def world8():
    with tempfile.TemporaryDirectory() as tmp:
        jax_result = _run_jax(tmp)
        ranks = _dist_worlds.spawn("train8", 8, timeout=300,
                                   ckpt=os.path.join(tmp, "ckpt"))
        # the single-process references, from the same numpy inputs
        cfg, (train, val, _) = _dist_worlds.pbm_data()
        single = {
            "uneven": _dist_worlds.pbm_run(
                None, _dist_worlds.uneven(train), val, cfg, epochs=1)[:2],
            "nan": _dist_worlds.pbm_run(None, train, val, cfg, epochs=1,
                                        poison=[77],
                                        nonfinite_guard=True)[:2]}
        scfg, (strain, sval, _) = _dist_worlds.pbm_data(every_row=True)
        single["dense"] = _dist_worlds.pbm_run(None, strain, sval, scfg,
                                               epochs=1)[:2]
        single["sparse"] = _dist_worlds.pbm_run(None, strain, sval, scfg,
                                                epochs=1, sparse=True)[:2]
        single["dbn_telemetry"] = _dist_worlds.dbn_engine_step(
            None, _dist_worlds.dbn_data()[0])
        jax_params, jax_hist = jax_result()
    return SimpleNamespace(ranks=ranks, single=single, jax=jax_params,
                           jax_hist=jax_hist)


def _close_params(got, want, prefix=""):
    assert set(got) == {k[len(prefix):] for k in want
                        if k.startswith(prefix)}
    for name, v in got.items():
        np.testing.assert_allclose(v, want[prefix + name], rtol=TOL,
                                   atol=TOL, err_msg=name)


def _close_history(got, want, keys=("train_loss", "val_ll")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            assert abs(g[k] - w[k]) < TOL, (k, g[k], w[k])


def test_pbm_on_8x1_matches_jax_8_devices(world8):
    for history, params in (r["pbm"] for r in world8.ranks):
        _close_params(params, world8.jax, "pbm/")
        _close_history(history, world8.jax_hist["pbm"])
    first = world8.ranks[0]["pbm"][1]
    for r in world8.ranks[1:]:  # replicated: every rank the same bits
        for k, v in r["pbm"][1].items():
            np.testing.assert_array_equal(v, first[k])


@pytest.mark.parametrize("case,needle", [("indivisible", "divisible"),
                                         ("drop_last", "drop_last")])
def test_data_parallel_refusals(world8, case, needle):
    for r in world8.ranks:
        assert r[case] is not None and needle in r[case], r[case]


def test_uneven_masks_take_the_global_masked_mean(world8):
    """Each rank's loss weighted by its count over the global count: the
    single process's run at 1e-5. Weighting by 1/dp instead (the mean of
    the ranks' means) misses it on these masks."""
    want_h, want_p = world8.single["uneven"]
    for r in world8.ranks:
        _close_history(r["uneven"][0], want_h, keys=("train_loss",))
        _close_params(r["uneven"][1], want_p)
    wrong = world8.ranks[0]["uneven_1_over_dp"][1]
    assert max(float(np.abs(wrong[k] - want_p[k]).max())
               for k in want_p) > 100 * TOL


def test_nan_on_one_rank_is_skipped_on_every_rank(world8):
    want_h, want_p = world8.single["nan"]
    assert want_h[0]["skipped_steps"] == 1
    for r in world8.ranks:
        history, params = r["nan"]
        assert history[0]["skipped_steps"] == 1
        _close_history(history, want_h, keys=("train_loss", "val_ll"))
        _close_params(params, want_p)


def test_sparse_tables_on_8x1_match_dense_single_process(world8):
    """Every row touched each step: lazy AdamW over the union of the
    ranks' rows is dense AdamW, at 1e-5 (never to the bit, ROADMAP C
    fact 1); and the single process's sparse run."""
    for want in ("dense", "sparse"):
        want_h, want_p = world8.single[want]
        for r in world8.ranks:
            _close_history(r["sparse"][0], want_h)
            _close_params(r["sparse"][1], want_p)


def test_row_sharded_dbn_on_2x4_matches_jax(world8):
    for r in world8.ranks:
        assert r["dbn_local_rows"] == (1 << 16) // 4  # really sharded
        history, params = r["dbn"]
        _close_params(params, world8.jax, "dbn/")
        _close_history(history, world8.jax_hist["dbn"])


def test_row_sharded_telemetry_and_guard_are_global(world8):
    """One chunk on (2, 4) with telemetry and the guard: every step's
    loss, grad_norm and param_norm those of the single process at 1e-5
    (the row shards' sums of squares summed over 'model'), no step
    skipped."""
    want = world8.single["dbn_telemetry"]
    assert set(want) == {"loss", "skipped", "grad_norm", "param_norm"}
    for r in world8.ranks:
        got = r["dbn_telemetry"]
        assert not got["skipped"].any()
        for k in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


def test_checkpoint_of_2x4_restores_onto_1x8(world8):
    for r in world8.ranks:
        history, params = r["dbn_elastic"]
        want_h, want_p = r["dbn"]
        assert len(history) == 2
        _close_history(history[1:], want_h[1:])
        _close_params(params, want_p)


@pytest.fixture(scope="module")
def world2():
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, ckpt_preempt = (os.path.join(tmp, "c"), os.path.join(tmp, "p"))
        ranks = _dist_worlds.spawn("train2", 2, ckpt=ckpt,
                                   ckpt_preempt=ckpt_preempt)
        cfg, (train, val, _) = _dist_worlds.pbm_data()
        arrays, aux, step = CheckpointManager(ckpt).restore()
        resumed = _dist_worlds.pbm_run(None, train, val, cfg, epochs=2,
                                       ckpt=ckpt, resume=True)[:2]
        straight = _dist_worlds.pbm_run(None, train, val, cfg, epochs=2)[:2]
        latest = CheckpointManager(ckpt_preempt).latest_step()
    return SimpleNamespace(ranks=ranks, arrays=arrays, aux=aux, step=step,
                           resumed=resumed, straight=straight,
                           preempt_latest=latest)


def test_checkpoint_of_a_world_of_2_resumes_in_one_process(world2):
    history, params = world2.ranks[0]["epoch1"]
    assert world2.aux["epoch"] == 1 and world2.step == 6
    for name, v in params.items():
        np.testing.assert_array_equal(
            world2.arrays["params/" + name.replace(".", "/")], v)
    got_h, got_p = world2.resumed
    want_h, want_p = world2.straight
    _close_history(got_h, want_h)
    _close_params(got_p, want_p)


def test_sigterm_on_one_rank_stops_every_rank_at_one_step(world2):
    stops = [(r["preempt"]["global_step"], r["preempt"]["epoch"],
              len(r["preempt"]["history"])) for r in world2.ranks]
    assert stops[0] == stops[1], stops
    step, epoch, epochs_done = stops[0]
    assert 6 < step < 12 and epoch == 1 and epochs_done == 1
    assert world2.preempt_latest == step


LAUNCH = ["--sessions", "3000", "--epochs", "2", "--batch", "256",
          "--compression", "hash", "--ratio", "10", "--device", "cpu"]


def _records(stdout):
    """The launcher's per-epoch records and its test line."""
    import ast

    records = [ast.literal_eval(line.split("] ", 1)[1])
               for line in stdout.splitlines()
               if line.startswith("[trainer] {")]
    test = [line for line in stdout.splitlines()
            if line.startswith("[train] test:")]
    return records, test


@pytest.fixture(scope="module")
def launched():
    """The launcher without a mesh, with ``--data-parallel`` as a world of
    one, and under ``torchrun --nproc-per-node=2`` (gloo), at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"), OMP_NUM_THREADS="1")
    module = ["-m", "repro_torch.launch.train"]
    runs = {
        "plain": [sys.executable] + module + LAUNCH,
        "one": [sys.executable] + module + LAUNCH + ["--data-parallel"],
        "torchrun": [sys.executable, "-m", "torch.distributed.run",
                     "--nproc-per-node=2", "--master-port",
                     str(_dist_worlds._free_port())] + module + LAUNCH
        + ["--data-parallel"]}
    procs = {k: subprocess.Popen(v, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for k, v in runs.items()}
    out = {}
    for k, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, (k, stderr[-3000:])
        out[k] = stdout
    return out


@pytest.mark.parametrize("run,mesh", [
    ("one", "{'data': 1, 'model': 1}"),
    ("torchrun", "{'data': 2, 'model': 1}")])
def test_launcher_data_parallel(launched, run, mesh):
    """``--data-parallel`` prints the mesh once; a world of one gives the
    records of the run without a mesh to the bit, a world of two (rank 0
    alone printing) at 1e-5."""
    stdout = launched[run]
    assert stdout.count("[train] data-parallel mesh:") == 1
    assert f"[train] data-parallel mesh: {mesh}" in stdout
    got, got_test = _records(stdout)
    want, want_test = _records(launched["plain"])
    assert len(got) == len(want) == 2 and len(got_test) == 1
    for g, w in zip(got, want):
        for k in ("train_loss", "val_ll", "val_ppl", "val_cond_ppl"):
            if run == "one":
                assert g[k] == w[k], (k, g[k], w[k])
            else:
                assert abs(g[k] - w[k]) < TOL, (k, g[k], w[k])
    assert got_test == want_test
