"""The recsys models on a mesh, and the engine's roofline, on the CPU.

Reduced DeepFM (plain, hashed and quotient-remainder tables), AutoInt, BST
(plain and hashed) and MIND on spawned gloo worlds of 4
(``tests/_dist_worlds.py``, ``task_recsys4``) as ``(2, 2)`` and ``(1, 4)``:
each rank holds its rows of every table (``place_``), runs its rows of the
batch, and sums what its lookups own over ``model``. Two AdamW steps must
give the losses and parameters of two references within 1e-5: the port
without a mesh and JAX's unsharded train step, from the same JAX
parameters and numpy batches. The ids run past the tables (clipped, or
hashed, globally before a shard masks them), MIND's histories are padded,
and BST's retrieval bags its history with the mean combiner (the global
count of live ids) with padding and ids past the table in it.

Also JAX's roofline tests, ported (``tests/test_obs.py``): the Trainer
emits one ``roofline`` event in its span, and the engine's bytes grow more
than 1.5x from 2 to 4 chunk batches; and ``roofline`` leaves every
parameter and moment equal to the bit.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

import _dist_worlds as W
from repro import optim as joptim
from repro.models import recsys as jrecsys
from repro_torch import core as tcore
from repro_torch import optim as toptim
from repro_torch.convert import load_jax_params
from repro_torch.data import (ClickLogLoader, SyntheticConfig,
                              generate_click_log, split_sessions)
from repro_torch.obs import MemorySink, Recorder
from repro_torch.train import TrainEngine, Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 1e-2
B = 16
#: name -> (arch, config overrides)
CASES = {
    "deepfm": ("deepfm", {}),
    "deepfm_hash": ("deepfm", dict(compression="hash",
                                   compression_ratio=3.0)),
    "deepfm_qr": ("deepfm", dict(compression="qr", compression_ratio=4.0)),
    "autoint": ("autoint", {}),
    "bst": ("bst", {}),
    "bst_hash": ("bst", dict(compression="hash", compression_ratio=3.0)),
    "mind": ("mind", {}),
}
JAX_MODELS = {"deepfm": jrecsys.DeepFM, "autoint": jrecsys.AutoInt,
              "bst": jrecsys.BST, "mind": jrecsys.MIND}


def _cfg(pkg, arch, overrides):
    conf = importlib.import_module(f"{pkg}.configs.{arch}")
    return dataclasses.replace(conf.reduced(), **overrides)


def _batches(arch, cfg, rng):
    """Two training batches and a retrieval batch; ids up to 1.5x past the
    table (or far past it, hashed), histories with padding."""
    rows = cfg.table_rows if arch in ("deepfm", "autoint") \
        else cfg.item_vocab
    hi = rows * (7 if cfg.compression != "none" else 1.5)

    def ids(shape, pad=False):
        out = rng.integers(0, int(hi), shape).astype(np.int32)
        if pad:
            out[rng.random(shape) < 0.25] = -1
        return out

    def labels():
        return (rng.random(B) < 0.4).astype(np.float32)

    if arch in ("deepfm", "autoint"):
        train = [{"field_ids": ids((B, cfg.n_sparse)), "labels": labels()}
                 for _ in range(2)]
        return train, {"field_ids": ids((8, cfg.n_sparse))}
    L = cfg.seq_len if arch == "bst" else cfg.history_len
    pad = arch == "mind"
    train = [{"history_ids": ids((B, L), pad), "target_ids": ids((B,)),
              "labels": labels()} for _ in range(2)]
    history = ids((1, L))
    history[0, 0] = -1
    history[0, -1] = int(hi) + 3
    return train, {"history_ids": history, "candidate_ids": ids((8,))}


@pytest.fixture(scope="module")
def cases():
    """Per case: the JAX parameters, the batches, and JAX's losses,
    parameters and retrieval scores."""
    out = {}
    rng = np.random.default_rng(3)
    for name, (arch, overrides) in CASES.items():
        cfg = _cfg("repro", arch, overrides)
        jm = JAX_MODELS[arch](cfg)
        params = jax.device_get(jm.init(jax.random.PRNGKey(1)))
        train, retrieval = _batches(arch, cfg, rng)
        opt = joptim.adamw(LR)
        step = jax.jit(jm.make_train_step(opt))
        p, state, losses = params, opt.init(params), []
        for batch in train:
            p, state, loss = step(p, state, batch)
            losses.append(float(loss))
        out[name] = {"arch": arch, "overrides": overrides, "params": params,
                     "batches": train, "retrieval": retrieval,
                     "jax": {"losses": losses,
                             "params": _flat(jax.device_get(p)),
                             "scores": np.asarray(jm.retrieval_score(
                                 p, retrieval))}}
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {".".join(prefix): np.asarray(tree)}


@pytest.fixture(scope="module")
def no_mesh(cases):
    """The port without a mesh, from the same parameters."""
    out = {}
    for name, case in cases.items():
        conf = importlib.import_module(
            f"repro_torch.configs.{case['arch']}")
        model = conf.make_model(device="cpu", cfg=_cfg(
            "repro_torch", case["arch"], case["overrides"]))
        load_jax_params(model, case["params"])
        step = model.make_train_step(toptim.adamw(LR))
        state, losses = step.init(), []
        for batch in case["batches"]:
            state, loss = step(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
            losses.append(float(loss))
        with torch.no_grad():
            scores = model.retrieval_score(
                {k: torch.from_numpy(v)
                 for k, v in case["retrieval"].items()}).numpy()
        out[name] = {"losses": losses, "params": W._named(model),
                     "scores": scores}
    return out


def _assemble(results, name, shape):
    """The full parameters and scores from the ranks' blocks: tables from
    data rank 0's model ranks in order, towers from rank 0, scores from
    model rank 0's data ranks in order."""
    ranks = {r[name]["coords"]: r[name] for r in results}
    first = ranks[(0, 0)]
    params = {}
    for path, block in first["params"].items():
        if path.split(".")[0] in ("embedding", "first_order"):
            params[path] = np.concatenate(
                [ranks[(0, m)]["params"][path] for m in range(shape[1])])
        else:
            params[path] = block
    axis = 0 if first["scores"].ndim == 1 else 1
    scores = np.concatenate([ranks[(d, 0)]["scores"]
                             for d in range(shape[0])], axis=axis)
    return first["losses"], params, scores


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)],
                ids=["2x2", "1x4"])
def meshed(request, cases):
    shape = request.param
    payload = {name: {k: case[k] for k in ("arch", "overrides", "params",
                                           "batches", "retrieval")}
               for name, case in cases.items()}
    results = W.spawn("recsys4", 4, timeout=150, shape=shape, cases=payload,
                      lr=LR)
    return shape, results


@pytest.mark.parametrize("name", list(CASES))
def test_recsys_on_a_mesh_matches_no_mesh_and_jax(meshed, cases, no_mesh,
                                                 name):
    shape, results = meshed
    losses, params, scores = _assemble(results, name, shape)
    # every rank reports the global loss
    for r in results:
        np.testing.assert_allclose(r[name]["losses"], losses, **TOL)
    for ref in (no_mesh[name], cases[name]["jax"]):
        np.testing.assert_allclose(losses, ref["losses"], **TOL)
        assert set(params) == set(ref["params"])
        for path, value in params.items():
            np.testing.assert_allclose(value, ref["params"][path],
                                       err_msg=path, **TOL)
        np.testing.assert_allclose(scores, ref["scores"], **TOL)


def test_tables_are_cut_to_a_ranks_rows(meshed, cases):
    shape, results = meshed
    r = results[0]["deepfm"]["params"]
    full = cases["deepfm"]["params"]["embedding"]["table"].shape[0]
    assert r["embedding.table"].shape[0] == full // shape[1]
    assert r["first_order.table"].shape[0] == full // shape[1]
    assert r["mlp.layer_0.kernel"].shape == \
        cases["deepfm"]["params"]["mlp"]["layer_0"]["kernel"].shape


# ---------------------------------------------------------------------------
# the engine's roofline (JAX's tests/test_obs.py, ported)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_log():
    cfg = SyntheticConfig(n_sessions=1200, n_queries=120, docs_per_query=10,
                          positions=6, behavior="dbn", seed=5)
    data, _ = generate_click_log(cfg)
    return cfg, split_sessions(data, (0.8, 0.1, 0.1), seed=5)[0]


def _model(cfg):
    emb = tcore.EmbeddingParameterConfig(
        parameters=cfg.n_query_doc_pairs, compression=tcore.Compression.HASH,
        compression_ratio=2.0, baseline_correction=True, init_logit=-2.0)
    return tcore.DynamicBayesianNetwork(
        query_doc_pairs=cfg.n_query_doc_pairs, positions=cfg.positions,
        attraction=emb, satisfaction=emb, device="cpu")


def _chunk(data, n=4, batch=64):
    batches = list(ClickLogLoader(data, batch_size=batch, seed=1))[:n]
    return {k: torch.from_numpy(np.stack([b[k] for b in batches]))
            for k in batches[0]}


def test_trainer_emits_spans_and_roofline(small_log):
    cfg, data = small_log
    sink = MemorySink()
    trainer = Trainer(toptim.adamw(0.05), epochs=1, patience=100,
                      chunk_batches=4, recorder=Recorder(sinks=[sink]),
                      emit_roofline=True, device="cpu",
                      log_fn=lambda *_: None)
    trainer.train(_model(cfg), ClickLogLoader(data, batch_size=64, seed=5),
                  ClickLogLoader(data, batch_size=256, shuffle=False,
                                 drop_last=False))
    span_names = {e["name"] for e in sink.by_kind("span")}
    assert {"epoch", "eval", "roofline"} <= span_names
    (rf,) = sink.by_kind("roofline")
    assert rf["data"]["bytes"] > 0 and rf["data"]["chunk_batches"] == 4
    assert rf["data"]["unknown_trip_loops"] == 0
    assert rf["data"]["flops_per_step"] == rf["data"]["flops"] / 4


def test_engine_roofline_scales_with_chunk(small_log):
    cfg, data = small_log
    model = _model(cfg)

    def cost(n):
        eng = TrainEngine(model, toptim.adamw(0.05), chunk_batches=n)
        return eng.roofline(eng.init_opt_state(), _chunk(data, n=n))

    c2, c4 = cost(2), cost(4)
    assert c4["chunk_batches"] == 4 and c2["chunk_batches"] == 2
    # every iteration runs: doubling the chunk ~doubles the traffic
    assert c4["bytes"] > 1.5 * c2["bytes"]
    assert c4["peak_bytes"] > 0


def test_roofline_leaves_parameters_and_moments_to_the_bit(small_log):
    cfg, data = small_log
    model = _model(cfg)
    eng = TrainEngine(model, toptim.adamw(0.05), chunk_batches=2)
    state = eng.init_opt_state()
    state, _ = eng.step(state, _chunk(data, n=2))  # moments away from 0
    before = [t.clone() for t in list(model.parameters())
              + _leaves(state)]
    eng.roofline(state, _chunk(data, n=2))
    after = list(model.parameters()) + _leaves(state)
    assert len(before) == len(after)
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    assert all(p.grad is None for p in model.parameters())


def _leaves(state):
    from repro_torch.tree import tree_leaves

    return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
