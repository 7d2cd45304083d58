"""Parity of the third training slice with the JAX package on the CPU: the
feature towers (Linear, MLP, DeepCrossV2 stacked / parallel / with no deep
tower) behind ``FeatureParameter``, PBM, CM, UBM and the mixture model, the
click-history helpers, the ranking metrics, the Listing-4 two-tower pair in
training, and the launcher's default UBM.

A JAX ``init`` tree goes through ``load_jax_params`` into the port; the same
numpy batch (positions, ids, clicks, a mask with short sessions, (B, K, F)
query-document features) goes to both. Values and every gradient agree at
1e-5, at JAX's initial parameters (tables sitting exactly on their init
constants, where torch's and JAX's derivatives at kinks differ) and at
perturbed ones; on the extreme corpus (|logit| = 36, fully masked rows)
everything stays finite and still agrees. The DeepCrossV2 cross layers run
through the port's ``dcn_cross`` op, whose CPU route is the plain version.
"""
import ast
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro import optim as jopt
from repro.core import base as jbase
from repro.core import parameterization as jparam
from repro.launch import train as jax_launch
from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch.configs import clax_baidu
from repro_torch.convert import load_jax_params
from repro_torch.core import base as tbase
from repro_torch.core import parameterization as tparam
from repro_torch.data import SyntheticConfig, generate_click_log
from repro_torch.launch import train as torch_launch

TOL = dict(rtol=1e-5, atol=1e-5)
B, K, N, F = 48, 10, 700, 8
MODELS = ["pbm", "cm", "ubm"]
PREDICT = ("predict_clicks", "predict_conditional_clicks", "predict_relevance")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, K + 1, (B, 1))
    return {"positions": np.tile(np.arange(1, K + 1, dtype=np.int32), (B, 1)),
            "query_doc_ids": rng.integers(0, N, (B, K)).astype(np.int32),
            "clicks": (rng.random((B, K)) < 0.3).astype(np.float32),
            "mask": np.arange(K)[None, :] < lengths,
            "query_doc_features": rng.normal(size=(B, K, F)).astype(
                np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _tower_configs(mod):
    return {
        "linear": mod.LinearParameterConfig(features=F),
        "mlp": mod.MLPParameterConfig(features=F, hidden=(12, 6)),
        "dcn_stacked": mod.DeepCrossParameterConfig(features=F),
        "dcn_parallel": mod.DeepCrossParameterConfig(
            features=F, cross_layers=3, deep_layers=1,
            combination=mod.Combination.PARALLEL),
        "dcn_no_deep": mod.DeepCrossParameterConfig(features=F,
                                                    cross_layers=2,
                                                    deep_layers=0),
    }


def _attraction(mod, kind):
    if kind == "table":
        return mod.EmbeddingParameterConfig(
            parameters=N, compression=mod.Compression.HASH,
            compression_ratio=3.0)
    return _tower_configs(mod)["dcn_stacked"]


def _perturb(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape) * scale,
                                  jnp.float32), tree)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _named(model):
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        out[tuple(parts[1:] if parts[0] == "parts" else parts)] = p
    return out


def _assert_grads(tmodel, jgrads):
    named = _named(tmodel)
    assert len(named) == len(jax.tree_util.tree_leaves(jgrads))
    for path, p in named.items():
        assert p.grad is not None, path
        assert bool(torch.isfinite(p.grad).all()), path
        np.testing.assert_allclose(p.grad.numpy(), _leaf(jgrads, path),
                                   err_msg="/".join(path), **TOL)


# ---------------------------------------------------------------------------
# feature towers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tower", sorted(_tower_configs(jparam)))
def test_feature_parameter_matches_jax(tower):
    jp = jparam.FeatureParameter(_tower_configs(jparam)[tower])
    tp = tparam.FeatureParameter(_tower_configs(tparam)[tower], device="cpu")
    params = _perturb(jp.init(jax.random.PRNGKey(0)), 1, 0.1)
    load_jax_params(tp, jax.device_get(params))
    jb, tb = _both(_batch())
    g = np.random.default_rng(2).normal(size=(B, K)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jp(p, jb) * g)

    jlogits = jp(params, jb)
    jgrads = jax.grad(jloss)(params)
    tlogits = tp(tb)
    torch.sum(tlogits * torch.from_numpy(g)).backward()
    assert tlogits.shape == (B, K)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    _assert_grads(tp, jgrads)


def test_deep_cross_tree_names_match_jax():
    """The tower's layers sit at the parameter's own level, as in the JAX
    tree (no level for the tower itself)."""
    jm = jcore.PositionBasedModel(positions=K,
                                  attraction=_attraction(jcore, "dcn"))
    tm = tcore.PositionBasedModel(positions=K,
                                  attraction=_attraction(tcore, "dcn"),
                                  device="cpu")
    jpaths = {tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(
                  jm.init(jax.random.PRNGKey(0)))[0]}
    assert set(_named(tm)) == jpaths
    assert ("attraction", "cross_0", "kernel") in jpaths
    assert ("attraction", "deep", "layer_1", "kernel") in jpaths
    assert ("attraction", "head", "bias") in jpaths


# ---------------------------------------------------------------------------
# PBM, CM, UBM
# ---------------------------------------------------------------------------

def _pair(name, attraction):
    jm = jcore.MODEL_REGISTRY[name](query_doc_pairs=N, positions=K,
                                    attraction=_attraction(jcore, attraction))
    tm = tcore.MODEL_REGISTRY[name](query_doc_pairs=N, positions=K,
                                    attraction=_attraction(tcore, attraction),
                                    device="cpu")
    return jm, tm


@functools.lru_cache(maxsize=None)
def _jax_fns(name, attraction):
    jm, _ = _pair(name, attraction)
    predict = jax.jit(lambda p, b: tuple(getattr(jm, m)(p, b)
                                         for m in PREDICT))
    return jm, jax.jit(jax.value_and_grad(jm.compute_loss)), predict


def _check_model(name, attraction, params, batch):
    jm, loss_and_grad, predict = _jax_fns(name, attraction)
    _, tm = _pair(name, attraction)
    load_jax_params(tm, jax.device_get(params))
    jb, tb = _both(batch)
    jloss, jgrads = loss_and_grad(params, jb)
    tloss = tm.compute_loss(tb)
    tloss.backward()
    assert np.isfinite(float(tloss.detach()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    _assert_grads(tm, jgrads)
    with torch.no_grad():
        for method, want in zip(PREDICT, predict(params, jb)):
            got = getattr(tm, method)(tb).numpy()
            assert not np.isnan(got).any(), method
            np.testing.assert_allclose(got, np.asarray(want), err_msg=method,
                                       **TOL)
    return tm


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("attraction", ["table", "dcn"])
@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name, attraction, perturbed):
    jm, _, _ = _jax_fns(name, attraction)
    params = jm.init(jax.random.PRNGKey(0))
    if perturbed:
        params = _perturb(params, 1, 0.7)
    _check_model(name, attraction, params, _batch())


def _extreme(params, seed):
    """Every table entry at +-36, every tower output pushed to +-36 by its
    head bias; both signs appear."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        names = [k.key for k in path]
        if names[-1] == "table":
            return jnp.asarray(rng.choice([-36.0, 36.0], size=p.shape),
                               jnp.float32)
        if names[-2:] == ["head", "bias"]:
            return jnp.full(p.shape, 36.0 * rng.choice([-1.0, 1.0]),
                            jnp.float32)
        return p

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("attraction", ["table", "dcn"])
@pytest.mark.parametrize("name", MODELS)
def test_extreme_corpus_is_finite_and_matches_jax(name, attraction):
    jm, _, _ = _jax_fns(name, attraction)
    params = _extreme(jm.init(jax.random.PRNGKey(0)), 3)
    batch = _batch(4)
    batch["mask"][::3] = False  # fully masked rows
    batch["clicks"][1::2, ::2] = 1.0
    _check_model(name, attraction, params, batch)


def test_ubm_marginal_matches_its_loop_and_jax():
    """predict_clicks (one unit-triangular solve) against the port's
    O(K^2) ``predict_clicks_loop`` and JAX's, values and gradients of every
    parameter."""
    jm, tm = _pair("ubm", "table")
    params = _perturb(jm.init(jax.random.PRNGKey(0)), 5, 1.0)
    load_jax_params(tm, jax.device_get(params))
    jb, tb = _both(_batch(6))
    g = np.random.default_rng(7).normal(size=(B, K)).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jm.predict_clicks(p, jb) * g))(params)
    got = tm.predict_clicks(tb)
    torch.sum(got * torch.from_numpy(g)).backward()
    _assert_grads(tm, jgrads)
    with torch.no_grad():
        loop = tm.predict_clicks_loop(tb).numpy()
    np.testing.assert_allclose(got.detach().numpy(), loop, **TOL)
    np.testing.assert_allclose(loop, np.asarray(jm.predict_clicks_loop(
        params, jb)), **TOL)


# ---------------------------------------------------------------------------
# mixture
# ---------------------------------------------------------------------------

def _mixture(mod, attraction, **kw):
    """PBM, DCTR sharing PBM's attraction module, GCTR, and a CM."""
    pbm = mod.PositionBasedModel(query_doc_pairs=N, positions=K,
                                 attraction=_attraction(mod, attraction),
                                 **kw)
    dctr = mod.DocumentCTR(positions=K, attraction=pbm.parts["attraction"],
                           **kw)
    gctr = mod.GlobalCTR(positions=K, **kw)
    cm = mod.CascadeModel(query_doc_pairs=N, positions=K, **kw)
    return mod.MixtureModel([pbm, dctr, gctr, cm], temperature=1.5, **kw)


@pytest.mark.parametrize("attraction", ["table", "dcn"])
def test_mixture_matches_jax_with_a_shared_module(attraction):
    jm = _mixture(jcore, attraction)
    tm = _mixture(tcore, attraction, device="cpu")
    params = _perturb(jm.init(jax.random.PRNGKey(0)), 8, 0.5)
    assert "m1_attraction" not in params["store"]
    assert set(tm.store) == set(params["store"])
    assert tm.store["m0_attraction"] is tm.models[1].parts["attraction"]
    load_jax_params(tm, jax.device_get(params))
    jb, tb = _both(_batch(9))
    jloss, jgrads = jax.value_and_grad(jm.compute_loss)(params, jb)
    tloss = tm.compute_loss(tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    _assert_grads(tm, jgrads)  # the shared module's: the sum of both uses
    with torch.no_grad():
        for method in PREDICT:
            np.testing.assert_allclose(
                getattr(tm, method)(tb).numpy(),
                np.asarray(getattr(jm, method)(params, jb)), err_msg=method,
                **TOL)


# ---------------------------------------------------------------------------
# helpers and metrics
# ---------------------------------------------------------------------------

def test_click_history_helpers_match_jax():
    rng = np.random.default_rng(10)
    clicks = (rng.random((64, K)) < 0.4).astype(np.float32)
    positions = np.tile(np.arange(1, K + 1, dtype=np.int32), (64, 1))
    np.testing.assert_array_equal(
        tbase.last_click_positions(torch.from_numpy(clicks),
                                   torch.from_numpy(positions)).numpy(),
        np.asarray(jbase.last_click_positions(jnp.asarray(clicks),
                                              jnp.asarray(positions))))
    np.testing.assert_array_equal(
        tbase.clicks_before(torch.from_numpy(clicks)).numpy(),
        np.asarray(jbase.clicks_before(jnp.asarray(clicks))))


@pytest.mark.parametrize("top_n", [None, 3, 10])
@pytest.mark.parametrize("metric", ["dcg_metric", "ndcg_metric",
                                    "mrr_metric"])
def test_ranking_metrics_match_jax(metric, top_n):
    """Tied scores (three values), masked items, a fully masked list and a
    list without any relevant item."""
    rng = np.random.default_rng(11)
    scores = rng.integers(0, 3, (40, 12)).astype(np.float32)
    labels = rng.integers(0, 5, (40, 12)).astype(np.int32)
    where = rng.random((40, 12)) < 0.8
    where[0] = False
    labels[1] = 0
    want = getattr(jcore, metric)(jnp.asarray(scores), jnp.asarray(labels),
                                  where=jnp.asarray(where), top_n=top_n)
    got = getattr(tcore, metric)(torch.from_numpy(scores),
                                 torch.from_numpy(labels),
                                 where=torch.from_numpy(where), top_n=top_n)
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pbm", "dctr"])
def test_two_tower_adamw_steps_match_jax(kind):
    """The reduced Listing-4 pair (8 features) trained five AdamW(1e-2)
    steps on a PBM-behaviour log in both packages: step losses at 1e-5."""
    cfg = SyntheticConfig(n_sessions=5 * 256, n_queries=40,
                          docs_per_query=15, positions=K, behavior="pbm",
                          seed=1, n_features=8, exam_decay=0.6,
                          ranker_noise=2.0)
    data, _ = generate_click_log(cfg)
    tower = dict(features=8, cross_layers=2, deep_layers=2)
    jcls = {"pbm": jcore.PositionBasedModel, "dctr": jcore.DocumentCTR}[kind]
    jm = jcls(positions=K, attraction=jcore.DeepCrossParameterConfig(**tower))
    tm = clax_baidu.make_two_tower(kind, features=8, device="cpu")
    params = jm.init(jax.random.PRNGKey(0))
    load_jax_params(tm, jax.device_get(params))
    keys = ("positions", "query_doc_ids", "clicks", "mask",
            "query_doc_features")
    jopt_ = jopt.adamw(1e-2)
    jstate = jopt_.init(params)
    loss_and_grad = jax.jit(jax.value_and_grad(jm.compute_loss))
    topt_ = topt.adamw(1e-2)
    tparams = list(tm.parameters())
    tstate = topt_.init(tparams)
    jlosses, tlosses = [], []
    for step in range(5):
        rows = slice(step * 256, (step + 1) * 256)
        jb, tb = _both({k: data[k][rows] for k in keys})
        loss, grads = loss_and_grad(params, jb)
        updates, jstate = jopt_.update(grads, jstate, params)
        params = jopt.apply_updates(params, updates)
        jlosses.append(float(loss))
        tloss = tm.compute_loss(tb)
        grads = torch.autograd.grad(tloss, tparams)
        updates, tstate = topt_.update(list(grads), tstate, tparams)
        topt.apply_updates(tparams, updates)
        tlosses.append(float(tloss.detach()))
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert tlosses[-1] < tlosses[0]


def _train_loss(lines):
    records = [ast.literal_eval(line[len("[trainer] "):]) for line in lines
               if line.startswith("[trainer] {")]
    return records[-1]["train_loss"]


def test_launcher_defaults_to_ubm_and_matches_jax(capsys, monkeypatch):
    """Both launchers with no --model (UBM in both) and the same flags: the
    same train loss, which another model would not give."""
    assert sorted(tcore.MODEL_REGISTRY) == sorted(jcore.MODEL_REGISTRY)
    flags = ["--sessions", "2000", "--epochs", "1", "--batch", "256"]
    torch_launch.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    jax_launch.main()
    jax_out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("[train] test:") for line in port_out)
    np.testing.assert_allclose(_train_loss(port_out), _train_loss(jax_out),
                               rtol=1e-4, atol=1e-4)
