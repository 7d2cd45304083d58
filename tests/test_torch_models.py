"""Parity of the seven ported click models with repro.core.models: a JAX
``init`` tree goes through ``load_jax_params`` into the port, then
compute_loss, its gradients, predict_clicks, predict_conditional_clicks and
predict_relevance must match JAX on the same batch (1e-5). Both at the
initial parameters (logits sitting exactly on 0, where torch's and JAX's
derivative conventions differ) and at perturbed ones. Also: hashing is
bit-identical to JAX over [0, 2^31), the quotient-remainder lookup matches,
and the parameter converters refuse mismatched trees."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro.core.base import masked_mean as jax_masked_mean
from repro.core.parameterization import hash_ids as jax_hash_ids
from repro_torch import core as tcore
from repro_torch.convert import export_params, load_jax_params
from repro_torch.core.parameterization import hash_ids as torch_hash_ids

TOL = dict(rtol=1e-5, atol=1e-5)
B, K, N = 48, 10, 700
MODELS = ["gctr", "rctr", "dctr", "dcm", "ccm", "dbn", "sdbn"]
COMPRESSIONS = {"none": 1.0, "hash": 3.0, "quotient_remainder": 4.0}


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
            "mask": np.arange(K)[None, :] < lengths}


def _pair(name, compression, baseline):
    def cfg(mod):
        return mod.EmbeddingParameterConfig(
            parameters=N, compression=mod.Compression(compression),
            compression_ratio=COMPRESSIONS[compression],
            baseline_correction=baseline, init_logit=-1.5 if baseline else 0.0)

    jm = jcore.MODEL_REGISTRY[name](query_doc_pairs=N, positions=K,
                                    attraction=cfg(jcore))
    tm = tcore.MODEL_REGISTRY[name](query_doc_pairs=N, positions=K,
                                    attraction=cfg(tcore), device="cpu")
    return jm, tm


PREDICT = ("predict_clicks", "predict_conditional_clicks", "predict_relevance")


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
    """JAX model plus its jitted loss-and-grad and predictions, compiled once
    per model for both parameter sets."""
    jm, _ = _pair(name, "hash", baseline=False)
    predict = jax.jit(lambda p, b: tuple(getattr(jm, m)(p, b)
                                         for m in PREDICT))
    return jm, jax.jit(jax.value_and_grad(jm.compute_loss)), predict


def _leaf(tree, dotted):
    for key in dotted.split(".")[1:]:  # drop the "parts." prefix
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name, perturbed):
    jm, loss_and_grad, predict = _jax_fns(name)
    _, tm = _pair(name, "hash", baseline=False)
    params = jm.init(jax.random.PRNGKey(0))
    if perturbed:
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda p: p + jnp.asarray(rng.normal(size=p.shape) * 0.7,
                                      jnp.float32), params)
    load_jax_params(tm, jax.device_get(params))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    jloss, jgrads = loss_and_grad(params, jb)
    tloss = tm.compute_loss(tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for path, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _leaf(jgrads, path),
                                   err_msg=path, **TOL)
    with torch.no_grad():
        for method, want in zip(PREDICT, predict(params, jb)):
            np.testing.assert_allclose(getattr(tm, method)(tb).numpy(),
                                       np.asarray(want), err_msg=method,
                                       **TOL)


@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
def test_embedding_lookup_matches_jax(compression):
    """Plain, hashed and quotient-remainder tables, with a baseline."""
    jm, tm = _pair("dctr", compression, baseline=True)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape), jnp.float32),
        jm.init(jax.random.PRNGKey(0)))
    load_jax_params(tm, jax.device_get(params))
    batch = _batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits = jm.parts["attraction"](params["attraction"], jb)
    tlogits = tm.parts["attraction"](tb)
    np.testing.assert_array_equal(tlogits.detach().numpy(),
                                  np.asarray(jlogits))


def test_hash_ids_bit_identical_to_jax_over_int31():
    rng = np.random.default_rng(4)
    ids = np.concatenate([
        np.arange(0, 4096), rng.integers(0, 2 ** 31, 200_000),
        2 ** 31 - 1 - np.arange(4096), [2 ** 16, 2 ** 24, 2 ** 30]
    ]).astype(np.int32)
    for table in (512, 1_000_448, 214_748_672):
        want = np.asarray(jax_hash_ids(jnp.asarray(ids), table))
        got = torch_hash_ids(torch.from_numpy(ids), table).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        assert got.min() >= 0 and got.max() < table


def test_paper_width_table_rows_match_jax():
    """clax_baidu: 2^31 ids hashed 10x -> 214,748,672 rows after rounding."""
    cfg = dict(parameters=1 << 31, compression_ratio=10.0)
    jrows = jcore.parameterization.EmbeddingParameter(
        jcore.EmbeddingParameterConfig(compression=jcore.Compression.HASH,
                                       **cfg)).table_rows
    t = tcore.EmbeddingParameter(
        tcore.EmbeddingParameterConfig(compression=tcore.Compression.HASH,
                                       **cfg), device="meta")
    assert t.table_rows == jrows == 214_748_672
    assert tuple(t.table.shape) == (214_748_672, 1)


def test_export_round_trips_and_load_refuses_mismatched_trees():
    jm, tm = _pair("dbn", "hash", baseline=True)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    load_jax_params(tm, tree)
    out = export_params(tm)
    assert jax.tree_util.tree_structure(out) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    missing = {k: v for k, v in tree.items() if k != "continuation"}
    with pytest.raises(KeyError, match="continuation"):
        load_jax_params(tm, missing)
    extra = dict(tree, extra={"value": np.zeros(())})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(tm, extra)
    bad = dict(tree, continuation={"value": np.zeros((2,))})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, bad)


def test_validate_batch_and_masked_mean_match_jax():
    batch = _batch(5)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcore.validate_batch(tb)
    with pytest.raises(ValueError, match="clicks"):
        tcore.validate_batch({k: v for k, v in tb.items() if k != "clicks"})
    with pytest.raises(ValueError, match="leading shape"):
        tcore.validate_batch(dict(tb, clicks=tb["clicks"][:, :3]))
    values = np.random.default_rng(6).normal(size=(B, K)).astype(np.float32)
    np.testing.assert_allclose(
        float(tcore.masked_mean(torch.from_numpy(values), tb["mask"])),
        float(jax_masked_mean(jnp.asarray(values),
                              jnp.asarray(batch["mask"]))), **TOL)
