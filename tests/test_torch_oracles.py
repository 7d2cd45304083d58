"""The ported models' oracles and samplers on the CPU.

* The chain models' sequential ``predict_clicks_scan`` /
  ``predict_conditional_clicks_scan`` match JAX's (values and every
  gradient, 1e-5) and the port's vectorized paths, as
  ``tests/test_recursions.py`` pins them for JAX.
* ``sample`` of every model and of the mixture: a batch of 8 sessions
  repeated 4,000 times is sampled once, and each (session, position)'s
  click rate must be within 0.04 of exp(predict_clicks) (five standard
  deviations of a rate over 4,000 draws at most). Masked items never
  click, a click needs attraction and examination where the model draws
  them, the cascade clicks at most once, and one seed gives one sample.
  ``torch.Generator`` and ``jax.random`` give different numbers from one
  seed, so the port is held to the click probabilities the parity tests
  pin, not to JAX's draws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.convert import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
B, K, N = 32, 10, 300
CHAIN = ["dcm", "ccm", "dbn", "sdbn"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rows, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, K + 1, (rows, 1))
    return {"positions": np.tile(np.arange(1, K + 1, dtype=np.int32),
                                 (rows, 1)),
            "query_doc_ids": rng.integers(0, N, (rows, K)).astype(np.int32),
            "clicks": (rng.random((rows, K)) < 0.3).astype(np.float32),
            "mask": np.arange(K)[None, :] < lengths}


def _cfg(mod):
    return mod.EmbeddingParameterConfig(parameters=N)


def _perturbed_pair(name, seed):
    jm = jcore.MODEL_REGISTRY[name](query_doc_pairs=N, positions=K,
                                    attraction=_cfg(jcore))
    tm = tcore.MODEL_REGISTRY[name](query_doc_pairs=N, positions=K,
                                    attraction=_cfg(tcore), device="cpu")
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape), jnp.float32),
        jm.init(jax.random.PRNGKey(0)))
    load_jax_params(tm, jax.device_get(params))
    return jm, tm, params


@pytest.mark.parametrize("method", ["predict_clicks",
                                    "predict_conditional_clicks"])
@pytest.mark.parametrize("name", CHAIN)
def test_chain_scan_oracles_match_jax_and_the_vectorized_paths(name, method):
    jm, tm, params = _perturbed_pair(name, 1)
    batch = _batch(B, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    g = np.random.default_rng(3).normal(size=(B, K)).astype(np.float32)
    scan = method + "_scan"
    jgrads = jax.grad(lambda p: jnp.sum(getattr(jm, scan)(p, jb) * g))(
        params)
    got = getattr(tm, scan)(tb)
    torch.sum(got * torch.from_numpy(g)).backward()
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(getattr(jm, scan)(params, jb)),
                               **TOL)
    for path, p in tm.named_parameters():
        leaf = jgrads
        for key in path.split(".")[1:]:
            leaf = leaf[key]
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(leaf),
                                   err_msg=path, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got.detach().numpy(),
                                   getattr(tm, method)(tb).numpy(), **TOL)


def _sampled_model(name):
    if name != "mixture":
        return _perturbed_pair(name, 4)[1]
    members = [tcore.MODEL_REGISTRY[m](query_doc_pairs=N, positions=K,
                                       attraction=_cfg(tcore), device="cpu")
               for m in ("pbm", "dbn", "cm")]
    model = tcore.MixtureModel(members, device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(
                np.float32)))
    return model


@pytest.mark.parametrize("name", sorted(tcore.MODEL_REGISTRY) + ["mixture"])
def test_sample_click_rates_match_predict_clicks(name):
    model = _sampled_model(name)
    base = _batch(8, 6)
    reps = 4000
    batch = {k: torch.from_numpy(np.repeat(v, reps, axis=0))
             for k, v in base.items()}
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        out = model.sample(batch, gen)
        want = torch.exp(model.predict_clicks(
            {k: torch.from_numpy(v) for k, v in base.items()}))
    clicks = out["clicks"]
    assert clicks.shape == (8 * reps, K)
    assert set(torch.unique(clicks).tolist()) <= {0.0, 1.0}
    assert bool(torch.all(clicks[~batch["mask"]] == 0))
    rate = clicks.reshape(8, reps, K).mean(dim=1)
    mask = torch.from_numpy(base["mask"])
    np.testing.assert_allclose(rate[mask].numpy(), want[mask].numpy(),
                               atol=0.04, rtol=0)
    for latent in ("attraction", "examination"):
        if latent in out:
            assert bool(torch.all(clicks <= out[latent]))
    if name == "cm":
        assert bool(torch.all(clicks.sum(dim=1) <= 1))
    if name == "mixture":
        assert set(torch.unique(out["model_choice"]).tolist()) == {0, 1, 2}
    again = model.sample(batch, torch.Generator().manual_seed(7))["clicks"]
    assert torch.equal(again, clicks)
