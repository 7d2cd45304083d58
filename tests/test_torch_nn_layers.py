"""Parity of the port's ``Scalar``, ``Embedding``, ``LayerNorm``, ``RMSNorm``
and ``Sequential`` layers and its ``glorot_uniform`` and ``logit_of_prob``
initializers with repro.nn, on the CPU.

A JAX ``init`` tree goes through ``load_jax_params`` into the port layer,
then both run the same numpy input; outputs and gradients must agree at
1e-5. Also JAX's own properties, mirrored: ``test_rmsnorm_layer_norm_stats``
and the init-determinism test of tests/test_substrate.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import nn as jnn
from repro.nn import init as jinit
from repro_torch import nn as tnn
from repro_torch.convert import export_params, load_jax_params
from repro_torch.nn import init as tinit

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0, scale=1.0, offset=0.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale + offset
    return x.astype(np.float32)


def _grads(layer, x):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    proj = torch.from_numpy(_x(tuple(y.shape), seed=9))
    params = list(layer.parameters())
    return y, torch.autograd.grad(torch.sum(y * proj), [xt, *params])


def _jax_grads(layer, params, x, proj_shape):
    proj = jnp.asarray(_x(proj_shape, seed=9))
    return jax.grad(lambda xx, p: jnp.sum(layer(p, xx) * proj),
                    argnums=(0, 1))(jnp.asarray(x), params)


def _leaf(tree, dotted):
    for key in dotted.split("."):
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("kind,use_bias", [("layer", True), ("layer", False),
                                           ("rms", None)])
@pytest.mark.parametrize("offset", [0.0, 20.0])
def test_norms_match_jax(kind, use_bias, offset):
    """Values and gradients, at rows centred on 0 and on 20."""
    if kind == "layer":
        jl = jnn.LayerNorm(16, use_bias=use_bias)
        tl = tnn.LayerNorm(16, use_bias=use_bias)
    else:
        jl, tl = jnn.RMSNorm(16), tnn.RMSNorm(16)
    params = jl.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape) * 0.3,
                                  jnp.float32), params)
    load_jax_params(tl, jax.device_get(params))
    x = _x((5, 16), scale=2.0, offset=offset)
    y, grads = _grads(tl, x)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jl(params, jnp.asarray(x))), **TOL)
    jgx, jgp = _jax_grads(jl, params, x, tuple(y.shape))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for (name, _), g in zip(tl.named_parameters(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), _leaf(jgp, name), err_msg=name,
                                   **TOL)


def test_layer_norm_uses_the_population_variance_and_eps_1e6():
    """Rows of std 0.01: the unbiased variance (8/7 of it) and
    torch.nn.LayerNorm's eps 1e-5 would each move the output by percents."""
    x = torch.from_numpy(_x((3, 8), scale=0.01))
    y = tnn.LayerNorm(8)(x).detach()
    xf = x.double()
    pop = (xf - xf.mean(-1, keepdim=True)) / torch.sqrt(
        xf.var(-1, unbiased=False, keepdim=True) + 1e-6)
    np.testing.assert_allclose(y.numpy(), pop.numpy(), **TOL)
    for wrong in (torch.nn.functional.layer_norm(x, (8,)),  # eps 1e-5
                  (x - x.mean(-1, keepdim=True))
                  / torch.sqrt(x.var(-1, keepdim=True) + 1e-6)):  # unbiased
        assert not np.allclose(wrong.numpy(), y.numpy(), **TOL)


def test_rmsnorm_layer_norm_stats():
    """tests/test_substrate.py's property on the port."""
    ln = tnn.LayerNorm(16)
    x = torch.from_numpy(_x((3, 16), seed=1) * 5 + 2)
    y = ln(x).detach()
    np.testing.assert_allclose(y.mean(-1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.std(-1, unbiased=False).numpy(), 1.0,
                               atol=1e-2)
    rn = tnn.RMSNorm(16)
    y = rn(torch.from_numpy(_x((3, 16), seed=2))).detach()
    np.testing.assert_allclose(torch.mean(y ** 2, -1).numpy(), 1.0,
                               atol=1e-2)


def test_embedding_matches_jax():
    jl = jnn.Embedding(40, 6)
    params = jl.init(jax.random.PRNGKey(2))
    tl = tnn.Embedding(40, 6, torch.Generator(), device="cpu")
    load_jax_params(tl, jax.device_get(params))
    ids = np.random.default_rng(3).integers(0, 40, (4, 7))
    np.testing.assert_array_equal(
        tl(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jl(params, jnp.asarray(ids))))
    assert tl.table.shape == (40, 6)
    std = float(tnn.Embedding(400, 50, torch.Generator().manual_seed(0)
                              ).table.detach().std())
    assert abs(std - 0.02) < 0.001


def test_scalar_matches_jax():
    js = jnn.Scalar((3,), init_fn=jinit.logit_of_prob(0.2))
    ts = tnn.Scalar((3,), init_fn=tinit.logit_of_prob(0.2))
    want = np.asarray(js(js.init(jax.random.PRNGKey(0))))
    np.testing.assert_allclose(ts().detach().numpy(), want, **TOL)
    np.testing.assert_allclose(torch.sigmoid(ts()).detach().numpy(), 0.2,
                               rtol=1e-6)
    zero = tnn.Scalar()
    assert zero().shape == () and float(zero()) == 0.0
    assert export_params(zero) == {"value": np.zeros((), np.float32)}


def test_sequential_matches_jax():
    jseq = jnn.Sequential([jnn.Dense(6, 5), jnn.LayerNorm(5),
                           jnn.RMSNorm(5), jnn.Dense(5, 2)])
    params = jseq.init(jax.random.PRNGKey(4))
    gen = torch.Generator()
    tseq = tnn.Sequential([tnn.Dense(6, 5, gen), tnn.LayerNorm(5),
                           tnn.RMSNorm(5), tnn.Dense(5, 2, gen)])
    load_jax_params(tseq, jax.device_get(params))
    x = _x((7, 6), seed=5)
    y, grads = _grads(tseq, x)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jseq(params, jnp.asarray(x))),
                               **TOL)
    _, jgp = _jax_grads(jseq, params, x, tuple(y.shape))
    names = [n for n, _ in tseq.named_parameters()]
    assert names[0] == "mod_0.kernel"
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), _leaf(jgp, name), err_msg=name,
                                   **TOL)


def test_glorot_uniform_follows_jax():
    gen = torch.Generator().manual_seed(0)
    w = tinit.glorot_uniform()((300, 200), gen)
    limit = (6.0 / 500) ** 0.5
    assert w.shape == (300, 200) and w.dtype == torch.float32
    assert float(w.abs().max()) <= limit
    jw = jinit.glorot_uniform()(jax.random.PRNGKey(0), (300, 200))
    assert float(jnp.max(jnp.abs(jw))) <= limit
    # uniform on +-limit: std limit / sqrt(3), mean 0
    for arr in (w.numpy(), np.asarray(jw)):
        assert abs(arr.std() - limit / 3 ** 0.5) < 0.01 * limit
        assert abs(arr.mean()) < 0.01 * limit
    conv = tinit.glorot_uniform()((3, 3, 8, 16), gen)
    assert float(conv.abs().max()) <= (6.0 / (9 * 8 + 9 * 16)) ** 0.5


@pytest.mark.parametrize("p", [0.01, 0.2, 0.5, 0.9])
def test_logit_of_prob_matches_jax(p):
    got = tinit.logit_of_prob(p)((2,))
    want = np.asarray(jinit.logit_of_prob(p)(jax.random.PRNGKey(0), (2,)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("make", [
    lambda g: tnn.Embedding(30, 4, g),
    lambda g: tnn.Sequential([tnn.Dense(4, 3, g), tnn.LayerNorm(3)]),
    lambda g: tnn.MLP(4, [5], 2, g),
], ids=["embedding", "sequential", "mlp"])
def test_dense_shapes_and_init_determinism(make):
    """tests/test_substrate.py's determinism on the port: one seed, the
    same weights; another seed, others."""
    a = make(torch.Generator().manual_seed(0))
    b = make(torch.Generator().manual_seed(0))
    c = make(torch.Generator().manual_seed(1))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert any(not torch.equal(pa, pc) for pa, pc in zip(a.parameters(),
                                                          c.parameters()))
    w = tinit.glorot_uniform()
    assert torch.equal(w((4, 4), torch.Generator().manual_seed(3)),
                       w((4, 4), torch.Generator().manual_seed(3)))


def test_nn_exports_what_jax_exports():
    want = set(jnn.__all__) - {"split_rngs"}
    assert want <= set(tnn.__all__)
