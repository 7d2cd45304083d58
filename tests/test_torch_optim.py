"""Parity of repro_torch.optim with repro.optim: AdamW over ten steps on a
mixed tree (a table, a vector, a matrix and a scalar) fed the same numpy
gradients, to 1e-6, and global_norm."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as jopt
from repro_torch import optim as topt

SHAPES = {"attraction": {"table": (50, 1), "baseline": (1,)},
          "continuation": {"value": ()}, "theta": {"table": (10,)},
          "w": (3, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s) * scale).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("lr", [3e-3, 0.1])
def test_adamw_matches_jax_over_ten_steps(lr, weight_decay):
    rng = np.random.default_rng(0)
    init = _tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    # the port's tree is a list, in JAX's leaf order
    tparams = [torch.tensor(x) for x in jax.tree_util.tree_leaves(init)]
    jo = jopt.adamw(lr, weight_decay=weight_decay)
    to = topt.adamw(lr, weight_decay=weight_decay)
    jstate, tstate = jo.init(jparams), to.init(tparams)
    jupdate = jax.jit(jo.update)
    for _ in range(10):
        grads = _tree(rng, scale=rng.choice([1e-4, 1.0, 30.0]))
        updates, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads),
                                  jstate, jparams)
        jparams = jopt.apply_updates(jparams, updates)
        tupdates, tstate = to.update(
            [torch.tensor(g) for g in jax.tree_util.tree_leaves(grads)],
            tstate, tparams)
        topt.apply_updates(tparams, tupdates)
        for j, t in zip(jax.tree_util.tree_leaves(jparams), tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
    assert tstate[0].count == int(jstate[0].count) == 10
    for j, t in zip(jax.tree_util.tree_leaves(jstate[0].nu), tstate[0].nu):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-12)


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(1))
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = float(topt.global_norm(
        [torch.tensor(x) for x in jax.tree_util.tree_leaves(tree)]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_updates_parameters_in_place():
    p = torch.ones(4, requires_grad=True)
    opt = topt.adamw(0.1, weight_decay=0.0)
    state = opt.init([p])
    updates, state = opt.update([torch.ones(4)], state, [p])
    topt.apply_updates([p], updates)
    torch.testing.assert_close(p.detach(), torch.full((4,), 0.9))
    assert state.__class__ is tuple and state[0].count == 1
