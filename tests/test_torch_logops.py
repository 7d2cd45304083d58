"""Parity of repro_torch.stable with repro.stable: value and gradient of every
log-space primitive on the same numpy inputs, including the extreme corpus
(|x| = 36, exact zeros) and fully masked logsumexp. Tolerance: the f32
conformance contract, rtol = atol = 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import stable as jst
from repro_torch import stable as tst

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


def check(jfn, tfn, *arrays, diff=None):
    """Values of every output, and the gradient of a fixed random projection
    of the float outputs w.r.t. the ``diff`` arguments (default: all float
    arguments). Non-finite outputs are projected out, as they are in use."""
    diff = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"] \
        if diff is None else diff
    jouts = _flat(jax.jit(jfn)(*[jnp.asarray(a) for a in arrays]))
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(arrays)]
    touts = _flat(tfn(*targs))
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)
    if not diff:
        return
    rng = np.random.default_rng(123)
    weights = [rng.normal(size=np.shape(j)).astype(np.float32)
               for j in jouts]
    floats = [k for k, j in enumerate(jouts)
              if jnp.issubdtype(j.dtype, jnp.floating)]

    def jproj(*diff_args):
        full = [jnp.asarray(a) for a in arrays]
        for i, a in zip(diff, diff_args):
            full[i] = a
        outs = _flat(jfn(*full))
        return sum(jnp.sum(jnp.where(jnp.isfinite(outs[k]), outs[k], 0.0)
                           * weights[k]) for k in floats)

    jgrads = jax.jit(jax.grad(jproj, argnums=tuple(range(len(diff)))))(
        *[jnp.asarray(arrays[i]) for i in diff])
    tproj = sum(torch.sum(torch.where(torch.isfinite(touts[k]), touts[k], 0.0)
                          * torch.from_numpy(weights[k])) for k in floats)
    tgrads = torch.autograd.grad(tproj, [targs[i] for i in diff],
                                 allow_unused=True)
    for i, jg, tg in zip(diff, jgrads, tgrads):
        tg = np.zeros(arrays[i].shape, np.float32) if tg is None else tg.numpy()
        assert np.all(np.isfinite(tg)), (i, tg)
        np.testing.assert_allclose(tg, np.asarray(jg), **TOL)


RNG = np.random.default_rng(0)
LOGITS = np.concatenate([RNG.normal(size=40) * 4.0,
                         [36.0, -36.0, 0.0, 1e-3, -1e-3, 20.5, -20.5]]
                        ).astype(np.float32)
LOG_PROBS = np.concatenate([-np.abs(RNG.normal(size=40)) * 3.0,
                            [-1e-6, -0.6931, -0.6932, -36.0, -80.0]]
                           ).astype(np.float32)

UNARY = {
    "log1mexp": (jst.log1mexp, tst.log1mexp, LOG_PROBS),
    "log_expm1": (jst.log_expm1, tst.log_expm1,
                  np.abs(LOGITS[np.abs(LOGITS) > 1e-2])),
    "log_sigmoid": (jst.log_sigmoid, tst.log_sigmoid, LOGITS),
    "log1m_sigmoid": (jst.log1m_sigmoid, tst.log1m_sigmoid, LOGITS),
    "sigmoid_core": (jst.sigmoid_core, tst.sigmoid_core, LOGITS),
    "sigmoid_parts": (jst.sigmoid_parts, tst.sigmoid_parts, LOGITS),
    "log_not": (jst.log_not, tst.log_not, LOG_PROBS),
    "logit_to_log_prob": (jst.logit_to_log_prob, tst.logit_to_log_prob,
                          LOGITS),
    "log_prob_to_logit": (jst.log_prob_to_logit, tst.log_prob_to_logit,
                          LOG_PROBS[LOG_PROBS < -1e-5]),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_logop_matches_jax(name):
    jfn, tfn, x = UNARY[name]
    check(jfn, tfn, x)


def test_log_or_matches_jax():
    p = LOG_PROBS[LOG_PROBS < -1e-5]
    q = np.roll(p, 3)
    check(jst.log_or, tst.log_or, p, q)


@pytest.mark.parametrize("clicks", ["zeros", "ones", "mixed"])
def test_log_bce_matches_jax(clicks):
    c = {"zeros": np.zeros_like(LOG_PROBS), "ones": np.ones_like(LOG_PROBS),
         "mixed": (RNG.random(LOG_PROBS.shape) < 0.5).astype(np.float32)
         }[clicks]
    check(jst.log_bce, tst.log_bce, LOG_PROBS[LOG_PROBS < -1e-5],
          c[LOG_PROBS < -1e-5], diff=[0])


def test_log_add_exp_matches_jax_including_impossible_events():
    a = np.array([0.0, -1.0, 3.0, -np.inf, 5.0, -36.0, np.inf], np.float32)
    b = np.array([0.0, 2.0, -4.0, 1.0, 5.0, 36.0, 2.0], np.float32)
    check(jst.log_add_exp, tst.log_add_exp, a, b)
    # both impossible: -inf, as in JAX (whose gradient there is NaN)
    both = np.full(2, -np.inf, np.float32)
    check(jst.log_add_exp, tst.log_add_exp, both, both, diff=[])


def test_log1mexp_at_zero_is_neg_inf():
    check(jst.log1mexp, tst.log1mexp, np.zeros(2, np.float32), diff=[])


# jax.lax.cumlogsumexp rejects axis=-1, so log_cumsum is held at 0 and 1.
@pytest.mark.parametrize("fn,axis", [("exclusive_cumsum", 0),
                                     ("exclusive_cumsum", 1),
                                     ("exclusive_cumsum", -1),
                                     ("log_cumsum", 0), ("log_cumsum", 1)])
def test_cumulative_ops_match_jax(fn, axis):
    a = RNG.normal(size=(5, 7)).astype(np.float32) * 3.0
    check(lambda x: getattr(jst, fn)(x, axis=axis),
          lambda x: getattr(tst, fn)(x, axis=axis), a)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (1, False),
                                           (1, True), (0, False)])
def test_masked_logsumexp_matches_jax(axis, keepdims):
    a = RNG.normal(size=(6, 9)).astype(np.float32) * 5.0
    where = RNG.random((6, 9)) < 0.6
    where[2] = False  # a fully masked row
    where[:, 4] = False  # a fully masked column
    check(lambda x, w: jst.logsumexp(x, axis=axis, where=w,
                                     keepdims=keepdims),
          lambda x, w: tst.logsumexp(x, axis=axis, where=w,
                                     keepdims=keepdims), a, where, diff=[0])


def test_fully_masked_logsumexp_is_neg_inf_with_zero_grad():
    a = torch.tensor(RNG.normal(size=(3, 4)).astype(np.float32),
                     requires_grad=True)
    out = tst.logsumexp(a, axis=1, where=torch.zeros(3, 4, dtype=torch.bool))
    assert torch.all(torch.isneginf(out))
    (g,) = torch.autograd.grad(torch.where(torch.isfinite(out), out, 0.0).sum()
                               + 0.0 * a.sum(), [a])
    assert torch.all(g == 0.0)


def test_kink_derivatives_follow_jax():
    """torch's abs and clamp differ from JAX at the kink; the port's helpers
    do not: d|x|/dx(0) = 1 and min/max split a tie's gradient in half."""
    x = np.zeros(3, np.float32)
    check(jnp.abs, tst.absolute, x)
    check(lambda v: jnp.minimum(v, 0.0), lambda v: tst.minimum(v, 0.0), x)
    check(lambda v: jnp.maximum(v, 0.0), lambda v: tst.maximum(v, 0.0), x)
