"""Parity of repro_torch.core.recursions with repro.core.recursions: the
marginal chain, the capped death-odds recurrence (value and gradient,
through the saturating autograd Function), and the saturation corpus:
NaN-free gradients, zero gradient where the odds sit on the cap, and the
CUDA kernel's sequential recurrence agreeing with the plain doubling scan."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import recursions as jrec
from repro_torch.core import recursions as trec

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _factors(rng, b, k):
    clicks = (rng.random((b, k)) < 0.3).astype(np.float32)
    pss = rng.uniform(0.05, 0.95, (b, k)).astype(np.float32)
    pd = rng.uniform(0.0, 0.5, (b, k)).astype(np.float32)
    pr = rng.uniform(0.05, 0.95, (b, k)).astype(np.float32)
    return clicks, pss, pd, pr, (1.0 - pr).astype(np.float32)


def _value_and_grads(jfn, tfn, arrays, diff, rng):
    w = rng.normal(size=arrays[0].shape).astype(np.float32)
    jout = jax.jit(jfn)(*[jnp.asarray(a) for a in arrays])

    def jproj(*d):
        full = [jnp.asarray(a) for a in arrays]
        for i, a in zip(diff, d):
            full[i] = a
        return jnp.sum(jfn(*full) * w)

    jg = jax.jit(jax.grad(jproj, argnums=tuple(range(len(diff)))))(
        *[jnp.asarray(arrays[i]) for i in diff])
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(arrays)]
    tout = tfn(*targs)
    tg = torch.autograd.grad(torch.sum(tout * torch.from_numpy(w)),
                             [targs[i] for i in diff])
    return np.asarray(jout), tout.detach().numpy(), jg, [g.numpy() for g in tg]


@pytest.mark.parametrize("shape", [(4, 1), (7, 10), (5, 33), (3, 130)])
def test_marginal_examination_matches_jax(shape):
    rng = np.random.default_rng(0)
    log_cont = np.log(rng.uniform(0.1, 1.0, shape)).astype(np.float32)
    jv, tv, jg, tg = _value_and_grads(jrec.marginal_examination,
                                      trec.marginal_examination,
                                      [log_cont], [0], rng)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), **TOL)


@pytest.mark.parametrize("fn", ["conditional_examination_odds",
                                "conditional_examination"])
@pytest.mark.parametrize("shape", [(4, 1), (7, 10), (5, 33), (3, 130)])
def test_conditional_examination_matches_jax(fn, shape):
    rng = np.random.default_rng(1)
    arrays = list(_factors(rng, *shape))
    jv, tv, jg, tg = _value_and_grads(getattr(jrec, fn), getattr(trec, fn),
                                      arrays, [1, 2, 3, 4], rng)
    np.testing.assert_allclose(tv, jv, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _saturating(rng, b=6, k=40):
    """Skip runs with near-zero survive probability: the odds hit the cap
    after a position or two; sparse clicks reset them."""
    clicks, pss, pd, pr, prn = _factors(rng, b, k)
    clicks = (rng.random((b, k)) < 0.05).astype(np.float32)
    pss[: b // 2] = 1e-12
    return [clicks, pss, pd, pr, prn]


def test_saturated_odds_grads_are_finite_zero_on_cap_and_match_jax():
    rng = np.random.default_rng(2)
    arrays = _saturating(rng)
    jv, tv, jg, tg = _value_and_grads(jrec.conditional_examination_odds,
                                      trec.conditional_examination_odds,
                                      arrays, [1, 2, 3, 4], rng)
    assert np.any(tv >= trec.ODDS_CAP)
    np.testing.assert_allclose(tv, jv, **TOL)
    for a, b in zip(tg, jg):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_affine_scan_zeroes_cotangent_on_the_cap():
    """The saturating VJP: an output at the cap passes no gradient back."""
    a = torch.tensor([[1e9, 1e9, 1e9, 2.0]], requires_grad=True)
    b = torch.tensor([[0.5, 0.5, 0.5, 0.5]], requires_grad=True)
    z = trec._AffineScan.apply(a, b)
    assert z[0, 1] < trec.ODDS_CAP
    assert z[0, 2] == trec.ODDS_CAP and z[0, 3] == trec.ODDS_CAP
    ga, gb = torch.autograd.grad(z[0, 2] + z[0, 3], [a, b])
    assert torch.all(ga == 0) and torch.all(gb == 0)


@pytest.mark.parametrize("shape", [(3, 1), (5, 10), (4, 130)])
def test_affine_scan_vjp_matches_jax(shape):
    # The recurrence's domain: a = 0 after a click, else 1/p >= 1, so the
    # cap is absorbing within a segment (repro/core/recursions.py:142-144).
    rng = np.random.default_rng(3)
    a = rng.uniform(1.0, 3.0, shape).astype(np.float32)
    a[rng.random(shape) < 0.2] = 0.0
    b = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    a[0, shape[1] // 2:] = 1e9  # one row driven onto the cap
    jv, tv, jg, tg = _value_and_grads(jrec._affine_scan, trec._AffineScan.apply,
                                      [a, b], [0, 1], rng)
    np.testing.assert_allclose(tv, jv, **TOL)
    for x, y in zip(tg, jg):
        np.testing.assert_allclose(x, np.asarray(y), **TOL)


def _sequential_odds(clicks, pss, pd, pr, prn):
    """The CUDA kernel's recurrence (csrc/examination_nll.cu) in torch: one
    pass along K, z_k = min(a_k z_{k-1} + b_k, ODDS_CAP), r_k = z_{k-1}."""
    clicked = (clicks > 0).float()
    a = (1.0 - clicked) / torch.clamp_min(pss, trec.ODDS_FLOOR)
    b = torch.clamp_max(a * pd + clicked * (prn / torch.clamp_min(
        pr, trec.ODDS_FLOOR)), trec.ODDS_CAP)
    z = torch.zeros(clicks.shape[0])
    r = []
    for k in range(clicks.shape[1]):
        r.append(z)
        z = torch.clamp_max(a[:, k] * z + b[:, k], trec.ODDS_CAP)
    return torch.stack(r, dim=1)


@pytest.mark.parametrize("case", ["random", "saturating"])
def test_sequential_recurrence_matches_capped_doubling_scan(case):
    rng = np.random.default_rng(4)
    arrays = (_factors(rng, 9, 130) if case == "random"
              else _saturating(rng, 9, 130))
    t = [torch.from_numpy(np.asarray(x)) for x in arrays]
    seq = _sequential_odds(*t)
    tree = trec.conditional_examination_odds(*t)
    capped = tree >= trec.ODDS_CAP
    assert torch.equal(seq >= trec.ODDS_CAP, capped)
    torch.testing.assert_close(seq[~capped], tree[~capped], rtol=1e-5,
                               atol=1e-6)
