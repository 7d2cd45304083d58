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


# ---------------------------------------------------------------------------
# Every transformation of repro.optim against its port over ten steps.
# ---------------------------------------------------------------------------

def _adamw_cosine(o, bf16):
    del bf16
    return o.adamw(o.cosine_decay(0.05, 8, alpha=0.1), weight_decay=1e-3)


OPTIMIZERS = {
    "adam": lambda o, bf16: o.adam(3e-3),
    "adam_inject_lr": lambda o, bf16: o.adam(0.02, inject_lr=True),
    "adamw": lambda o, bf16: o.adamw(0.02, weight_decay=1e-3),
    "adamw_bf16_moments": lambda o, bf16: o.adamw(
        0.02, weight_decay=1e-3, moment_dtype=bf16),
    "adamw_inject_lr": lambda o, bf16: o.adamw(0.02, inject_lr=True),
    "adamw_cosine_schedule": _adamw_cosine,
    "adagrad": lambda o, bf16: o.adagrad(0.1),
    "sgd": lambda o, bf16: o.sgd(0.01),
    "sgd_momentum": lambda o, bf16: o.sgd(0.01, momentum=0.9),
    "sgd_nesterov": lambda o, bf16: o.sgd(0.01, momentum=0.9, nesterov=True),
    "scale_by_constant_schedule": lambda o, bf16: o.scale_by_schedule(
        o.constant_schedule(-0.01)),
    "scale_by_linear_decay": lambda o, bf16: o.scale_by_schedule(
        o.linear_decay(-0.05, -0.001, 6)),
    "scale_by_warmup_cosine": lambda o, bf16: o.scale_by_schedule(
        o.warmup_cosine(-0.05, 3, 9, end_value=-0.002)),
    "clip_then_adamw": lambda o, bf16: o.chain(
        o.clip_by_global_norm(1.0), o.adamw(0.02, weight_decay=1e-3)),
    "accumulate_adamw_every_3": lambda o, bf16: o.accumulate_gradients(
        o.adamw(0.02, weight_decay=1e-3), every=3),
}


def _run_both(make, steps, rng, on_step=None):
    """``steps`` updates of the JAX and port transformations from the same
    tree and numpy gradients; yields both parameter lists after each."""
    init = _tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, init)
    tparams = [torch.tensor(x) for x in jax.tree_util.tree_leaves(init)]
    jo, to = make(jopt, jnp.bfloat16), make(topt, torch.bfloat16)
    jstate, tstate = jo.init(jparams), to.init(tparams)
    jupdate = jax.jit(jo.update)
    for i in range(steps):
        if on_step is not None:
            jstate, tstate = on_step(i, jstate, tstate)
        grads = _tree(rng, scale=rng.choice([1e-4, 1.0, 30.0]))
        updates, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads),
                                  jstate, jparams)
        jparams = jopt.apply_updates(jparams, updates)
        tstate = topt.step(
            to, [torch.tensor(g) for g in jax.tree_util.tree_leaves(grads)],
            tstate, tparams)
        yield jax.tree_util.tree_leaves(jparams), tparams, jstate, tstate


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_every_optimizer_matches_jax_over_ten_steps(name):
    """1e-5 for float32 state (the conformance tolerance), 2e-2 for
    bfloat16 moments, which both sides round at the same places but whose
    bias-corrected update amplifies a one-bit moment difference."""
    tol = 2e-2 if "bf16" in name else 1e-5
    for jleaves, tparams, _, _ in _run_both(OPTIMIZERS[name], 10,
                                            np.random.default_rng(2)):
        for j, t in zip(jleaves, tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol,
                                       atol=tol)


def test_set_injected_lr_retunes_both_packages_alike():
    def retune(i, jstate, tstate):
        if i == 4:
            jstate = jopt.set_injected_lr(jstate, 0.003)
            tstate = topt.set_injected_lr(tstate, 0.003)
        return jstate, tstate

    for jleaves, tparams, jstate, tstate in _run_both(
            OPTIMIZERS["adamw_inject_lr"], 8, np.random.default_rng(3),
            retune):
        for j, t in zip(jleaves, tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-5)
    assert float(topt.get_injected_lr(tstate)) == float(
        jopt.get_injected_lr(jstate)) == np.float32(0.003)
    assert topt.get_injected_lr(topt.adamw(0.1).init([torch.ones(2)])) is None
    with pytest.raises(ValueError, match="no InjectLRState"):
        topt.set_injected_lr(topt.adamw(0.1).init([torch.ones(2)]), 0.5)
    with pytest.raises(ValueError, match="not a schedule"):
        topt.inject_lr(topt.constant_schedule(0.1))


SCHEDULES = {
    "constant": lambda o: o.constant_schedule(0.3),
    "linear_decay": lambda o: o.linear_decay(0.1, 0.01, 7),
    "cosine_decay": lambda o: o.cosine_decay(0.1, 9, alpha=0.2),
    "warmup_cosine": lambda o: o.warmup_cosine(0.1, 4, 15, end_value=0.005),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    counts = np.arange(0, 25, dtype=np.int32)
    want = [float(SCHEDULES[name](jopt)(jnp.asarray(c))) for c in counts]
    got = [float(SCHEDULES[name](topt)(torch.tensor(c))) for c in counts]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_step_on_the_cpu_is_update_then_apply_updates():
    rng = np.random.default_rng(4)
    leaves = jax.tree_util.tree_leaves(_tree(rng))
    a = [torch.tensor(x) for x in leaves]
    b = [torch.tensor(x) for x in leaves]
    opt = topt.adamw(0.05, weight_decay=1e-3)
    sa, sb = opt.init(a), opt.init(b)
    for _ in range(3):
        grads = [torch.tensor(x) for x in jax.tree_util.tree_leaves(
            _tree(rng))]
        sa = topt.step(opt, grads, sa, a)
        updates, sb = opt.update(grads, sb, b)
        topt.apply_updates(b, updates)
    for x, y in zip(a + sa[0].mu + sa[0].nu, b + sb[0].mu + sb[0].nu):
        assert torch.equal(x, y)
    assert int(sa[0].count) == int(sb[0].count) == 3


@pytest.mark.parametrize("make", [
    lambda: topt.sgd(0.1, momentum=0.9), lambda: topt.adagrad(0.1),
    lambda: topt.adamw(topt.cosine_decay(0.1, 5)),
    lambda: topt.chain(topt.clip_by_global_norm(1.0), topt.adamw(0.1))])
def test_step_off_the_cpu_raises_without_a_fused_pass(make):
    """Off the CPU, step runs a fused pass or raises: never the chain."""
    params = [torch.ones(4, device="meta")]
    opt = make()
    with pytest.raises(ValueError, match="no fused pass"):
        topt.step(opt, [torch.ones(4, device="meta")], opt.init(params),
                  params)


def test_fused_adamw_takes_only_cuda_tensors():
    params = [torch.ones(4, device="meta")]
    opt = topt.adamw(0.1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        topt.step(opt, [torch.ones(4, device="meta")], opt.init(params),
                  params)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        topt.step(opt, [torch.ones(4, device="meta")], opt.init(params),
                  params, norm=True)


@pytest.mark.parametrize("n", [1, 3, 4, 7, 100, 1023, 4097, 1_000_003])
@pytest.mark.parametrize("vector", [True, False])
def test_adamw_launch_plan_visits_every_element_once(n, vector):
    """The kernel's grid-stride loops, mirrored in numpy: every element is
    updated by exactly one thread, vectors first, then the tail."""
    from repro_torch.kernels.adamw import BLOCKS_PER_SM, launch_plan

    sm_count = 132
    plan = launch_plan(n, vector, sm_count)
    assert 1 <= plan.blocks <= BLOCKS_PER_SM * sm_count
    stride = plan.blocks * plan.threads
    visits = np.zeros(n, np.int64)
    n_vec = n // 4 if plan.vector else 0
    for first in range(min(stride, max(n_vec, n - 4 * n_vec, 1))):
        vec = np.arange(first, n_vec, stride)
        for q in range(4):
            np.add.at(visits, vec * 4 + q, 1)
        np.add.at(visits, np.arange(n_vec * 4 + first, n, stride), 1)
    assert (visits == 1).all()


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4, 0.1])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_kernel_arithmetic_in_numpy_matches_the_cpu_chain(
        moments, weight_decay):
    """csrc/adamw.cu's arithmetic (csrc/adam_math.cuh's, with the dense
    form's last line), one correctly rounded float32 operation
    at a time as its intrinsics do (b ** count in double from the float32
    b, rounded once; bfloat16 moments rounded to nearest even and read
    back), against the CPU chain over ten steps: the moments equal to the
    bit; the parameters within 1e-6, because torch's vectorized CPU sqrt is
    not correctly rounded everywhere (6,549 of 1,000,003 normal draws off by
    an ulp, measured with torch 2.13), where the kernel's is."""
    f32 = np.float32
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 3e-3
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=4099).astype(f32)

    def to_bf16(x):
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()

    p, m, v = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    tp = [torch.tensor(p0)]
    mdt = getattr(torch, moments)
    opt = topt.adamw(lr, weight_decay=weight_decay, moment_dtype=mdt)
    state = opt.init(tp)
    for count in range(1, 11):
        g = (rng.normal(size=4099)
             * rng.choice([1e-3, 1.0, 30.0])).astype(f32)
        m = f32(b1) * m + f32(1 - b1) * g
        v = f32(b2) * v + (g * g) * f32(1 - b2)
        if moments == "bfloat16":
            m, v = to_bf16(m), to_bf16(v)
        c1 = f32(1) - f32(float(f32(b1)) ** count)
        c2 = f32(1) - f32(float(f32(b2)) ** count)
        u = (m / c1) / (np.sqrt(v / c2) + f32(eps))
        if weight_decay:
            u = u + f32(weight_decay) * p
        p = p + u * f32(-lr)
        state = topt.step(opt, [torch.from_numpy(g)], state, tp)
        np.testing.assert_allclose(tp[0].numpy(), p, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(state[0].mu[0].float().numpy(), m)
        np.testing.assert_array_equal(state[0].nu[0].float().numpy(), v)


#: bfloat16 gradients with bfloat16 moments: elements of the parameters
#: (of 4,099, after ten steps) that differ from JAX's, and by how much.
#: JAX computes ``b1 m + (1 - b1) g`` with float32 kept between the fused
#: operations, the port (and the kernel) rounds each product, so a moment
#: can round to another bfloat16 and move the parameter by one bfloat16
#: step. Measured with jax 0.9.0 and torch 2.13.
BF16_CHAIN_GAP = {"elements": 41, "max_abs": 2.0 ** -9}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("grads", ["float32", "bfloat16"])
def test_adamw_on_bfloat16_parameters_matches_jax(grads, moments):
    """The LM family's case: bfloat16 parameters (float32 or bfloat16
    gradients, float32 or bfloat16 moments) through ``optim.step`` on the
    CPU against JAX's adamw + apply_updates over ten steps: the update
    rounded to bfloat16 and added in bfloat16, the parameters staying
    bfloat16. Equal to the bit, but for the pinned gap of bfloat16
    gradients with bfloat16 moments."""
    rng = np.random.default_rng(0)
    p0 = (rng.normal(size=4099) * 0.05).astype(np.float32)
    jp = [jnp.asarray(p0, jnp.bfloat16)]
    tp = [torch.tensor(p0).to(torch.bfloat16)]
    jo = jopt.adamw(3e-2, weight_decay=0.1,
                    moment_dtype=getattr(jnp, moments))
    to = topt.adamw(3e-2, weight_decay=0.1,
                    moment_dtype=getattr(torch, moments))
    jstate, tstate = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for _ in range(10):
        g = (rng.normal(size=4099)
             * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
        updates, jstate = jupdate([jnp.asarray(g).astype(getattr(jnp, grads))],
                                  jstate, jp)
        jp = jopt.apply_updates(jp, updates)
        tstate = topt.step(to, [torch.tensor(g).to(getattr(torch, grads))],
                           tstate, tp)
    assert jp[0].dtype == jnp.bfloat16 and tp[0].dtype == torch.bfloat16
    want = np.asarray(jp[0].astype(jnp.float32))
    got = tp[0].float().numpy()
    apart = want != got
    if grads == moments == "bfloat16":
        assert 0 < apart.sum() <= BF16_CHAIN_GAP["elements"]
        assert np.abs(want - got).max() <= BF16_CHAIN_GAP["max_abs"]
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grads", ["float32", "bfloat16"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_kernel_bfloat16_parameter_arithmetic_matches_the_cpu_chain(
        moments, grads):
    """csrc/adamw.cu's form for a bfloat16 parameter, one correctly rounded
    float32 operation at a time in numpy: the gradient read into float32,
    the update rounded to bfloat16, then p + u in float32 rounded to
    bfloat16; against the CPU chain over ten steps, the moments equal to
    the bit, and the parameters too (the float32 form's one-ulp sqrt
    differences round away in bfloat16 here)."""
    f32 = np.float32
    b1, b2, eps, lr, wd = 0.9, 0.999, 1e-8, 3e-2, 0.1

    def to_bf16(x):
        return torch.from_numpy(np.asarray(x, f32)).to(
            torch.bfloat16).float().numpy()

    rng = np.random.default_rng(8)
    p = to_bf16(rng.normal(size=4099) * 0.05)
    m, v = np.zeros_like(p), np.zeros_like(p)
    tp = [torch.from_numpy(p.copy()).to(torch.bfloat16)]
    opt = topt.adamw(lr, weight_decay=wd, moment_dtype=getattr(torch, moments))
    state = opt.init(tp)
    for count in range(1, 11):
        g = (rng.normal(size=4099)
             * rng.choice([1e-3, 1.0, 30.0])).astype(f32)
        if grads == "bfloat16":
            g = to_bf16(g)
        m = f32(b1) * m + f32(1 - b1) * g
        v = f32(b2) * v + (g * g) * f32(1 - b2)
        if moments == "bfloat16":
            m, v = to_bf16(m), to_bf16(v)
        c1 = f32(1) - f32(float(f32(b1)) ** count)
        c2 = f32(1) - f32(float(f32(b2)) ** count)
        u = (m / c1) / (np.sqrt(v / c2) + f32(eps)) + f32(wd) * p
        p = to_bf16(p + to_bf16(u * f32(-lr)))
        state = topt.step(opt, [torch.from_numpy(g).to(getattr(torch, grads))],
                          state, tp)
        np.testing.assert_array_equal(state[0].mu[0].float().numpy(), m)
        np.testing.assert_array_equal(state[0].nu[0].float().numpy(), v)
        np.testing.assert_array_equal(tp[0].float().numpy(), p)
