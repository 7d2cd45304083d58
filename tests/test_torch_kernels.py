"""Parity of the port's loss ops with repro.kernels on the CPU.

The port's ``examination_nll`` and ``session_nll`` (autograd Functions whose
CPU route is the kernel's plain version) against JAX's, run as the JAX
tests run them: ``impl="pallas"`` (interpret mode off-TPU) and
``impl="ref"``. Values and gradients w.r.t. every differentiable input, at
shapes covering B in {1, 7, 256, 300} and K in {1, 10, 33, 128, 130}, plus
the extreme (|x| = 36) and fully masked corpus of the JAX conformance
harness. The hand-written kernels themselves run only on a GPU
(chip_smoke.py); here their launch counters must stay at 0 and their
wrappers must refuse CPU tensors, and ``examination_nll``'s plain-Python
launch plan must cover every row once within a block's shared memory.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import kernels as jk
from repro.testing.conformance import (_examination_extreme_cases,
                                       _session_extreme_cases)
from repro_torch import kernels as tk

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(1, 1), (1, 130), (7, 10), (7, 33), (256, 10), (256, 128),
          (300, 1), (300, 130)]
# Differentiable argument positions (the mask is not).
EXAM_DIFF = (0, 1, 3, 4, 5, 6)
SESSION_DIFF = (0, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exam_inputs(rng, b, k):
    """The conformance harness's examination inputs, in numpy."""
    logits = (rng.normal(size=(b, k)) * 4.0).astype(np.float32)
    clicks = rng.integers(0, 2, (b, k)).astype(np.float32)
    mask = np.arange(k)[None, :] < rng.integers(1, k + 1, (b, 1))
    pss = rng.uniform(0.05, 0.95, (b, k)).astype(np.float32)
    p_death = rng.uniform(0.0, 0.5, (b, k)).astype(np.float32)
    p_reset = rng.uniform(0.05, 0.95, (b, k)).astype(np.float32)
    return [logits, clicks, mask, pss, p_death, p_reset,
            (1.0 - p_reset).astype(np.float32)]


def session_inputs(rng, b, k):
    logits = (rng.normal(size=(b, k)) * 4.0).astype(np.float32)
    clicks = rng.integers(0, 2, (b, k)).astype(np.float32)
    mask = rng.random((b, k)) < 0.8
    return [logits, clicks, mask]


@functools.lru_cache(maxsize=None)
def _jax_loss(name, impl):
    fn = getattr(jk, name)
    return jax.jit(lambda *a: fn(*a, impl=impl))


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(name, diff):
    return jax.jit(jax.grad(lambda *a: getattr(jk, name)(*a, impl="ref"),
                            argnums=diff))


def _jax_value(name, args, impl):
    return float(_jax_loss(name, impl)(*[jnp.asarray(a) for a in args]))


def _jax_grads(name, args, diff):
    grads = _jax_grad_fn(name, diff)(*[jnp.asarray(a) for a in args])
    return [np.asarray(g) for g in grads]


def _torch_value_and_grads(name, args, diff):
    targs = [torch.tensor(np.asarray(a), requires_grad=i in diff)
             for i, a in enumerate(args)]
    loss = getattr(tk, name)(*targs)
    grads = torch.autograd.grad(loss, [targs[i] for i in diff])
    return float(loss.detach()), [g.numpy() for g in grads]


CASES = {"examination_nll": (exam_inputs, EXAM_DIFF),
         "session_nll": (session_inputs, SESSION_DIFF)}


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_matches_jax(name, shape, impl):
    make, diff = CASES[name]
    args = make(np.random.default_rng(sum(shape)), *shape)
    want = _jax_value(name, args, impl)
    got, _ = _torch_value_and_grads(name, args, diff)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_grads_match_jax(name, shape):
    """JAX's backward is impl-independent (custom VJP), so one oracle."""
    make, diff = CASES[name]
    args = make(np.random.default_rng(sum(shape)), *shape)
    _, got = _torch_value_and_grads(name, args, diff)
    for g, w in zip(got, _jax_grads(name, args, diff)):
        np.testing.assert_allclose(g, w, **TOL)


EXTREME = {"examination_nll": (_examination_extreme_cases, EXAM_DIFF),
           "session_nll": (_session_extreme_cases, SESSION_DIFF)}


@pytest.mark.parametrize("name", sorted(EXTREME))
def test_extreme_corpus_finite_and_matches_jax(name):
    cases, diff = EXTREME[name]
    for args in cases():
        args = [np.asarray(a) for a in args]
        got, grads = _torch_value_and_grads(name, args, diff)
        assert np.isfinite(got)
        for g in grads:
            assert np.all(np.isfinite(g))
        np.testing.assert_allclose(got, _jax_value(name, args, "ref"), **TOL)
        for g, w in zip(grads, _jax_grads(name, args, diff)):
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fully_masked_batch_gives_zero_loss_and_grads(name):
    make, diff = CASES[name]
    args = make(np.random.default_rng(5), 9, 10)
    args[2] = np.zeros_like(args[2])
    got, grads = _torch_value_and_grads(name, args, diff)
    assert got == 0.0
    for g in grads:
        assert np.all(g == 0.0)


def test_saturated_sessions_keep_finite_loss_and_zero_tail_grad():
    """Mirror of the JAX conformance pin: odds driven past the cap keep a
    finite loss, and saturated positions pass no gradient."""
    b, k = 4, 12
    ones = torch.ones(b, k)
    pss = torch.full((b, k), float(np.exp(-36.0)), requires_grad=True)
    loss = tk.examination_nll(ones * 36.0, torch.zeros(b, k),
                              torch.ones(b, k, dtype=torch.bool), pss,
                              ones * 0.0, ones * 0.5, ones * 0.5)
    (g,) = torch.autograd.grad(loss, [pss])
    assert torch.isfinite(loss)
    assert torch.all(torch.isfinite(g))
    assert torch.all(g[:, -1] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_ref_composition(name):
    """The fused plain forms (what the CPU runs and the GPU kernels are held
    against) agree with the literal ref compositions."""
    make, _ = CASES[name]
    plain = getattr(tk, name + "_plain")
    ref = getattr(tk, name + "_ref")
    for shape in SHAPES:
        args = [torch.from_numpy(np.asarray(a))
                for a in make(np.random.default_rng(7), *shape)]
        torch.testing.assert_close(plain(*args), ref(*args), **TOL)


def test_kernels_are_not_launched_on_cpu_and_refuse_cpu_tensors():
    rng = np.random.default_rng(8)
    exam = [torch.from_numpy(np.asarray(a)) for a in exam_inputs(rng, 5, 10)]
    sess = [torch.from_numpy(np.asarray(a)) for a in session_inputs(rng, 5, 10)]
    tk.examination_nll(*exam)
    tk.session_nll(*sess)
    assert tk.examination_nll_cuda.launches == 0
    assert tk.session_nll_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        tk.examination_nll_cuda(*exam)
    with pytest.raises(ValueError, match="CUDA"):
        tk.session_nll_cuda(*sess)


def test_tensors_on_another_device_have_no_route():
    meta = [torch.empty(3, 4, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="no route"):
        tk.session_nll(meta[0], meta[1],
                       torch.empty(3, 4, dtype=torch.bool, device="meta"))


# ---------------------------------------------------------------------------
# examination_nll's launch plan (the kernel itself runs on a GPU only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [1, 10, 15, 16, 33, 128, 130, 512, 1024])
@pytest.mark.parametrize("rows", [1, 7, 255, 257, 65536])
def test_exam_launch_plan_covers_every_row_once_within_shared_memory(rows,
                                                                      cols):
    from repro_torch.kernels.examination_nll import (MAX_THREADS,
                                                     SMEM_PER_BLOCK,
                                                     SMEM_TARGET,
                                                     launch_plan,
                                                     staged_bytes)

    plan = launch_plan(rows, cols)
    R = plan.rows_per_block
    # Rows x K x (six floats and a bool mask), each span on 16 bytes.
    assert plan.smem_bytes == staged_bytes(R, cols) >= R * cols * 25
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes <= SMEM_TARGET or R == 1
    if R < 128:  # halved only while over the target
        assert staged_bytes(2 * R, cols) > SMEM_TARGET
    # One thread per row at least, whole warps, within the kernel's limit.
    assert R <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    # Block g owns rows [g R, min((g + 1) R, rows)): each row exactly once.
    owned = np.zeros(rows, dtype=np.int64)
    for g in {0, plan.grid - 1}:
        owned[g * R:min((g + 1) * R, rows)] += 1
    assert plan.grid == -(-rows // R) and (plan.grid - 1) * R < rows
    starts = np.arange(plan.grid) * R
    assert np.minimum(R, rows - starts).sum() == rows
    assert owned.max() == 1


def test_exam_launch_plan_main_shape_long_rows_and_overrides():
    from repro_torch.kernels.examination_nll import launch_plan

    main = launch_plan(65536, 10)
    assert (main.rows_per_block, main.threads, main.grid) == (128, 512, 512)
    long_rows = launch_plan(5, 2500)      # one row opts into > 48 KB
    assert long_rows.rows_per_block == 1 and long_rows.smem_bytes > 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(5, 10_000)
    assert launch_plan(65536, 10, 256).grid == 256
    with pytest.raises(ValueError, match="rows_per_block"):
        launch_plan(65536, 10, 1024)
