"""Parity of the port's ``dcn_cross`` (the DCN-V2 cross layer
``x0 * (x @ W + b) + x``) with repro.kernels on the CPU.

The port's op (an autograd Function whose CPU route is the kernel's plain
version) and ``dcn_cross_plain`` against JAX's ``dcn_cross`` run as the JAX
tests run it: ``impl="pallas"`` (interpret mode off-TPU) and ``impl="ref"``.
Shapes: the conformance harness's (``testing/conformance.py``),
``tests/test_kernels.py``'s sweep (D up to 469), B = 1 / D = 1, and the
two-tower click model's D = 16; float32 and bfloat16 inputs made from the
same numpy draws. Gradients of all four inputs against ``jax.grad`` of
``dcn_cross_ref``, with x aliased to x0 as in the first cross layer.
Tolerances (rtol = atol): 1e-5 for float32 where the longest sum behind
a value has at most 130 terms, 1e-4 above, where a long sum's order
differs; 2e-2 for bfloat16 (``conformance.py:44-47``). The forward and
d/dx0, d/dx sum over D; d/dW and d/db over the B rows. The CUDA kernel
runs only on a GPU (chip_smoke.py); here its launch counter stays at 0 and
its wrapper refuses CPU tensors.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import kernels as jk
from repro.kernels import ref as jref
from repro_torch import kernels as tk

SHAPES = [(8, 64), (256, 128), (300, 130), (5, 190), (64, 469), (1, 1),
          (640, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(terms, dtype):
    """By the number of terms in the longest sum behind a value."""
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    tol = 1e-5 if terms <= 130 else 1e-4
    return dict(rtol=tol, atol=tol)


def _inputs(B, D, seed=0):
    """The conformance harness's draws: W scaled by 1/sqrt(D)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32),
            (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32),
            rng.normal(size=(D,)).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _jax_cross(impl):
    return jax.jit(lambda x0, x, w, b: jk.dcn_cross(x0, x, w, b, impl=impl))


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,D", SHAPES)
def test_dcn_cross_matches_jax(B, D, dtype, impl):
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(B, D)
    want = np.asarray(_jax_cross(impl)(
        *(jnp.asarray(a).astype(jdt) for a in arrays)))
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    for got in (tk.dcn_cross(*ts), tk.dcn_cross_plain(*ts)):
        assert got.dtype == torch.float32 and got.shape == (B, D)
        np.testing.assert_allclose(got.numpy(), want, **_tol(D, dtype))
    assert tk.dcn_cross_cuda.launches == 0


@pytest.mark.parametrize("aliased", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,D", [(8, 64), (300, 130), (64, 469), (640, 16)])
def test_dcn_cross_grads_match_jax(B, D, dtype, aliased):
    """d/dx0, d/dx, d/dW, d/db of sum(out * g) against jax.grad of the ref
    form; with ``aliased`` x is x0 (one leaf, both contributions summed)."""
    jdt, tdt = DTYPES[dtype]
    x0, x, w, b = _inputs(B, D, seed=1)
    g = np.random.default_rng(2).normal(size=(B, D)).astype(np.float32)

    def jloss(x0, x, w, b):
        return jnp.sum(jref.dcn_cross_ref(x0, x0 if aliased else x, w, b) * g)

    jargs = [jnp.asarray(a).astype(jdt) for a in (x0, x, w, b)]
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (x0, x, w, b)]
    tx0, tx, tw, tb = leaves
    out = tk.dcn_cross(tx0, tx0 if aliased else tx, tw, tb)
    torch.sum(out * torch.from_numpy(g)).backward()
    terms = {"x0": D, "x": D, "w": B, "b": B}
    for name, leaf, want in zip(terms, leaves, jgrads):
        if aliased and name == "x":
            assert leaf.grad is None
            continue
        assert leaf.grad.dtype == tdt
        np.testing.assert_allclose(leaf.grad.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   err_msg=name,
                                   **_tol(terms[name], dtype))


def test_aliased_grad_is_the_sum_of_both_uses():
    """x0 aliased to x gets exactly d/dx0 + d/dx of the unaliased call."""
    x0, _, w, b = [torch.from_numpy(a) for a in _inputs(33, 24, seed=3)]
    g = torch.from_numpy(
        np.random.default_rng(4).normal(size=(33, 24)).astype(np.float32))
    a = x0.clone().requires_grad_()
    torch.sum(tk.dcn_cross(a, a, w, b) * g).backward()
    p, q = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    torch.sum(tk.dcn_cross(p, q, w, b) * g).backward()
    torch.testing.assert_close(a.grad, p.grad + q.grad, rtol=0, atol=0)


def test_mixed_dtypes_are_cast_to_float32():
    x0, x, w, b = _inputs(16, 16, seed=5)
    want = tk.dcn_cross_plain(*(torch.from_numpy(a) for a in (x0, x, w, b)))
    got = tk.dcn_cross(torch.from_numpy(x0).bfloat16().float(),
                       torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                       torch.from_numpy(b))
    jwant = jref.dcn_cross_ref(jnp.asarray(x0).astype(jnp.bfloat16)
                               .astype(jnp.float32),
                               jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)
    assert not torch.equal(got, want)  # the bf16 rounding reached the op


def test_cuda_wrapper_refuses_cpu_tensors():
    ts = [torch.from_numpy(a) for a in _inputs(4, 8)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.dcn_cross_cuda(*ts)
    assert tk.dcn_cross_cuda.launches == 0
