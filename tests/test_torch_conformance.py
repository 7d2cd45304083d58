"""The port's conformance harness (repro_torch.testing.conformance) against
JAX's (repro.testing.conformance), on the CPU.

Each cell feeds JAX's own draws for a (kernel, shape, dtype) to JAX's ref
oracle and to the port's two routes: ``kernel``, the public op (on the CPU
its plain forward with the op's own backward) and ``plain``, the plain
version under autograd. Values and the projected gradients must agree at
JAX's ``TOLS`` (1e-5 float32, 2e-2 bfloat16). The port's input makers must
draw JAX's inputs bit for bit, its extreme corpus must stay finite, its
harness must cover the six kernels, and its sweep must hold on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.testing import conformance as jconf
from repro_torch import kernels as tkernels
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import layout
from repro_torch.testing import conformance as tconf

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = [s.name for s in tconf.KERNEL_SPECS]
CELLS = [(s.name, shape, dt) for s in tconf.KERNEL_SPECS
         for shape in s.shapes for dt in DTYPES]
CELL_IDS = [f"{n}-{'x'.join(map(str, s))}-{d}" for n, s, d in CELLS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(a, tdtype):
    a = np.asarray(a)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.array(a, np.float32)).to(tdtype)


@functools.lru_cache(maxsize=None)
def _jax_cell(name, shape, dtype):
    """JAX's args for the cell, its ref value and its ref projected grads,
    drawn as JAX's check_value / check_grads draw them (seed 0)."""
    jspec = jconf.SPECS_BY_NAME[name]
    jdtype, tdtype = DTYPES[dtype]
    rng = np.random.default_rng(0)
    args = jspec.make_inputs(rng, shape, jdtype)
    out = jspec.call(args, "ref")
    proj = jnp.asarray(rng.normal(size=np.shape(out)), jnp.float32)
    grads = jconf._projected_scalar(jspec, args, "ref", proj)
    targs = tuple(_to_torch(a, tdtype if a.dtype == jdtype else torch.float32)
                  for a in args)
    return targs, out, torch.from_numpy(np.array(proj)), grads


def _close(got, want, dtype, what):
    rtol, atol = jconf.TOLS[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _dcn_exact_grads(args, proj, absolute=False):
    """dcn_cross's four gradients of sum(proj * (x0 (x W + b) + x)) in
    float64 numpy from the float32 inputs: dx0 = P z, dx = (P x0) W^T + P,
    dW = x^T (P x0), db = sum_rows P x0. With ``absolute``, the same sums
    over the terms' magnitudes (each element's rounding scale)."""
    x0, x, w, b, p = (a.detach().double().numpy() for a in (*args, proj))
    if absolute:
        x0, x, w, b, p = map(np.abs, (x0, x, w, b, p))
    h = p * x0
    return p * (x @ w + b), h @ w.T + p, x.T @ h, h.sum(0)


def _close_or_exact(got, want, args, proj, n, what):
    """Within TOLS of JAX's float32 gradient or, where that reference is
    itself off, of the float64 value within TOLS plus float32 rounding of
    its sums (sqrt(rows) eps32 times the sum of the terms' magnitudes): an
    element of dW is a sum over 256 rows of products near 1 that can cancel
    to ~0.04, which either package rounds by ~2e-5 in its own order."""
    rtol, atol = jconf.TOLS["float32"]
    g = got.detach().numpy()
    miss = ~np.isclose(g, np.asarray(want), rtol=rtol, atol=atol)
    exact = _dcn_exact_grads(args, proj)[n][miss]
    scale = _dcn_exact_grads(args, proj, absolute=True)[n][miss]
    rows = max(args[0].shape)
    bound = atol + rtol * np.abs(exact) + rows ** 0.5 * 2.0 ** -23 * scale
    gap = np.abs(g[miss] - exact)
    assert np.all(gap <= bound), (what, gap, bound)


@pytest.mark.parametrize("name,shape,dtype", CELLS, ids=CELL_IDS)
def test_inputs_are_jax_draws(name, shape, dtype):
    """The port's input makers draw JAX's inputs bit for bit, and the
    gradient projection after them."""
    targs, _, tproj, _ = _jax_cell(name, shape, dtype)
    args, proj = tconf.inputs(tconf.SPECS_BY_NAME[name], shape,
                              DTYPES[dtype][1])
    for a, b in zip(args, targs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert torch.equal(proj, tproj)


@pytest.mark.parametrize("impl", tconf.IMPLS)
@pytest.mark.parametrize("name,shape,dtype", CELLS, ids=CELL_IDS)
def test_value_matches_jax_ref(name, shape, dtype, impl):
    targs, want, _, _ = _jax_cell(name, shape, dtype)
    spec = tconf.SPECS_BY_NAME[name]
    with torch.no_grad():
        _close(spec.call(targs, impl), want, dtype, f"{name}[{impl}]")


@pytest.mark.parametrize("impl", tconf.IMPLS)
@pytest.mark.parametrize("name,shape,dtype", CELLS, ids=CELL_IDS)
def test_grads_match_jax_ref(name, shape, dtype, impl):
    """The projected gradient through the public op (its own backward) and
    through the plain version's autograd, against jax.grad of JAX's ref
    (for fm_interaction, dcn_cross and flash_attention: autodiff of
    kernels/ref.py, since their Pallas forms have no gradient)."""
    targs, _, proj, want = _jax_cell(name, shape, dtype)
    spec = tconf.SPECS_BY_NAME[name]
    got = tconf.projected_grads(spec, targs, impl, proj)
    assert len(got) == len(want)
    for n, (i, g, w) in enumerate(zip(spec.diff_argnums, got, want)):
        assert g.dtype == targs[i].dtype
        if name == "dcn_cross" and dtype == "float32":
            _close_or_exact(g, w, targs, proj, n,
                            f"{name}[{impl}] grad arg {i}")
        else:
            _close(g, w, dtype, f"{name}[{impl}] grad arg {i}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", tconf.SPECS_BY_NAME["flash_attention"]
                         .shapes, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_views_match_jax_ref(shape, dtype):
    """q, k, v as transpose(1, 2) views of (B, S, H, Dh) tensors (AutoInt's
    and BST's layout): the op's value, layout and gradients against JAX's
    ref on the same values."""
    targs, want, proj, want_grads = _jax_cell("flash_attention", shape, dtype)
    spec = tconf.SPECS_BY_NAME["flash_attention"]
    views = spec.views(targs)
    assert all(t.transpose(1, 2).is_contiguous() for t in views)
    assert layout(views[0]) == 1
    out = spec.call(views, "kernel")
    assert out.stride() == views[0].stride()
    _close(out, want, dtype, "views value")
    for i, g, w in zip(spec.diff_argnums,
                       tconf.projected_grads(spec, views, "kernel", proj),
                       want_grads):
        _close(g, w, dtype, f"views grad arg {i}")


@pytest.mark.parametrize("impl", tconf.IMPLS)
@pytest.mark.parametrize("name", [s.name for s in tconf.KERNEL_SPECS
                                  if s.extreme_cases is not None])
def test_extreme_corpus_nan_free(name, impl):
    spec = tconf.SPECS_BY_NAME[name]
    jcases = jconf.SPECS_BY_NAME[name].extreme_cases()
    tcases = spec.extreme_cases("cpu")
    assert len(tcases) == len(jcases)
    for t, j in zip(tcases, jcases):  # the same corpus as JAX's
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tconf.check_extreme(spec, impl, "cpu") == []


@pytest.mark.parametrize("impl", tconf.IMPLS)
def test_examination_nll_saturated_sessions_finite_with_zero_grad(impl):
    assert tconf.saturated_session_misses(impl, "cpu") == []


def test_sweep_holds_on_the_cpu_and_reports_every_cell():
    report, misses = tconf.run_conformance(device="cpu")
    assert misses == []
    assert list(report) == NAMES
    for name, row in report.items():
        spec = tconf.SPECS_BY_NAME[name]
        per_dtype = len(spec.shapes) * 2 * (2 if spec.views else 1)
        assert row["cells"] == row["held"] == per_dtype * len(tconf.DTYPES)
        assert row["max_value_err"] <= 1e-5
    assert report["examination_nll"]["extreme_cases"] == 25
    assert report["session_nll"]["extreme_cases"] == 27


def test_a_miss_is_reported_after_every_cell(monkeypatch):
    """A wrong op is caught by value and by gradient, and the sweep still
    measures the other kernels before it raises."""
    spec = tconf.SPECS_BY_NAME["fm_interaction"]
    broken = dataclasses.replace(
        spec, op=lambda v: 1.1 * tops.fm_interaction(v))
    specs = tuple(broken if s.name == "fm_interaction" else s
                  for s in tconf.KERNEL_SPECS)
    monkeypatch.setattr(tconf, "KERNEL_SPECS", specs)
    report, misses = tconf.run_conformance(device="cpu")
    assert list(report) == NAMES
    assert report["fm_interaction"]["held"] == 0
    assert all(row["held"] == row["cells"] for n, row in report.items()
               if n != "fm_interaction")
    # 3 shapes x 2 dtypes, each by value and by gradient
    assert len(misses) == 12 and all("fm_interaction" in m for m in misses)
    for check in (tconf.check_value, tconf.check_grads):
        err, held = check(spec, "kernel", spec.shapes[0])
        assert held and err <= 1e-5
        err, held = check(broken, "kernel", spec.shapes[0])
        assert not held and err > 1e-5


@pytest.mark.parametrize("name", ["session_nll", "examination_nll",
                                  "embedding_bag", "fm_interaction"])
def test_ops_hand_their_kernels_float32(name, monkeypatch):
    """ROADMAP C.5: these four kernels read float32, and JAX's Pallas forms
    take bfloat16 and compute in float32. The op widens its float inputs
    before the route, so a bfloat16 call reaches the kernel as float32 (on
    the card it raised TypeError), with the gradient back in bfloat16."""
    seen = []

    def route(device, kernel, plain):
        def record(*args, **kwargs):
            seen.append([a.dtype for a in args if torch.is_tensor(a)])
            return plain(*args, **kwargs)
        return record

    monkeypatch.setattr(tops, "_route", route)
    spec = tconf.SPECS_BY_NAME[name]
    args, proj = tconf.inputs(spec, spec.shapes[0], torch.bfloat16)
    grads = tconf.projected_grads(spec, args, "kernel", proj)
    assert seen and all(d in (torch.float32, torch.bool, torch.int32)
                        for d in seen[0])
    assert grads[0].dtype == torch.bfloat16
