"""Differential conformance harness for the port's six kernel ops (port of
``repro.testing.conformance``).

Each op of :mod:`repro_torch.kernels` must agree with its plain version on
values, on gradients and on NaN-freedom over the adversarial corpus, for
every dtype and padding-edge shape of JAX's specs (the same shapes, input
makers and corpora, drawn from numpy as JAX draws them). The port has no
registry: its two "impls" are the two routes the device picks between.

* ``"kernel"``: the public op (``ops.examination_nll``, ``ops.session_nll``,
  ``ops.embedding_bag``, ``ops.fm_interaction``, ``ops.dcn_cross``,
  ``ops.flash_attention``), its gradient through the op's own
  ``torch.autograd.Function``. On a CUDA tensor that launches the kernel
  and runs the op's backward on what it produced; on a CPU tensor the op
  has no kernel and takes the plain forward, so there this impl checks the
  op's backward alone. ``embedding_bag``, ``fm_interaction``, ``dcn_cross``
  and ``session_nll`` have a backward written by hand; ``examination_nll``'s
  and ``flash_attention``'s is autograd of the plain version itself, so
  their gradient cells check only that the op hands the gradient back to
  the right inputs, in their dtype and layout.
* ``"plain"``: the kernel's plain version (``*_plain``), differentiated by
  autograd: the reference, independent of the op's hand-written backward.

Three checks per (kernel, impl, dtype, shape) cell, each against the plain
route on the same device; each returns what it found and raises nothing:

* :func:`check_value`: forward parity within the dtype's tolerance
  (:data:`TOLS`: 1e-5 for float32, 2e-2 for bfloat16).
* :func:`check_grads`: gradient parity; the output is scalarized by a
  fixed random projection drawn from numpy after the inputs, as JAX's
  ``_projected_scalar`` does. Every route has a gradient here (JAX's
  Pallas ``fm_interaction``, ``dcn_cross`` and ``flash_attention`` have
  none, so JAX checks those three on its other impls only).
* :func:`check_extreme`: value and gradient finiteness, and bounded
  gradients, on the extreme-logit / fully-masked corpus; and
  :func:`saturated_session_misses`, ``examination_nll`` driven past its
  odds cap: a finite loss and a zero gradient at the capped positions.

``flash_attention``'s cells also run with q, k and v as transpose(1, 2)
views of contiguous (B, S, H, Dh) tensors, the layout AutoInt's and BST's
projections hand the op (``KernelSpec.views``). :func:`run_conformance`
sweeps the kernel route over every cell and returns the misses with the
report.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels

IMPLS = ("kernel", "plain")

#: (rtol, atol) per input dtype. float32 pins the 1e-5 contract; bfloat16
#: inputs round to ~3 decimal digits before the fp32 accumulation, so parity
#: is only meaningful to ~1e-2.
TOLS: Dict[str, Tuple[float, float]] = {
    "float32": (1e-5, 1e-5),
    "bfloat16": (2e-2, 2e-2),
}
DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel's conformance contract."""
    name: str
    #: The public op with autograd (the ``"kernel"`` impl).
    op: Callable[..., torch.Tensor]
    #: Its plain version (the ``"plain"`` impl).
    plain: Callable[..., torch.Tensor]
    #: (np rng, shape tuple, torch dtype, device) -> args tuple.
    make_inputs: Callable[[np.random.Generator, tuple, torch.dtype, object],
                          tuple]
    #: Padding-edge shapes: below / at / straddling lane & block boundaries.
    shapes: Tuple[tuple, ...]
    #: Positions in args that are differentiable inputs.
    diff_argnums: Tuple[int, ...]
    #: (device) -> sequence of args tuples for the NaN/saturation corpus.
    extreme_cases: Optional[Callable[[object], Sequence[tuple]]] = None
    #: Args whose extreme-corpus gradients must also stay under the
    #: magnitude bound (finiteness is checked for all diff args). None =
    #: all diff args. Probability-space factor inputs are exempt: their
    #: gradients legitimately reach ~1/ODDS_FLOOR at saturation.
    extreme_bounded_argnums: Optional[Tuple[int, ...]] = None
    #: args -> the same values in another layout the op takes as it is.
    views: Optional[Callable[[tuple], tuple]] = None

    def call(self, args: tuple, impl: str) -> torch.Tensor:
        if impl == "kernel":
            return self.op(*args)
        if impl == "plain":
            return self.plain(*args)
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")


# ---------------------------------------------------------------------------
# input builders (JAX's draws, in the same order, as torch tensors)
# ---------------------------------------------------------------------------

def _t(x, dtype, device) -> torch.Tensor:
    """A float64 draw rounded to float32 (as ``jnp.asarray(x, float32)``),
    then to ``dtype``."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(device, dtype)


def _bag_inputs(rng, shape, dtype, device):
    B, L, N, D = shape
    table = _t(rng.normal(size=(N, D)), dtype, device)
    # ids include explicit -1 padding slots.
    ids = torch.from_numpy(rng.integers(-1, N, (B, L)).astype(np.int32)
                           ).to(device)
    weights = _t(rng.uniform(0.2, 1.0, (B, L)), torch.float32, device)
    return table, ids, weights


def _session_inputs(rng, shape, dtype, device):
    B, K = shape
    logits = _t(rng.normal(size=(B, K)) * 4.0, dtype, device)
    clicks = _t(rng.integers(0, 2, (B, K)), torch.float32, device)
    mask = torch.from_numpy(rng.random((B, K)) < 0.8).to(device)
    return logits, clicks, mask


def _examination_inputs(rng, shape, dtype, device):
    B, K = shape
    logits = _t(rng.normal(size=(B, K)) * 4.0, dtype, device)
    clicks = _t(rng.integers(0, 2, (B, K)), torch.float32, device)
    mask = torch.from_numpy(
        np.arange(K)[None, :] < rng.integers(1, K + 1, (B, 1))).to(device)
    pss = _t(rng.uniform(0.05, 0.95, (B, K)), torch.float32, device)
    p_death = _t(rng.uniform(0.0, 0.5, (B, K)), torch.float32, device)
    p_reset = _t(rng.uniform(0.05, 0.95, (B, K)), torch.float32, device)
    return logits, clicks, mask, pss, p_death, p_reset, 1.0 - p_reset


def _fm_inputs(rng, shape, dtype, device):
    B, F, D = shape
    return (_t(rng.normal(size=(B, F, D)), dtype, device),)


def _dcn_inputs(rng, shape, dtype, device):
    B, D = shape
    x0 = _t(rng.normal(size=(B, D)), dtype, device)
    x = _t(rng.normal(size=(B, D)), dtype, device)
    w = _t(rng.normal(size=(D, D)) / np.sqrt(D), dtype, device)
    b = _t(rng.normal(size=(D,)), dtype, device)
    return x0, x, w, b


def _flash_inputs(rng, shape, dtype, device):
    B, Hq, Hkv, Sq, Skv, Dh = shape
    scale = 1.0 / np.sqrt(Dh)
    q = _t(rng.normal(size=(B, Hq, Sq, Dh)) * scale, dtype, device)
    k = _t(rng.normal(size=(B, Hkv, Skv, Dh)), dtype, device)
    v = _t(rng.normal(size=(B, Hkv, Skv, Dh)), dtype, device)
    return q, k, v


def _bshd_views(args):
    """q, k, v as transpose(1, 2) views of contiguous (B, S, H, Dh)
    tensors: AutoInt's and BST's layout."""
    return tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                 for t in args)


# ---------------------------------------------------------------------------
# extreme-logit / fully-masked corpus (mirrors tests/test_recursions.py)
# ---------------------------------------------------------------------------

def _session_extreme_cases(device):
    B, K = 4, 10
    ones = torch.ones((B, K), device=device)
    full = torch.ones((B, K), dtype=torch.bool, device=device)
    empty = torch.zeros((B, K), dtype=torch.bool, device=device)
    ragged = (torch.arange(K, device=device)[None, :]
              < torch.tensor([[3], [1], [10], [5]], device=device))
    even = ones * (torch.arange(K, device=device)[None, :] % 2 == 0)
    cases = []
    for xv in (36.0, -36.0, 0.0):
        for clicks in (torch.zeros((B, K), device=device), ones, even):
            for mask in (full, empty, ragged):
                cases.append((ones * xv, clicks, mask))
    return cases


def _examination_extreme_cases(device):
    """All-36-logit chain factors (SDBN/DBN shape): every sigmoid saturated,
    the odds recurrence pinned at its cap, plus empty masks."""
    B, K = 4, 10
    ones = torch.ones((B, K), device=device)
    full = torch.ones((B, K), dtype=torch.bool, device=device)
    empty = torch.zeros((B, K), dtype=torch.bool, device=device)
    even = ones * (torch.arange(K, device=device)[None, :] % 2 == 0)
    cases = []
    for xv in (36.0, -36.0):
        x = ones * xv
        e = float(np.exp(-abs(xv)))
        gn = e / (1.0 + e) if xv >= 0 else 1.0 / (1.0 + e)
        for sv in (36.0, -36.0):
            es = float(np.exp(-abs(sv)))
            sat = 1.0 / (1.0 + es) if sv >= 0 else es / (1.0 + es)
            no_sat = es / (1.0 + es) if sv >= 0 else 1.0 / (1.0 + es)
            for clicks in (torch.zeros((B, K), device=device), ones, even):
                for mask in (full, empty):
                    cases.append((x, clicks, mask, ones * gn,
                                   torch.zeros((B, K), device=device),
                                   ones * no_sat, ones * sat))
    return cases


# ---------------------------------------------------------------------------
# the specs (all 6 kernels)
# ---------------------------------------------------------------------------

KERNEL_SPECS: Tuple[KernelSpec, ...] = (
    KernelSpec(
        name="embedding_bag",
        op=kernels.embedding_bag, plain=kernels.embedding_bag_plain,
        make_inputs=_bag_inputs,
        # (B, L, N, D): D below / at / straddling the 128-lane width; L=1
        # single-slot bags.
        shapes=((7, 3, 50, 64), (8, 1, 40, 128), (5, 4, 33, 130)),
        diff_argnums=(0, 2),
    ),
    KernelSpec(
        name="session_nll",
        op=kernels.session_nll, plain=kernels.session_nll_plain,
        make_inputs=_session_inputs,
        # (B, K): at / straddling the 256-row block and the 128-lane width.
        shapes=((8, 10), (256, 128), (300, 130)),
        diff_argnums=(0, 1),
        extreme_cases=_session_extreme_cases,
    ),
    KernelSpec(
        name="examination_nll",
        op=kernels.examination_nll, plain=kernels.examination_nll_plain,
        make_inputs=_examination_inputs,
        shapes=((8, 10), (256, 128), (300, 130)),
        diff_argnums=(0, 3, 4, 5, 6),
        extreme_cases=_examination_extreme_cases,
        extreme_bounded_argnums=(0,),  # logits only, see field docstring
    ),
    KernelSpec(
        name="fm_interaction",
        op=kernels.fm_interaction, plain=kernels.fm_interaction_plain,
        make_inputs=_fm_inputs,
        # (B, F, D): B at / straddling the 128-row block.
        shapes=((8, 5, 64), (128, 3, 128), (130, 4, 130)),
        diff_argnums=(0,),
    ),
    KernelSpec(
        name="dcn_cross",
        op=kernels.dcn_cross, plain=kernels.dcn_cross_plain,
        make_inputs=_dcn_inputs,
        shapes=((8, 64), (256, 128), (300, 130)),
        diff_argnums=(0, 1, 2, 3),
    ),
    KernelSpec(
        name="flash_attention",
        op=kernels.flash_attention, plain=kernels.flash_attention_plain,
        make_inputs=_flash_inputs,
        # (B, Hq, Hkv, Sq, Skv, Dh): GQA groups, sequence lengths below / at
        # / straddling the 128 block (130 forces the shrunk-divisor k-block).
        shapes=((2, 4, 2, 16, 16, 32), (1, 2, 2, 128, 128, 64),
                (1, 2, 1, 130, 130, 64)),
        diff_argnums=(0, 1, 2),
        views=_bshd_views,
    ),
)

SPECS_BY_NAME: Dict[str, KernelSpec] = {s.name: s for s in KERNEL_SPECS}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _tol(dtype) -> Tuple[float, float]:
    return TOLS[str(dtype).rsplit(".", 1)[-1]]


def inputs(spec: KernelSpec, shape: tuple, dtype=torch.float32,
           seed: int = 0, device="cpu") -> Tuple[tuple, torch.Tensor]:
    """A cell's args and its gradient projection, drawn from
    ``default_rng(seed)`` in the order JAX's ``check_grads`` draws them (so
    ``check_value``'s args are the same)."""
    rng = np.random.default_rng(seed)
    args = spec.make_inputs(rng, shape, dtype, device)
    out = spec.plain(*args)
    proj = torch.from_numpy(np.asarray(rng.normal(size=tuple(out.shape)),
                                       np.float32)).to(device)
    return args, proj


def projected_grads(spec: KernelSpec, args: tuple, impl: str,
                    proj: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """d/d(diff args) of sum(out * proj): one backward exercises every
    output element's cotangent."""
    leaves = list(args)
    for i in spec.diff_argnums:
        leaves[i] = args[i].detach().requires_grad_(True)
    out = spec.call(tuple(leaves), impl)
    scalar = torch.sum(out.float() * proj)
    return torch.autograd.grad(scalar, [leaves[i] for i in spec.diff_argnums])


def _gap(got: torch.Tensor, want: torch.Tensor, dtype) -> Tuple[float, bool]:
    """(max abs error, held at the dtype's tolerance); NaN equals NaN, as in
    ``np.testing.assert_allclose``."""
    rtol, atol = _tol(dtype)
    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape:
        return float("inf"), False
    held = bool(torch.isclose(got, want, rtol=rtol, atol=atol,
                              equal_nan=True).all())
    diff = (got - want).abs()
    diff = diff[~torch.isnan(diff)]
    return (float(diff.max()) if diff.numel() else 0.0), held


def _args(spec, shape, dtype, seed, device, view):
    args, proj = inputs(spec, shape, dtype, seed, device)
    if view:
        args = spec.views(args)
    return args, proj


def check_value(spec: KernelSpec, impl: str, shape: tuple,
                dtype=torch.float32, seed: int = 0, device="cpu",
                view: bool = False) -> Tuple[float, bool]:
    """Forward parity of ``impl`` against the plain route on the same
    device: (max abs error, held at the dtype's tolerance)."""
    args, _ = _args(spec, shape, dtype, seed, device, view)
    with torch.no_grad():
        return _gap(spec.call(args, impl), spec.call(args, "plain"), dtype)


def check_grads(spec: KernelSpec, impl: str, shape: tuple,
                dtype=torch.float32, seed: int = 0, device="cpu",
                view: bool = False) -> Tuple[float, bool]:
    """Gradient parity of ``impl`` against the plain route's autograd:
    (max abs error over every diff arg's gradient, all held)."""
    args, proj = _args(spec, shape, dtype, seed, device, view)
    got = projected_grads(spec, args, impl, proj)
    want = projected_grads(spec, args, "plain", proj)
    gaps = [_gap(a, b, dtype) for a, b in zip(got, want)]
    return max(g[0] for g in gaps), all(g[1] for g in gaps)


def check_extreme(spec: KernelSpec, impl: str, device="cpu",
                  grad_bound: float = 100.0) -> List[str]:
    """Every non-finite value, non-finite gradient and gradient past
    ``grad_bound`` (bounded args) of ``impl`` on the adversarial corpus."""
    if spec.extreme_cases is None:
        return []
    bounded = (spec.diff_argnums if spec.extreme_bounded_argnums is None
               else spec.extreme_bounded_argnums)
    misses = []
    for case_i, args in enumerate(spec.extreme_cases(device)):
        where = f"{spec.name}[{impl}] extreme case {case_i}"
        with torch.no_grad():
            out = spec.call(args, impl)
        if not bool(torch.isfinite(out).all()):
            misses.append(f"{where}: non-finite value")
        proj = torch.ones(out.shape, device=out.device)
        for i, g in zip(spec.diff_argnums,
                        projected_grads(spec, args, impl, proj)):
            if not bool(torch.isfinite(g).all()):
                misses.append(f"{where}: non-finite grad arg {i}")
            elif i in bounded and float(g.abs().max()) >= grad_bound:
                misses.append(f"{where}: grad arg {i} exceeds {grad_bound}")
    return misses


def saturated_session_misses(impl: str, device="cpu") -> List[str]:
    """``examination_nll`` on attractive items never clicked, with a reset
    that never fires: the odds run into the cap after a few positions. The
    loss must stay finite and the capped tail positions carry no gradient
    (``core.recursions``' saturation semantics, on every route)."""
    spec = SPECS_BY_NAME["examination_nll"]
    B, K = 4, 12
    ones = torch.ones((B, K), device=device)
    mask = torch.ones((B, K), dtype=torch.bool, device=device)
    gn = (ones * float(np.exp(-36.0))).requires_grad_(True)
    loss = spec.call((ones * 36.0, torch.zeros((B, K), device=device), mask,
                      gn, ones * 0.0, ones * 0.5, ones * 0.5), impl)
    (grad,) = torch.autograd.grad(loss, [gn])
    misses = []
    if not bool(torch.isfinite(loss)):
        misses.append(f"saturated sessions [{impl}]: non-finite loss")
    if not bool(torch.isfinite(grad).all()):
        misses.append(f"saturated sessions [{impl}]: non-finite grad")
    elif bool(torch.any(grad[:, -1] != 0.0)):
        misses.append(f"saturated sessions [{impl}]: tail grad "
                      f"{grad[:, -1].tolist()} is not 0")
    return misses


def run_conformance(device="cuda") -> Tuple[Dict[str, dict], List[str]]:
    """The kernel route against the plain route on ``device``: every spec x
    shape x dtype (and, where a spec has ``views``, each cell again in that
    layout), value and gradient; each spec's extreme corpus; the saturated
    sessions. Every cell is measured before it returns ({kernel: {"cells",
    "held", "max_value_err", "max_grad_err", "extreme_cases"}}, the
    misses); the caller raises on a miss once it has reported the rows."""
    report: Dict[str, dict] = {}
    misses: List[str] = []
    for spec in KERNEL_SPECS:
        row = {"cells": 0, "held": 0, "max_value_err": 0.0,
               "max_grad_err": 0.0, "extreme_cases": 0}
        for dtype in DTYPES:
            for shape in spec.shapes:
                for view in (False, True) if spec.views else (False,):
                    for what, check in (("value", check_value),
                                        ("grad", check_grads)):
                        err, held = check(spec, "kernel", shape, dtype,
                                          device=device, view=view)
                        key = f"max_{what}_err"
                        row[key] = max(row[key], err)
                        row["cells"] += 1
                        row["held"] += held
                        if not held:
                            misses.append(
                                f"{spec.name} {what} {shape} "
                                f"{dtype}{' views' if view else ''}: "
                                f"max abs error {err}")
        misses += check_extreme(spec, "kernel", device)
        if spec.extreme_cases is not None:
            row["extreme_cases"] = len(spec.extreme_cases(device))
        if spec.name == "examination_nll":
            misses += saturated_session_misses("kernel", device)
            row["extreme_cases"] += 1
        report[spec.name] = row
    return report, misses
