"""The port's ``session_nll`` kernel contract, on the CPU.

``kernels.session_nll.launch_plan`` and ``vector_loads`` give the
hand-written CUDA kernel its geometry and load width in plain Python, so
they are checked here with the kernel's index arithmetic mirrored in
numpy: every element of a batch is owned by exactly one (block, thread,
vector, lane), whole-vector loads start on 16 bytes of the logits and
clicks and 4 of the mask, and every other element is read alone, over
element counts from 0 to a few million and storage offsets that break the
alignment. Then the plain version (what the CPU runs and the kernel is
held against on the card) against JAX's ``session_nll`` with
``impl="pallas"`` (interpret mode) and ``impl="ref"`` at rtol and atol
1e-5 on ragged shapes, |x| = 36 and a fully masked batch. Last, the
choice of last-block counters (``kernels.last_block``) as far as it runs
without a card: which counter a stream gets, that a captured call's slot
is never handed out twice, and how the pool grows; and that the build's
library name follows every header under ``csrc/``. The kernel itself runs
only on a GPU (chip_smoke.py).
"""
import functools
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from repro import kernels as jk
from repro_torch import kernels as tk
from repro_torch.kernels import build, last_block
from repro_torch.kernels.session_nll import (MAX_THREADS, VECTOR_CHOICES,
                                             launch_plan, vector_loads)

TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# launch_plan and vector_loads
# ---------------------------------------------------------------------------

def _owned(plan, n, vector):
    """(element index, loaded as part of a whole vector) of every lane the
    kernel runs, as session_nll_kernel computes them."""
    b = np.arange(plan.grid)[:, None, None, None]
    j = np.arange(plan.vectors)[None, :, None, None]
    t = np.arange(plan.threads)[None, None, :, None]
    q = np.arange(4)[None, None, None, :]
    first = b * 4 * plan.vectors * plan.threads + (j * plan.threads + t) * 4
    shape = (plan.grid, plan.vectors, plan.threads, 4)
    elem = np.broadcast_to(first + q, shape).ravel()
    whole = np.broadcast_to(vector & (first + 4 <= n), shape).ravel()
    return elem, whole


def _check_plan(n, threads, vectors, offsets):
    plan = launch_plan(n, threads, vectors)
    per_block = 4 * plan.vectors * plan.threads
    assert plan.grid == max(1, -(-n // per_block))
    # float32 logits and clicks at their own element offsets, the mask's
    # bytes at its own: the kernel's vector path needs all three aligned.
    x_off, c_off, m_off = offsets
    vector = vector_loads(4 * x_off, 4 * c_off, m_off)
    assert vector == (x_off % 4 == 0 and c_off % 4 == 0 and m_off % 4 == 0)
    elem, whole = _owned(plan, n, vector)
    live = elem < n
    counts = np.bincount(elem[live], minlength=n)
    assert counts.shape == (n,) and np.all(counts == 1)
    # Whole vectors only where all four lanes are live and the addresses
    # are aligned: 16 bytes for x and c, 4 for the mask word.
    starts = elem[whole][::4]
    assert np.all(elem[whole] < n)
    assert np.all((4 * (x_off + starts)) % 16 == 0)
    assert np.all((4 * (c_off + starts)) % 16 == 0)
    assert np.all((m_off + starts) % 4 == 0)
    if vector:
        # Only the vector that the ragged end cuts is read alone.
        assert live.sum() - whole.sum() < 4


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 3_000_000), threads=st.integers(0, 4),
       vectors=st.integers(0, len(VECTOR_CHOICES) - 1),
       x_off=st.integers(0, 7), c_off=st.integers(0, 7),
       m_off=st.integers(0, 7))
def test_launch_plan_owns_every_element_once(n, threads, vectors, x_off,
                                             c_off, m_off):
    _check_plan(n, [32, 128, 256, 512, 1024][threads],
                VECTOR_CHOICES[vectors], (x_off, c_off, m_off))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 2047, 2048, 2049,
                               65536 * 10, 65536 * 10 + 3])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 0, 0), (0, 2, 0),
                                     (0, 0, 3), (4, 8, 4)])
def test_launch_plan_edges_and_unaligned_offsets(n, offsets):
    _check_plan(n, None, None, offsets)


def test_launch_plan_main_shape_and_refusals():
    plan = launch_plan(65536 * 10)
    assert (plan.threads, plan.vectors, plan.grid) == (512, 1, 320)
    assert launch_plan(0).grid == 1
    for threads in (0, 16, 48, MAX_THREADS + 32):
        with pytest.raises(ValueError, match="threads"):
            launch_plan(100, threads=threads)
    for vectors in (0, 3, 8):
        with pytest.raises(ValueError, match="vectors"):
            launch_plan(100, vectors=vectors)


# ---------------------------------------------------------------------------
# the plain version against JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_session_nll(impl):
    return jax.jit(lambda x, c, m: jk.session_nll(x, c, m, impl=impl))


def _inputs(seed, b, k, logit=None, masked=True):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, k)) * 4.0).astype(np.float32)
    if logit is not None:
        x = np.full((b, k), logit, np.float32)
    c = rng.integers(0, 2, (b, k)).astype(np.float32)
    m = rng.random((b, k)) < 0.8 if masked else np.zeros((b, k), bool)
    return x, c, m


CASES = {f"random_{b}x{k}": (b, k, None, True)
         for b, k in [(1, 1), (1, 7), (3, 10), (257, 33), (300, 130),
                      (65, 1)]}
CASES.update({"logit_+36": (257, 33, 36.0, True),
              "logit_-36": (257, 33, -36.0, True),
              "fully_masked": (257, 33, None, False)})


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax(case, impl):
    x, c, m = _inputs(len(case), *CASES[case])
    want = float(_jax_session_nll(impl)(jnp.asarray(x), jnp.asarray(c),
                                        jnp.asarray(m)))
    got = tk.session_nll_plain(*(torch.from_numpy(a) for a in (x, c, m)))
    assert got.dtype == torch.float32 and got.shape == ()
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, **TOL)
    if case == "fully_masked":
        assert float(got) == 0.0


# ---------------------------------------------------------------------------
# last-block counters
# ---------------------------------------------------------------------------

def _pool():
    made = []

    def zeros(n):
        made.append(n)
        return torch.zeros(n, dtype=torch.int32)

    return last_block.Counters(zeros), made


def test_a_stream_keeps_its_counter_and_streams_differ():
    counters, made = _pool()
    a = counters.for_stream(11)
    assert made == [last_block.POOL_SLOTS]
    assert counters.for_stream(11) is a
    b = counters.for_stream(12)
    assert b.data_ptr() != a.data_ptr()
    assert a.shape == b.shape == (1,) and a.dtype == torch.int32
    assert int(a) == int(b) == 0


def test_captured_calls_never_share_a_slot():
    counters, made = _pool()
    assert counters.for_capture() is None  # no pool before an eager call
    stream = counters.for_stream(1)
    slots = [counters.for_capture() for _ in range(last_block.POOL_SLOTS)]
    taken = [s for s in slots if s is not None]
    # The pool is handed out whole, then capture finds no free slot: it
    # is never grown during capture.
    assert len(taken) == last_block.POOL_SLOTS - 1 and slots[-1] is None
    ptrs = {s.data_ptr() for s in taken} | {stream.data_ptr()}
    assert len(ptrs) == last_block.POOL_SLOTS
    assert made == [last_block.POOL_SLOTS]


def test_an_eager_call_grows_a_half_used_pool():
    counters, made = _pool()
    first = counters.for_stream(1)
    held = [counters.for_capture()
            for _ in range(last_block.POOL_SLOTS // 2)]
    assert made == [last_block.POOL_SLOTS]
    assert counters.for_stream(1) is first  # a known stream keeps its own
    assert made == [last_block.POOL_SLOTS, 2 * last_block.POOL_SLOTS]
    later = [counters.for_capture() for _ in range(8)]
    ptrs = [s.data_ptr() for s in held + later] + [first.data_ptr()]
    assert len(set(ptrs)) == len(ptrs)
    assert all(int(s) == 0 for s in held + later)


# ---------------------------------------------------------------------------
# the build follows the headers
# ---------------------------------------------------------------------------

def test_library_name_follows_every_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    names = build.sources()
    assert "session_nll" in names and "examination_nll" in names
    assert all((csrc / (n + ".cu")).exists() for n in names)
    assert "last_block" not in names  # headers are not sources
    before = {n: build.library_path(n) for n in names}
    header = csrc / "last_block.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    source = csrc / "dcn_cross.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    again = {n: build.library_path(n) for n in names}
    assert again["dcn_cross"] != after["dcn_cross"]
    assert all(again[n] == after[n] for n in names if n != "dcn_cross")
