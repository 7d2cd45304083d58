"""The port's flash_attention beyond float32 contiguous inputs, on the CPU.

* bfloat16 q, k and v through ``tk.flash_attention`` against JAX's
  ``flash_attention(impl="pallas")`` (interpret mode off-TPU, as the JAX
  tests run it) at the conformance bfloat16 tolerance (2e-2).
* AutoInt's layout: q, k and v as ``transpose(1, 2)`` views of contiguous
  (B, S, H, Dh) tensors, against JAX at 1e-5; the op returns its output
  in q's layout, bitwise equal to the contiguous call's.
* ``launch_plan``, the CUDA kernel's geometry, over the test shapes,
  ``chip_smoke.py``'s edge shapes and AutoInt's attention at 512, 262,144
  and 1,000,000 rows: shared memory within a block's 227 KB, bulk-copy
  spans in whole 16-byte units, a grid that fits, every query row owned by
  exactly one thread (the kernels' thread-to-row maps, mirrored here), and
  AutoInt on the rows variant.
* The kernel wrapper refuses other dtypes and layouts before it loads
  anything; the rows variant's online softmax (8-key chunks, base 2)
  agrees with the plain form.
* ``AutoInt.forward`` hands the op its projections as (B, F, H, Dh)-backed
  views and gets a view back, so no copy is made around the attention.
"""
import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import kernels as jk
from repro_torch import kernels as tk
from repro_torch.configs import autoint as tautoint_cfg
from repro_torch.kernels import ops as tops
from repro_torch.models.recsys import autoint as tautoint
from test_torch_recsys_kernels import (FLASH_CASES, _online_softmax_emulation,
                                       flash_inputs)

# The module (the package's ``flash_attention`` is the op).
fa = importlib.import_module("repro_torch.kernels.flash_attention")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # testing/conformance.py TOLS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke_flash_shapes():
    """chip_smoke.py's flash_attention edge shapes, (B, Hq, Hkv, Sq, Skv,
    Dh, causal) by name."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = smoke._flash_cases(torch.Generator(), "cpu")
    shapes = {}
    for name, ((q, k, _), causal) in cases.items():
        B, Hq, Sq, Dh = q.shape
        shapes[name] = (B, Hq, k.shape[1], Sq, k.shape[2], Dh, causal)
    return shapes


def _bshd_views(*arrays):
    """Torch (B, H, S, Dh) views of contiguous (B, S, H, Dh) copies."""
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
            .transpose(1, 2) for a in arrays]


# ---------------------------------------------------------------------------
# bfloat16 and AutoInt's layout against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_bf16_matches_jax_pallas(case):
    *shape, causal = case
    q, k, v = flash_inputs(np.random.default_rng(sum(shape) + 21), *shape)
    want = jk.flash_attention(*[jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)],
                              causal=causal, impl="pallas")
    got = tk.flash_attention(*[torch.from_numpy(a).bfloat16()
                               for a in (q, k, v)], causal=causal)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_autoint_layout_matches_jax_and_the_contiguous_call(case):
    *shape, causal = case
    q, k, v = flash_inputs(np.random.default_rng(sum(shape) + 22), *shape)
    want = jk.flash_attention(*[jnp.asarray(a) for a in (q, k, v)],
                              causal=causal, impl="pallas")
    views = _bshd_views(q, k, v)
    assert all(fa.layout(t) == 1 or t.is_contiguous() for t in views)
    got = tk.flash_attention(*views, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.stride() == tk.flash_attention_plain(*views).stride()
    if fa.layout(views[0]) == 1:
        assert got.transpose(1, 2).is_contiguous()
    contiguous = tk.flash_attention(*[torch.from_numpy(a) for a in (q, k, v)],
                                    causal=causal)
    assert torch.equal(got, contiguous)


def test_autoint_layout_grads_match_the_contiguous_call():
    shape = (4, 2, 2, 39, 39, 16)
    rng = np.random.default_rng(23)
    q, k, v = flash_inputs(rng, *shape)
    cot = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    grads = []
    for leaves in (_bshd_views(q, k, v),
                   [torch.from_numpy(a) for a in (q, k, v)]):
        leaves = [t.requires_grad_(True) for t in leaves]
        out = tk.flash_attention(*leaves)
        grads.append(torch.autograd.grad(torch.sum(out * cot), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_rows_variant_online_softmax_matches_plain(case):
    """The rows variant's arithmetic: 8 keys per rescale, q pre-scaled by
    scale * log2(e), exp2."""
    *shape, causal = case
    q, k, v = [torch.from_numpy(a) for a in flash_inputs(
        np.random.default_rng(sum(shape) + 24), *shape)]
    torch.testing.assert_close(
        _online_softmax_emulation(q, k, v, causal, chunk=8, base2=True),
        tk.flash_attention_plain(q, k, v, causal=causal), **TOL)


# ---------------------------------------------------------------------------
# launch_plan
# ---------------------------------------------------------------------------

def _owners_rows(plan, B, Hq, Sq, bshd):
    """How many threads store each (b, h, s), following the rows kernel's
    map: thread t of a group's block takes batch row p = t / (Hq span) of
    the group, head h and positions sq, sq + span (span = ceil(Sq / 2)),
    numbered in the memory order of the first row."""
    R = fa.ROWS_PER_THREAD
    span = -(-Sq // R)
    tpb = Hq * span
    groups = -(-B // plan.per_group)
    counts = np.zeros((B, Hq, Sq), np.int64)
    t = np.arange(plan.threads)
    p, u = t // tpb, t % tpb
    sq, h = (u // Hq, u % Hq) if bshd else (u % span, u // span)
    for block in range(plan.grid):
        for g in range(block, groups, plan.grid):
            b = g * plan.per_group + p
            for i in range(R):
                pos = sq + i * span
                keep = (p < plan.per_group) & (b < B) & (pos < Sq)
                np.add.at(counts, (b[keep], h[keep], pos[keep]), 1)
    return counts


def _owners_tiles(plan, B, Hq, Sq, Dh):
    """Rows of one (b, h) that the tiles kernel's blocks own: block qt's
    thread t takes row qt * rows_per_block + t / lanes_per_row."""
    lanes = fa._lanes_per_row(Dh)
    q_tiles = plan.grid // (B * Hq)
    assert q_tiles * B * Hq == plan.grid
    counts = np.zeros(Sq, np.int64)
    for qt in range(q_tiles):
        rows = qt * plan.rows_per_block + np.arange(plan.threads) // lanes
        rows = np.unique(rows[rows < Sq])
        counts[rows] += 1
    return counts


AUTOINT = [(B, 2, 2, 39, 39, 16, False) for B in (512, 262_144, 1_000_000)]


def _plan_shapes():
    shapes = {f"flash_{i}": c for i, c in enumerate(FLASH_CASES)}
    shapes.update(_smoke_flash_shapes())
    shapes.update({f"autoint_{c[0]}": c for c in AUTOINT})
    shapes["autoint_reduced"] = (512, 2, 2, 8, 8, 4, False)
    return shapes


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("name,case", list(_plan_shapes().items()))
def test_launch_plan_fits_and_owns_every_row_once(name, case, itemsize):
    B, Hq, Hkv, Sq, Skv, Dh, causal = case
    plan = fa.launch_plan(B, Hq, Hkv, Sq, Skv, Dh, itemsize, causal)
    assert 32 <= plan.threads and plan.threads % 32 == 0
    if plan.variant == "tiles":
        assert plan.threads <= fa.TILES_MAX_THREADS and plan.smem_bytes == 0
        assert plan.grid < 2 ** 31
        assert (_owners_tiles(plan, B, Hq, Sq, Dh) == 1).all()
        return
    assert Dh in fa.ROWS_DH and plan.threads <= fa.ROWS_MAX_THREADS
    q_span, kv_span = (Hq * Sq * Dh * itemsize, Hkv * Skv * Dh * itemsize)
    assert q_span % 16 == 0 and kv_span % 16 == 0
    stage = plan.per_group * (q_span + 2 * kv_span)
    widened = plan.per_group * 2 * kv_span * (4 // itemsize) * (itemsize == 2)
    assert plan.smem_bytes == (fa.BARRIER_BYTES + plan.stages * stage
                               + widened)
    assert plan.smem_bytes <= fa.SMEM_PER_BLOCK <= 227 * 1024
    assert plan.blocks_per_sm * (plan.smem_bytes
                                 + fa.SMEM_RESERVED_PER_BLOCK) <= fa.SMEM_PER_SM
    groups = -(-B // plan.per_group)
    assert 1 <= plan.grid <= min(groups, fa.H100_SMS * plan.blocks_per_sm)
    assert plan.threads >= plan.per_group * Hq * -(-Sq // fa.ROWS_PER_THREAD)
    assert plan.rows_per_block == plan.per_group * Hq * Sq
    if B <= 4096:
        for bshd in (False, True):
            assert (_owners_rows(plan, B, Hq, Sq, bshd) == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2])
def test_autoint_takes_the_rows_variant(itemsize):
    for B, Hq, Hkv, Sq, Skv, Dh, causal in AUTOINT:
        plan = fa.launch_plan(B, Hq, Hkv, Sq, Skv, Dh, itemsize, causal)
        assert plan.variant == "rows" and plan.stages == 2
        assert plan.per_group == 3 and plan.threads == 128
    # Unaligned pointers, or spans not in 16-byte units, take the tiles.
    assert fa.launch_plan(*AUTOINT[0][:6], 4, aligned=False).variant == "tiles"
    assert fa.launch_plan(1, 1, 1, 3, 3, 4, 2).variant == "tiles"
    with pytest.raises(ValueError, match="rows variant"):
        fa.launch_plan(1, 1, 1, 3, 3, 4, 2, per_group=1)
    forced = fa.launch_plan(*AUTOINT[0][:6], 4, variant="tiles")
    assert forced == fa._tiles_plan(*AUTOINT[0][:2], *AUTOINT[0][3:4],
                                    AUTOINT[0][5])


# ---------------------------------------------------------------------------
# what the kernel wrapper refuses
# ---------------------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(fa, "_library", refuse)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrapper_refuses_other_dtypes(no_library, dtype):
    q, k, v = [torch.from_numpy(a).to(dtype) for a in flash_inputs(
        np.random.default_rng(25), 1, 2, 2, 4, 4, 8)]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.flash_attention_cuda(q, k, v)


def test_wrapper_refuses_mixed_dtypes(no_library):
    q, k, v = [torch.from_numpy(a) for a in flash_inputs(
        np.random.default_rng(26), 1, 2, 2, 4, 4, 8)]
    with pytest.raises(TypeError, match="of one type"):
        tk.flash_attention_cuda(q, k.bfloat16(), v)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_wrapper_refuses_other_layouts(no_library, which):
    args = [torch.from_numpy(a) for a in flash_inputs(
        np.random.default_rng(27), 2, 2, 2, 6, 6, 8)]
    # A (B, H, Dh, S)-backed view: neither layout the kernel reads.
    args[which] = args[which].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match=r"transpose\(1, 2\) view"):
        tk.flash_attention_cuda(*args)
    # The op copies such an input instead, and agrees with the plain form.
    torch.testing.assert_close(tk.flash_attention(*args),
                               tk.flash_attention_plain(*args), **TOL)


def test_wrapper_takes_both_layouts_up_to_the_device_check(no_library):
    q, k, v = _bshd_views(*flash_inputs(np.random.default_rng(28),
                                        2, 2, 2, 6, 6, 8))
    k = k.contiguous()  # layouts may differ between q, k and v
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# AutoInt hands the op views
# ---------------------------------------------------------------------------

def test_autoint_forward_passes_views_and_copies_nothing(monkeypatch):
    cfg = tautoint_cfg.reduced()
    model = tautoint_cfg.make_model(device="cpu", seed=3, cfg=cfg)
    ids = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.table_rows, (16, cfg.n_sparse)))
    seen = []

    def spy(q, k, v, causal=False, scale=None):
        seen.append((q, k, v))
        for t in (q, k, v):
            assert t.shape == (16, cfg.n_heads, cfg.n_sparse,
                               cfg.d_attn // cfg.n_heads)
            assert not t.is_contiguous()           # no .contiguous() copy
            assert t.transpose(1, 2).is_contiguous()  # (B, F, H, Dh) rows
        out = tops.flash_attention(q, k, v, causal=causal, scale=scale)
        assert out.transpose(1, 2).is_contiguous()  # the caller's reshape
        return out                                  # is a view

    calls = []
    real_apply = tops._FlashAttention.apply

    def apply_spy(q, k, v, causal, scale):
        calls.append(tuple(t.data_ptr() for t in (q, k, v)))
        return real_apply(q, k, v, causal, scale)

    monkeypatch.setattr(tautoint, "flash_attention", spy)
    monkeypatch.setattr(tops._FlashAttention, "apply", apply_spy)
    want = model({"field_ids": ids})
    assert len(seen) == cfg.n_attn_layers == len(calls)
    # The op passed the very same storage on (no copy inside it either).
    for (q, k, v), ptrs in zip(seen, calls):
        assert ptrs == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    monkeypatch.undo()
    torch.testing.assert_close(model({"field_ids": ids}), want, rtol=0,
                               atol=0)
