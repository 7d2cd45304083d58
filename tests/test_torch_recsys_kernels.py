"""Parity of the port's recsys kernel ops with repro.kernels on the CPU.

``embedding_bag``, ``fm_interaction`` and ``flash_attention`` of the port
(autograd Functions whose CPU route is the kernel's plain version) against
JAX's, run as the JAX tests run them: ``impl="pallas"`` (interpret mode
off-TPU) and ``impl="ref"``. Shapes: the conformance harness's
(``testing/conformance.py``), DeepFM's first-order bag (L = 39, D = 1),
DeepFM's FM term (F = 39, D = 10) and AutoInt's attention (B x 2 x 39 x
16); plus all-padding bags, the mean combiner, GQA and causal attention
with a decode offset. Gradients against ``jax.grad``: of the custom-VJP
``embedding_bag`` and of the ref forms of the forward-only kernels. All at
the conformance tolerance (1e-5, float32). The hand-written kernels run
only on a GPU (chip_smoke.py); here their launch counters stay at 0 and
their wrappers refuse CPU tensors.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import kernels as jk
from repro_torch import kernels as tk

TOL = dict(rtol=1e-5, atol=1e-5)
# (B, L, N, D): the conformance shapes, then DeepFM's first-order bag.
BAG_SHAPES = [(7, 3, 50, 64), (8, 1, 40, 128), (5, 4, 33, 130),
              (16, 39, 500, 1)]
# (B, F, D): the conformance shapes, then DeepFM's FM term.
FM_SHAPES = [(8, 5, 64), (128, 3, 128), (130, 4, 130), (32, 39, 10)]
# (B, Hq, Hkv, Sq, Skv, Dh, causal): the conformance shapes, AutoInt's
# attention, GQA 4:1 with a decode offset, and single-query decode.
FLASH_CASES = [(2, 4, 2, 16, 16, 32, False), (1, 2, 2, 128, 128, 64, False),
               (1, 2, 1, 130, 130, 64, False), (4, 2, 2, 39, 39, 16, False),
               (2, 4, 1, 16, 40, 32, True), (1, 2, 2, 1, 130, 64, True),
               (2, 4, 2, 16, 16, 32, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bag_inputs(rng, B, L, N, D):
    """The conformance harness's bag inputs (ids include -1 padding)."""
    table = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(-1, N, (B, L)).astype(np.int32)
    weights = rng.uniform(0.2, 1.0, (B, L)).astype(np.float32)
    return table, ids, weights


def flash_inputs(rng, B, Hq, Hkv, Sq, Skv, Dh):
    q = (rng.normal(size=(B, Hq, Sq, Dh)) / np.sqrt(Dh)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, Dh)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_bag(impl, combiner, weighted):
    if weighted:
        return jax.jit(lambda t, i, w: jk.embedding_bag(
            t, i, w, combiner=combiner, impl=impl))
    return jax.jit(lambda t, i: jk.embedding_bag(
        t, i, combiner=combiner, impl=impl))


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("shape", BAG_SHAPES)
def test_embedding_bag_matches_jax(shape, impl):
    table, ids, weights = bag_inputs(np.random.default_rng(sum(shape)),
                                     *shape)
    want = np.asarray(_jax_bag(impl, "sum", True)(*_j(table, ids, weights)))
    got = tk.embedding_bag(*_t(table, ids, weights))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_combiners_and_unweighted_match_jax(combiner,
                                                          weighted):
    table, ids, weights = bag_inputs(np.random.default_rng(3), 9, 6, 40, 5)
    ids[2] = -1  # one bag all padding: mean over nothing stays 0
    args = (table, ids, weights) if weighted else (table, ids)
    want = np.asarray(_jax_bag("ref", combiner, weighted)(*_j(*args)))
    got = tk.embedding_bag(*_t(*args), combiner=combiner)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[2] == 0.0)


def test_all_padding_bags_are_zero_with_zero_grads():
    table, ids, weights = bag_inputs(np.random.default_rng(4), 6, 5, 20, 3)
    ids[:] = -1
    t, i, w = _t(table, ids, weights)
    t.requires_grad_(True)
    w.requires_grad_(True)
    out = tk.embedding_bag(t, i, w)
    assert torch.all(out == 0.0)
    d_t, d_w = torch.autograd.grad(out.sum(), [t, w])
    assert torch.all(d_t == 0.0) and torch.all(d_w == 0.0)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("shape", BAG_SHAPES)
def test_embedding_bag_grads_match_jax_custom_vjp(shape, combiner):
    rng = np.random.default_rng(sum(shape) + 1)
    table, ids, weights = bag_inputs(rng, *shape)
    cot = rng.normal(size=(shape[0], shape[3])).astype(np.float32)

    def jax_loss(t, w):
        out = jk.embedding_bag(t, jnp.asarray(ids), w, combiner=combiner,
                               impl="ref")
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(*_j(table, weights))
    t, i, w = _t(table, ids, weights)
    t.requires_grad_(True)
    w.requires_grad_(True)
    out = tk.embedding_bag(t, i, w, combiner=combiner)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), [t, w])
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **TOL)
    # d_w is zero at padding.
    assert np.all(got[1].numpy()[ids < 0] == 0.0)


def test_embedding_bag_backward_never_builds_a_bag_slot_buffer():
    """_bag_bwd's memory contract: the backward allocates nothing of
    B*L*D floats (it walks one (B, D) slot at a time)."""
    table, ids, weights = bag_inputs(np.random.default_rng(6), 64, 16, 30, 8)
    t, i, w = _t(table, ids, weights)
    t.requires_grad_(True)
    w.requires_grad_(True)
    out = tk.embedding_bag(t, i, w)
    sizes = []

    def record(*args, **kwargs):
        result = real_empty(*args, **kwargs)
        sizes.append(result.numel())
        return result

    real_empty = torch.empty
    torch.empty = record
    try:
        torch.autograd.grad(out.sum(), [t, w])
    finally:
        torch.empty = real_empty
    assert 64 * 16 * 8 not in sizes


# ---------------------------------------------------------------------------
# fm_interaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("shape", FM_SHAPES)
def test_fm_interaction_matches_jax(shape, impl):
    (v,) = [np.random.default_rng(sum(shape)).normal(size=shape)
            .astype(np.float32)]
    want = np.asarray(jk.fm_interaction(jnp.asarray(v), impl=impl))
    got = tk.fm_interaction(torch.from_numpy(v))
    assert got.shape == (shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", FM_SHAPES)
def test_fm_interaction_grads_match_jax(shape):
    rng = np.random.default_rng(sum(shape) + 2)
    v = rng.normal(size=shape).astype(np.float32)
    cot = rng.normal(size=(shape[0],)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(
        jk.fm_interaction(x, impl="ref") * cot))(jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_(True)
    (got,) = torch.autograd.grad(
        torch.sum(tk.fm_interaction(tv) * torch.from_numpy(cot)), [tv])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fm_interaction_single_field_is_zero():
    v = torch.from_numpy(np.random.default_rng(9).normal(
        size=(5, 1, 7)).astype(np.float32))
    assert torch.all(tk.fm_interaction(v) == 0.0)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_jax(case, impl):
    *shape, causal = case
    q, k, v = flash_inputs(np.random.default_rng(sum(shape)), *shape)
    want = np.asarray(jk.flash_attention(*_j(q, k, v), causal=causal,
                                         impl=impl))
    got = tk.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_grads_match_jax(case):
    *shape, causal = case
    rng = np.random.default_rng(sum(shape) + 3)
    q, k, v = flash_inputs(rng, *shape)
    cot = rng.normal(size=q.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(jk.flash_attention(
        *a, causal=causal, impl="ref") * cot), argnums=(0, 1, 2)))(
            *_j(q, k, v))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    out = tk.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_flash_attention_explicit_scale_matches_jax():
    q, k, v = flash_inputs(np.random.default_rng(11), 2, 2, 1, 9, 9, 8)
    want = jk.flash_attention(*_j(q, k, v), scale=0.3, impl="ref")
    got = tk.flash_attention(*_t(q, k, v), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _online_softmax_emulation(q, k, v, causal, chunk=16, base2=False):
    """The CUDA kernel's arithmetic written in torch: K/V walked ``chunk``
    keys at a time (the last chunk as long as the keys left), masked keys
    given p = 0, one rescale of (l, acc) per chunk, the output divided by
    max(l, 1e-30). The tiles variant takes 16 keys and exp of scaled
    scores; the rows variant takes 8 and ``base2``: q pre-scaled by
    scale * log2(e), and exp2."""
    Hq, Sq, Dh = q.shape[1:]
    group = Hq // k.shape[1]
    kq = torch.repeat_interleave(k, group, dim=1)
    vq = torch.repeat_interleave(v, group, dim=1)
    Skv = k.shape[2]
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    horizon = torch.arange(Sq) + (Skv - Sq) if causal else torch.full(
        (Sq,), Skv)
    exp = torch.exp2 if base2 else torch.exp
    q_scaled = q * (Dh ** -0.5 * 1.4426950408889634) if base2 else q
    for j0 in range(0, Skv, chunk):
        pos = torch.arange(j0, min(j0 + chunk, Skv))
        s = torch.einsum("bhqd,bhkd->bhqk", q_scaled, kq[:, :, pos])
        if not base2:
            s = s / Dh ** 0.5
        valid = pos[None, :] <= horizon[:, None]
        s = torch.where(valid, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        seen = m_new != float("-inf")
        corr = torch.where(seen, exp(m - m_new), 1.0)
        p = torch.where(seen[..., None], exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vq[:, :, pos])
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_kernel_online_softmax_arithmetic_matches_plain(case):
    """Keeps the CUDA kernel's masking and rescaling testable on the CPU."""
    *shape, causal = case
    q, k, v = _t(*flash_inputs(np.random.default_rng(sum(shape) + 4),
                               *shape))
    torch.testing.assert_close(
        _online_softmax_emulation(q, k, v, causal),
        tk.flash_attention_plain(q, k, v, causal=causal), **TOL)


def test_causal_call_with_rows_that_see_no_key_is_refused():
    q, k, v = _t(*flash_inputs(np.random.default_rng(12), 1, 2, 2, 8, 4, 16))
    for fn in (tk.flash_attention, tk.flash_attention_plain):
        with pytest.raises(ValueError, match="no key"):
            fn(q, k, v, causal=True)
    tk.flash_attention(q, k, v, causal=False)  # non-causal is fine


def test_flash_attention_refuses_mismatched_heads():
    q, k, v = _t(*flash_inputs(np.random.default_rng(13), 1, 3, 2, 4, 4, 8))
    with pytest.raises(ValueError, match="multiple"):
        tk.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# plain forms, ref forms and the kernel wrappers on the CPU
# ---------------------------------------------------------------------------

def test_plain_versions_match_ref_compositions():
    rng = np.random.default_rng(14)
    for shape in BAG_SHAPES:
        args = _t(*bag_inputs(rng, *shape))
        torch.testing.assert_close(tk.embedding_bag_plain(*args),
                                   tk.embedding_bag_ref(*args), **TOL)
    for shape in FM_SHAPES:
        (v,) = _t(rng.normal(size=shape).astype(np.float32))
        torch.testing.assert_close(tk.fm_interaction_plain(v),
                                   tk.fm_interaction_ref(v), **TOL)
    for *shape, causal in FLASH_CASES:
        args = _t(*flash_inputs(rng, *shape))
        torch.testing.assert_close(
            tk.flash_attention_plain(*args, causal=causal),
            tk.flash_attention_ref(*args, causal=causal), **TOL)


def test_kernels_are_not_launched_on_cpu_and_refuse_cpu_tensors():
    rng = np.random.default_rng(15)
    table, ids, weights = _t(*bag_inputs(rng, 4, 3, 10, 2))
    ids = ids.long()
    (v,) = _t(rng.normal(size=(4, 3, 5)).astype(np.float32))
    q, k, vv = _t(*flash_inputs(rng, 1, 2, 2, 4, 4, 8))
    tk.embedding_bag(table, ids, weights)
    tk.fm_interaction(v)
    tk.flash_attention(q, k, vv)
    assert tk.embedding_bag_cuda.launches == 0
    assert tk.fm_interaction_triton.launches == 0
    assert tk.flash_attention_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        tk.embedding_bag_cuda(table, ids, weights)
    with pytest.raises(ValueError, match="CUDA"):
        tk.fm_interaction_triton(v)
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_attention_cuda(q, k, vv)


def test_recsys_ops_have_no_route_for_other_devices():
    with pytest.raises(ValueError, match="no route"):
        tk.fm_interaction(torch.empty(2, 3, 4, device="meta"))


def test_fm_block_shape_covers_the_row_and_stays_in_budget():
    from repro_torch.kernels.fm_interaction import BLOCK_ELEMENTS, block_shape

    for F, D in [(39, 10), (1, 1), (5, 64), (3, 128), (4, 130), (39, 4096)]:
        bb, bf, bd = block_shape(F, D)
        assert bd >= D and bd & (bd - 1) == 0 and bf & (bf - 1) == 0
        assert bb >= 1 and bb * bf * bd <= max(BLOCK_ELEMENTS, bd)
    assert block_shape(39, 10) == (4, 64, 16)  # DeepFM: a row in one block
