"""The port's ``embedding_bag`` kernel contract, on the CPU.

``kernels.embedding_bag.launch_plan`` picks the hand-written kernel's
variant and geometry in plain Python, so its coverage is checked here: the
kernel's index arithmetic, mirrored in numpy, owns every (bag, slot, d)
exactly once, tiles start on 16 bytes and shared memory stays within a
block's budget, over the B, L, D and id widths the contract names. Then
int32 and int64 ids through the port's ``embedding_bag`` against JAX's
(``impl="pallas"`` in interpret mode and ``impl="ref"``), and the port's
the raw op at ids past the table against JAX's pallas forward and
``_bag_bwd`` (past-the-end slots dropped from the table's gradient, a NaN
weight gradient), and the port's ``bag_lookup`` against JAX's with ids
past ``stored_rows`` and padding: values and table gradients, the
backward scattering past-the-end ids into the last row as the forward
reads them (the clip JAX's ``bag_lookup`` applies, folded into the op),
and no pass over an uncompressed table's ids before the op. Tolerance: rtol and atol 1e-5 (float32, sums
of up to 130 products in another order). Inputs and weights come from
numpy with a seed. The kernel itself runs only on a GPU (chip_smoke.py).
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import kernels as jk
from repro.models.recsys import embedding as jemb
from repro_torch import kernels as tk
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (SMEM_PER_BLOCK,
                                               SLOTS_SMEM_TARGET,
                                               launch_plan,
                                               slots_smem_bytes)
from repro_torch.models.recsys import embedding as temb

TOL = dict(rtol=1e-5, atol=1e-5)
ID_TYPES = {"int32": (np.int32, torch.int32), "int64": (np.int64, torch.int64)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# launch_plan
# ---------------------------------------------------------------------------

def _tile_units(nb, slots, dim):
    """(bag, slot, d) of every unit of a tile of nb bags, as the slots
    kernel's gather maps unit u (slot-major)."""
    u = np.arange(nb * slots * dim)
    q = u // dim
    d = u - q * dim
    l = q // nb
    item = (q - l * nb) * slots + l
    return item // slots, item % slots, d


@pytest.mark.parametrize("id_itemsize", [4, 8])
@pytest.mark.parametrize("dim", [1, 3, 16, 64, 130])
@pytest.mark.parametrize("slots", [1, 39, 130])
@pytest.mark.parametrize("bags", [1, 255, 257, 65536])
def test_launch_plan_owns_every_bag_slot_once_within_budget(bags, slots, dim,
                                                           id_itemsize):
    for weighted in (False, True):
        plan = launch_plan(80_000_000, dim, bags, slots, id_itemsize,
                           weighted=weighted)
        if plan.variant == "wide":
            assert dim > 16
            assert plan.grid * plan.threads >= bags * dim
            assert (plan.grid - 1) * plan.threads < bags * dim
            continue
        assert dim <= 16 and plan.threads == 256
        T = plan.tile_bags
        # Tiles start on 16 bytes: ids and weights spans in whole units.
        assert T * slots * id_itemsize % 16 == 0 and T * slots * 4 % 16 == 0
        assert plan.smem_bytes == slots_smem_bytes(T, slots, dim,
                                                   id_itemsize, weighted)
        assert plan.smem_bytes <= SLOTS_SMEM_TARGET <= SMEM_PER_BLOCK
        # The grid's tiles cover the bags once, the last one ragged.
        assert plan.grid == math.ceil(bags / T)
        starts = np.arange(plan.grid) * T
        sizes = np.minimum(T, bags - starts)
        assert sizes.min() >= 1 and sizes.sum() == bags
        # Inside a full tile and the ragged last one, every (bag, slot, d)
        # is one unit.
        for nb in {int(sizes[0]), int(sizes[-1])}:
            b, l, d = _tile_units(nb, slots, dim)
            flat = (b * slots + l) * dim + d
            assert np.array_equal(np.sort(flat), np.arange(nb * slots * dim))
        # At the default T every thread has >= 8 gathers, unless the tile
        # is cut by shared memory or to leave two tiles per SM.
        unit = 4 // math.gcd(slots, 4)
        if T * slots * dim < 8 * plan.threads:
            assert (slots_smem_bytes(T + unit, slots, dim, id_itemsize,
                                     weighted) > SLOTS_SMEM_TARGET
                    or T + unit > max(bags // (2 * 132), unit))


def test_launch_plan_main_shape_and_overrides():
    plan = launch_plan(80_000_000, 1, 65536, 39, 4)
    assert plan.variant == "slots"
    assert plan.tile_bags == 56 and plan.grid == math.ceil(65536 / 56)
    assert plan.tile_bags * 39 >= 8 * plan.threads
    assert launch_plan(80_000_000, 1, 65536, 39, 4,
                       tile_bags=28).tile_bags == 28
    assert launch_plan(80_000_000, 1, 65536, 39, 8,
                       variant="wide").variant == "wide"
    with pytest.raises(ValueError, match="multiple"):
        launch_plan(80_000_000, 1, 65536, 39, 4, tile_bags=30)
    with pytest.raises(ValueError, match="slots"):
        launch_plan(100, 64, 8, 3, 4, tile_bags=4)
    with pytest.raises(ValueError, match="4 or 8"):
        launch_plan(100, 1, 8, 3, 2)


# ---------------------------------------------------------------------------
# int32 and int64 ids against JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_bag(impl):
    return jax.jit(lambda t, i, w: jk.embedding_bag(t, i, w, impl=impl))


def _bag_inputs(seed, B, L, N, D, id_np):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(-1, N, (B, L)).astype(id_np)
    weights = rng.uniform(0.2, 1.0, (B, L)).astype(np.float32)
    return table, ids, weights


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("id_type", sorted(ID_TYPES))
@pytest.mark.parametrize("shape", [(16, 39, 500, 1), (9, 130, 60, 1),
                                   (5, 39, 40, 16), (7, 3, 50, 64)])
def test_int32_and_int64_ids_match_jax(shape, id_type, impl):
    id_np, id_torch = ID_TYPES[id_type]
    table, ids, weights = _bag_inputs(sum(shape), *shape, id_np)
    want = np.asarray(_jax_bag(impl)(jnp.asarray(table),
                                     jnp.asarray(ids.astype(np.int32)),
                                     jnp.asarray(weights)))
    t_ids = torch.from_numpy(ids)
    assert t_ids.dtype == id_torch
    got = tk.embedding_bag(torch.from_numpy(table), t_ids,
                           torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("id_type", sorted(ID_TYPES))
def test_ids_reach_the_kernel_route_in_the_width_given(id_type, monkeypatch):
    id_np, id_torch = ID_TYPES[id_type]
    table, ids, _ = _bag_inputs(3, 4, 5, 20, 2, id_np)
    seen = []

    def plain(t, i, w=None):
        seen.append(i.dtype)
        return tk.embedding_bag_plain(t, i, w)

    monkeypatch.setattr(ops, "embedding_bag_plain", plain)
    ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    assert seen == [id_torch]


def test_plain_version_reads_ids_past_the_table_as_its_last_row():
    table, ids, weights = _bag_inputs(4, 6, 7, 10, 3, np.int64)
    ids[0, :3] = [10, 11, 10 ** 9]
    ids[1, 0] = -5
    got = tk.embedding_bag_plain(*(torch.from_numpy(a)
                                   for a in (table, ids, weights)))
    safe = np.clip(ids, 0, 9)
    w = np.where(ids >= 0, weights, 0.0)
    want = np.einsum("bld,bl->bd", table[safe], w)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("id_type", sorted(ID_TYPES))
def test_ids_past_the_table_follow_jax_bag_bwd(id_type, impl):
    """The raw op at ids >= N: the forward reads row N - 1, as JAX's pallas
    forward; the backward is JAX's ``_bag_bwd``, which drops those slots
    from d_table and gives them a NaN d_w (``jnp.take`` fills), whatever
    the forward impl."""
    id_np, _ = ID_TYPES[id_type]
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, 4, -1], [3, 7, 1]], dtype=id_np)
    weights = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.float32)

    def jax_sum(t, w, impl):
        return jnp.sum(jk.embedding_bag(t, jnp.asarray(ids.astype(np.int32)),
                                        w, impl=impl))

    want = np.asarray(jk.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(weights), impl="pallas"))
    d_want = [np.asarray(d) for d in jax.grad(jax_sum, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(weights), impl)]
    t = torch.from_numpy(table).requires_grad_(True)
    w = torch.from_numpy(weights).requires_grad_(True)
    got = tk.embedding_bag(t, torch.from_numpy(ids), w)
    d_got = [d.numpy() for d in torch.autograd.grad(got.sum(), [t, w])]
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for g, wv in zip(d_got, d_want):
        np.testing.assert_allclose(g, wv, equal_nan=True, **TOL)
    np.testing.assert_array_equal(d_got[0][3], [4.0, 4.0, 4.0])
    assert np.isnan(d_got[1][:, 1]).all() and d_got[1][0, 2] == 0.0
    # bag_lookup's clip, folded into the op: row N - 1 both ways.
    t.grad = None
    clipped = tk.embedding_bag(t, torch.from_numpy(ids), w, clip_ids=True)
    d_clip = torch.autograd.grad(clipped.sum(), [t, w])
    np.testing.assert_array_equal(d_clip[0][3].numpy(), [11.0, 11.0, 11.0])
    assert torch.isfinite(d_clip[1]).all()


# ---------------------------------------------------------------------------
# bag_lookup: ids past stored_rows and padding, values and table gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("id_type", sorted(ID_TYPES))
def test_bag_lookup_with_ids_past_the_table_matches_jax(id_type, combiner,
                                                       weighted):
    id_np, _ = ID_TYPES[id_type]
    rng = np.random.default_rng(11)
    rows, dim, B, L = 40, 2, 12, 39
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = rng.integers(-1, 2 * rows, (B, L)).astype(id_np)  # half past
    ids[3] = -1                                             # all padding
    weights = rng.uniform(0.2, 1.0, (B, L)).astype(np.float32)
    cot = rng.normal(size=(B, dim)).astype(np.float32)
    jcfg = jemb.TableConfig(rows, dim)
    tcfg = temb.TableConfig(rows, dim)
    w_arg = weights if weighted else None

    def jax_loss(t):
        out = jemb.bag_lookup(jcfg, {"table": t},
                              jnp.asarray(ids.astype(np.int32)),
                              None if w_arg is None else jnp.asarray(w_arg),
                              combiner=combiner)
        return jnp.sum(out * cot), out

    (_, want), d_want = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    got = temb.bag_lookup(tcfg, {"table": t}, torch.from_numpy(ids),
                          None if w_arg is None else torch.from_numpy(w_arg),
                          combiner=combiner)
    (d_got,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)),
                                   [t])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), **TOL)
    assert np.all(got.detach().numpy()[3] == 0.0)
    # Past-the-end ids land on the last row, in the forward and backward.
    assert np.any(ids >= rows) and float(d_got[rows - 1].abs().sum()) > 0


def test_bag_lookup_hands_an_uncompressed_tables_ids_over_untouched(
        monkeypatch):
    seen = []

    def record(table, ids, weights=None, combiner="sum", clip_ids=False):
        seen.append(ids)
        assert clip_ids  # the clip is the op's, not a pass over the ids
        return ops.embedding_bag(table, ids, weights, combiner=combiner,
                                 clip_ids=clip_ids)

    monkeypatch.setattr(temb, "embedding_bag", record)
    cfg = temb.TableConfig(100, 1)
    ids = torch.from_numpy(
        np.random.default_rng(12).integers(-1, 300, (8, 39)).astype(
            np.int32))
    temb.bag_lookup(cfg, {"table": torch.zeros(100, 1)}, ids)
    assert len(seen) == 1 and seen[0] is ids
    # A hashed table still hashes (and keeps the padding).
    hcfg = temb.TableConfig(100, 1, compression="hash",
                            compression_ratio=2.0)
    temb.bag_lookup(hcfg, {"table": torch.zeros(hcfg.stored_rows, 1)}, ids)
    hashed = seen[1]
    assert hashed is not ids and torch.equal(hashed < 0, ids < 0)
    assert int(hashed.max()) < hcfg.stored_rows
