"""Parity of the port's BST and MIND with repro.models.recsys, on the CPU.

The ``reduced()`` configurations: a JAX ``init`` tree goes through
``load_jax_params`` into the port, then ``forward``, ``loss``, every
gradient, ``serve`` and ``retrieval_score`` must match JAX on the same
numpy batch, and three ``adamw(1e-3)`` steps must give the same losses and
parameters, at the conformance tolerance (1e-5, float32). Also: MIND with
fully and partly padded histories; BST's layer norm at a row with a large
mean; the op calls BST makes (the attention's view layout, one bag per
retrieval) and their launch plans at the published width; JAX's
``test_recsys_smoke`` property (30 steps lower the loss); the published
widths, FLOP counts and parameter trees.
"""
import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.configs import bst as jbst_cfg
from repro.configs import mind as jmind_cfg
from repro.models import recsys as jrecsys
from repro_torch import optim as toptim
from repro_torch.configs import bst as tbst_cfg
from repro_torch.configs import mind as tmind_cfg
from repro_torch.convert import export_params, load_jax_params
from repro_torch.kernels import ops as tops
from repro_torch.models import recsys as trecsys

tbag = sys.modules["repro_torch.kernels.embedding_bag"]
tflash = sys.modules["repro_torch.kernels.flash_attention"]

TOL = dict(rtol=1e-5, atol=1e-5)
B = 32
CFG = {"bst": (jbst_cfg, tbst_cfg, jrecsys.BST),
       "mind": (jmind_cfg, tmind_cfg, jrecsys.MIND)}
ARCHS = sorted(CFG)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0, perturbed=False):
    """(JAX model, its params, port model carrying those params)."""
    jmod, tmod, jcls = CFG[arch]
    jm = jcls(jmod.reduced())
    params = jm.init(jax.random.PRNGKey(seed))
    if perturbed:  # weights large enough that every term matters
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda p: p + jnp.asarray(rng.normal(size=p.shape) * 0.3,
                                      jnp.float32), params)
    tm = tmod.make_model(device="cpu", seed=seed, cfg=tmod.reduced())
    load_jax_params(tm, jax.device_get(params))
    return jm, params, tm


def _history_len(cfg):
    return cfg.seq_len if hasattr(cfg, "seq_len") else cfg.history_len


def _batch(cfg, seed, rows=B, pad=False):
    """history_ids (rows, L), target_ids, labels; with ``pad``, row 0 fully
    padded (-1), row 1 padded after its third item and 10% of the rest."""
    rng = np.random.default_rng(seed)
    L = _history_len(cfg)
    hist = rng.integers(0, cfg.item_vocab, (rows, L)).astype(np.int32)
    if pad:
        hist[rng.random((rows, L)) < 0.1] = -1
        hist[0] = -1
        hist[1, 3:] = -1
    return {"history_ids": hist,
            "target_ids": rng.integers(0, cfg.item_vocab, rows
                                       ).astype(np.int32),
            "labels": (rng.random(rows) < 0.3).astype(np.float32)}


def _candidates(cfg, seed, n=257):
    rng = np.random.default_rng(seed)
    return {"history_ids": rng.integers(0, cfg.item_vocab,
                                        (1, _history_len(cfg))
                                        ).astype(np.int32),
            "candidate_ids": rng.integers(0, cfg.item_vocab, n
                                          ).astype(np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _leaf(tree, dotted):
    for key in dotted.split("."):
        tree = tree[key]
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_fns(arch):
    jm, _, _ = _pair(arch)
    return (jax.jit(jm.forward), jax.jit(jax.value_and_grad(jm.loss)),
            jax.jit(jm.serve), jax.jit(jm.retrieval_score))


def _check_loss_and_grads(arch, params, tm, batch):
    _, loss_and_grad, _, _ = _jax_fns(arch)
    jb, tb = _both(batch)
    jloss, jgrads = loss_and_grad(params, jb)
    tloss = tm.loss(tb)
    grads = torch.autograd.grad(tloss, list(tm.parameters()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for (path, _), g in zip(tm.named_parameters(), grads):
        assert bool(torch.isfinite(g).all()), path
        np.testing.assert_allclose(g.numpy(), _leaf(jgrads, path),
                                   err_msg=path, **TOL)


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(arch, perturbed):
    jm, params, tm = _pair(arch, perturbed=perturbed)
    forward, _, serve, retrieval = _jax_fns(arch)
    batch = _batch(jm.cfg, 2)
    _check_loss_and_grads(arch, params, tm, batch)
    jb, tb = _both(batch)
    with torch.no_grad():
        for name, fn in (("forward", forward), ("serve", serve)):
            np.testing.assert_allclose(getattr(tm, name)(tb).numpy(),
                                       np.asarray(fn(params, jb)),
                                       err_msg=name, **TOL)
        jc, tc = _both(_candidates(jm.cfg, 3))
        got = tm.retrieval_score(tc)
        assert got.shape == (1, 257)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(retrieval(params, jc)), **TOL)


@pytest.mark.parametrize("perturbed", [False, True])
def test_mind_padded_histories_match_jax(perturbed):
    """Row 0 fully padded, row 1 partly, 10% elsewhere: loss and every
    gradient finite and equal to JAX's; the fully padded row's interests
    are 0 (the squash's sqrt(norm2 + 1e-9) keeps them finite)."""
    jm, params, tm = _pair("mind", perturbed=perturbed)
    batch = _batch(jm.cfg, 5, pad=True)
    _check_loss_and_grads("mind", params, tm, batch)
    _, tb = _both(batch)
    u = tm.interests(tb).detach()
    assert bool(torch.isfinite(u).all())
    assert bool(torch.all(u[0] == 0)) and bool(torch.any(u[1] != 0))
    jb, _ = _both(batch)
    np.testing.assert_allclose(u.numpy(),
                               np.asarray(jm.interests(params, jb)), **TOL)
    # A padded slot counts for nothing: any id there gives the same output.
    other = dict(batch, history_ids=np.where(batch["history_ids"] < 0, -7,
                                             batch["history_ids"]))
    with torch.no_grad():
        np.testing.assert_array_equal(
            tm.forward(_both(other)[1]).numpy(), tm.forward(tb).numpy())


def test_mind_squash_matches_jax_and_is_finite_at_zero():
    from repro.models.recsys.mind import _squash as jsquash
    from repro_torch.models.recsys.mind import _squash as tsquash

    x = np.random.default_rng(4).normal(size=(3, 4, 8)).astype(np.float32)
    x[0] = 0.0
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tsquash(xt)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jsquash(jnp.asarray(x))), **TOL)
    (g,) = torch.autograd.grad(y.sum(), [xt])
    jg = jax.grad(lambda v: jnp.sum(jsquash(v)))(jnp.asarray(x))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_train_steps_match_jax(arch):
    jm, params, tm = _pair(arch)
    jopt = joptim.adamw(1e-3)
    jstep = jax.jit(jm.make_train_step(jopt))
    jstate = jopt.init(params)
    tstep = tm.make_train_step(toptim.adamw(1e-3))
    tstate = tstep.init()
    for i in range(3):
        jb, tb = _both(_batch(jm.cfg, 10 + i, pad=arch == "mind"))
        params, jstate, jloss = jstep(params, jstate, jb)
        tstate, tloss = tstep(tstate, tb)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   err_msg=f"step {i}", **TOL)
    for path, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(params, path),
                                   err_msg=path, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_thirty_steps_lower_the_loss(arch):
    """JAX's test_archs.py::test_recsys_smoke on the port: finite logits of
    shape (B,), then 30 more steps on one batch lower its loss."""
    _, _, tm = _pair(arch)
    rng = np.random.default_rng(0)
    L = _history_len(tm.cfg)
    batch = {"history_ids": torch.from_numpy(rng.integers(0, 400, (B, L))),
             "target_ids": torch.from_numpy(rng.integers(0, 400, B)),
             "labels": torch.from_numpy(
                 rng.integers(0, 2, B).astype(np.float32))}
    logits = tm.forward(batch)
    assert logits.shape == (B,) and bool(torch.isfinite(logits).all())
    step = tm.make_train_step()
    state = step.init()
    state, first = step(state, batch)
    for _ in range(30):
        state, last = step(state, batch)
    assert float(last) < float(first)
    assert all(bool(torch.isfinite(p).all()) for p in tm.parameters())


def test_bst_layer_norm_matches_jax_at_a_large_mean():
    """BST._ln against JAX's: population variance, eps 1e-6, scale only,
    at a row centred on 20 (torch.var's unbiased default would be 21/20 of
    the variance here and miss by ~2.4%)."""
    x = (np.random.default_rng(6).normal(size=(4, 21, 8)) * 0.5
         + 20.0).astype(np.float32)
    scale = np.random.default_rng(7).normal(size=(8,)).astype(np.float32)
    got = trecsys.BST._ln(torch.from_numpy(x), torch.from_numpy(scale))
    want = jrecsys.BST._ln(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xt = torch.from_numpy(x)
    unbiased = ((xt - xt.mean(-1, keepdim=True))
                * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-6)
                * torch.from_numpy(scale))
    assert not np.allclose(unbiased.numpy(), np.asarray(want), **TOL)


def test_bst_hands_its_kernels_the_layouts_they_take(monkeypatch):
    """encode hands flash_attention q, k and v as transpose(1, 2) views of
    three separate contiguous (B, S, H, Dh) products (no copy, no offset
    view of a fused product), once per block; retrieval_score launches one
    mean bag over the (1, L) history and no attention."""
    calls = []

    def route(device, kernel, plain):
        def record(*args, **kwargs):
            calls.append((kernel.__name__, args))
            return plain(*args, **kwargs)
        return record

    monkeypatch.setattr(tops, "_route", route)
    _, _, tm = _pair("bst")
    _, tb = _both(_batch(tm.cfg, 2))
    tm.loss(tb)
    assert [name for name, _ in calls] == ["flash_attention_cuda"]
    q, k, v = calls[0][1][:3]
    assert [tflash.layout(t) for t in (q, k, v)] == [1, 1, 1]
    assert all(t.storage_offset() == 0 for t in (q, k, v))
    assert len({t.untyped_storage().data_ptr() for t in (q, k, v)}) == 3
    calls.clear()
    _, tc = _both(_candidates(tm.cfg, 3))
    tm.retrieval_score(tc)
    assert [name for name, _ in calls] == ["embedding_bag_cuda"]
    table, ids, weights = calls[0][1]
    assert tuple(ids.shape) == (1, tm.cfg.seq_len)
    np.testing.assert_allclose(weights.numpy(), 1.0 / tm.cfg.seq_len)


def test_mind_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(tops, "_route", lambda *a: pytest.fail("a kernel"))
    _, _, tm = _pair("mind")
    _, tb = _both(_batch(tm.cfg, 2, pad=True))
    torch.autograd.grad(tm.loss(tb), list(tm.parameters()))
    tm.retrieval_score(_both(_candidates(tm.cfg, 3))[1])


@pytest.mark.parametrize("rows", [65536, 512, 262144])
def test_bst_attention_plan_at_the_published_width(rows):
    """FULL's attention (B, 8, 8, 21, 21, 4) in float32 at train_batch,
    serve_p99 and serve_bulk: Dh = 4 and a batch row's q span of 8 x 21 x
    4 x 4 = 2,688 bytes (a multiple of 16) take the rows variant, 88
    threads a batch row."""
    cfg = tbst_cfg.FULL
    S, H = cfg.total_len, cfg.n_heads
    Dh = cfg.embed_dim // H
    assert (S, H, Dh) == (21, 8, 4) and H * S * Dh * 4 == 2688
    plan = tflash.launch_plan(rows, H, H, S, S, Dh, 4)
    assert plan.variant == "rows"
    assert plan.threads % 32 == 0 and plan.threads >= 88 * plan.per_group
    assert plan.rows_per_block == plan.per_group * H * S
    assert plan.grid >= 1 and plan.blocks_per_sm >= 2


def test_bst_retrieval_bag_plan_at_b1():
    """FULL's retrieval bag: one (1, 20) mean bag (weighted) over the
    20,000,000 x 32 table, int32 ids: D = 32 > 16 takes the wide variant,
    the smallest grid, one block."""
    cfg = tbst_cfg.FULL
    plan = tbag.launch_plan(cfg.item_vocab, cfg.embed_dim, 1, cfg.seq_len, 4,
                            weighted=True)
    assert plan == tbag.Plan("wide", tbag.WIDE_THREADS, 1, 0, 0)
    table = torch.zeros(50, cfg.embed_dim)
    ids = torch.zeros(1, cfg.seq_len, dtype=torch.int32)
    assert tbag.plan_for(table, ids, torch.ones(1, cfg.seq_len)) == plan


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_round_trips_through_convert(arch):
    _, params, tm = _pair(arch)
    tree = jax.device_get(params)
    exported = export_params(tm)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(list(tm.parameters()))
    for path, leaf in flat_j:
        node = exported
        for key in [k.key for k in path]:
            node = node[key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    broken = dict(tree)
    broken.pop("embedding")
    with pytest.raises(KeyError):
        load_jax_params(tm, broken)


@pytest.mark.parametrize("arch", ARCHS)
def test_published_widths_flops_and_size_match_jax(arch):
    jmod, tmod, jcls = CFG[arch]
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items()
                        if k != "dtype"}
    assert fields(tmod.FULL) == fields(jmod.FULL)
    assert fields(tmod.reduced()) == fields(jmod.reduced())
    assert tmod._flops_per_example(tmod.FULL) == jmod._flops_per_example(
        jmod.FULL)
    like = jax.eval_shape(lambda: jcls(jmod.FULL).init(jax.random.PRNGKey(0)))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(like))
    expected = {"bst": 20_000_000 * 32 + 21 * 32
                + (672 * 1024 + 1024) + (1024 * 512 + 512)
                + (512 * 256 + 256) + (256 + 1)
                + 4 * 32 * 32 + 2 * 32 * 128 + 2 * 32,
                "mind": 10_000_000 * 64 + 64 * 64 + 50 * 4}[arch]
    assert n_jax == expected


@pytest.mark.parametrize("arch", ARCHS)
def test_make_model_is_deterministic_and_defaults_to_the_card(arch):
    import inspect

    _, tmod, _ = CFG[arch]
    cfg = tmod.reduced()
    a = tmod.make_model(device="cpu", seed=3, cfg=cfg)
    b = tmod.make_model(device="cpu", seed=3, cfg=cfg)
    c = tmod.make_model(device="cpu", seed=4, cfg=cfg)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.embedding["table"], c.embedding["table"])
    assert inspect.signature(tmod.make_model).parameters[
        "device"].default == "cuda"
    cls = {"bst": trecsys.BST, "mind": trecsys.MIND}[arch]
    assert inspect.signature(cls).parameters["device"].default == "cuda"
