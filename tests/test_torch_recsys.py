"""Parity of the port's DeepFM and AutoInt with repro.models.recsys.

The ``reduced()`` configurations: a JAX ``init`` tree goes through
``load_jax_params`` into the port, then ``forward``, ``loss``, ``serve``,
``retrieval_score`` and every gradient must match JAX on the same numpy
batch, and five ``adamw(1e-3)`` train steps must give the same losses, at
the conformance tolerance (1e-5, float32). DeepFM also in its hashed and
quotient-remainder variants (the counterpart of
``test_recsys_compression_variants``). Also: the dense layers and
initializers, the configs' published widths and FLOP counts, and the
parameter converter on the recsys trees.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.configs import autoint as jautoint_cfg
from repro.configs import deepfm as jdeepfm_cfg
from repro.configs import recsys_common as jrecsys_common
from repro.models import recsys as jrecsys
from repro.nn import MLP as JMLP
from repro.nn import layers as jlayers
from repro_torch import optim as toptim
from repro_torch.configs import autoint as tautoint_cfg
from repro_torch.configs import deepfm as tdeepfm_cfg
from repro_torch.configs import recsys_common as trecsys_common
from repro_torch.convert import export_params, load_jax_params
from repro_torch.models import recsys as trecsys
from repro_torch.nn import ACTIVATIONS, MLP
from repro_torch.nn import init as tinit

TOL = dict(rtol=1e-5, atol=1e-5)
B = 32
# name -> (JAX config, port config); the tabular models' reduced widths.
VARIANTS = {
    "deepfm": ("deepfm", {}),
    "deepfm_hash": ("deepfm", dict(compression="hash", compression_ratio=3.0)),
    "deepfm_qr": ("deepfm", dict(compression="qr", compression_ratio=4.0)),
    "autoint": ("autoint", {}),
}
CFG = {"deepfm": (jdeepfm_cfg, tdeepfm_cfg, jrecsys.DeepFM),
       "autoint": (jautoint_cfg, tautoint_cfg, jrecsys.AutoInt)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(variant, seed=0):
    """(JAX model, its init params, port model carrying those params)."""
    arch, overrides = VARIANTS[variant]
    jmod, tmod, jcls = CFG[arch]
    jcfg = dataclasses.replace(jmod.reduced(), **overrides)
    tcfg = dataclasses.replace(tmod.reduced(), **overrides)
    jm = jcls(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = tmod.make_model(device="cpu", seed=seed, cfg=tcfg)
    load_jax_params(tm, jax.device_get(params))
    return jm, params, tm


def _batch(cfg, seed, rows=B):
    rng = np.random.default_rng(seed)
    return {"field_ids": rng.integers(0, cfg.table_rows,
                                      (rows, cfg.n_sparse)).astype(np.int32),
            "labels": (rng.random(rows) < 0.3).astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _leaf(tree, dotted):
    for key in dotted.split("."):
        tree = tree[key]
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_fns(variant):
    jm, _, _ = _pair(variant)
    return (jax.jit(jm.forward), jax.jit(jax.value_and_grad(jm.loss)),
            jax.jit(jm.serve), jax.jit(jm.retrieval_score))


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_matches_jax(variant, perturbed):
    jm, params, tm = _pair(variant)
    if perturbed:  # weights large enough that every term matters
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda p: p + jnp.asarray(rng.normal(size=p.shape) * 0.3,
                                      jnp.float32), params)
        load_jax_params(tm, jax.device_get(params))
    forward, loss_and_grad, serve, retrieval = _jax_fns(variant)
    jb, tb = _both(_batch(jm.cfg, 2))
    jloss, jgrads = loss_and_grad(params, jb)
    tloss = tm.loss(tb)
    grads = torch.autograd.grad(tloss, list(tm.parameters()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for (path, _), g in zip(tm.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), _leaf(jgrads, path),
                                   err_msg=path, **TOL)
    with torch.no_grad():
        for name, fn in (("forward", forward), ("serve", serve)):
            np.testing.assert_allclose(getattr(tm, name)(tb).numpy(),
                                       np.asarray(fn(params, jb)),
                                       err_msg=name, **TOL)
        # retrieval: one query's candidates expanded into the field matrix
        jc, tc = _both(_batch(jm.cfg, 3, rows=257))
        np.testing.assert_allclose(tm.retrieval_score(tc).numpy(),
                                   np.asarray(retrieval(params, jc)), **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_five_adamw_train_steps_match_jax(variant):
    jm, params, tm = _pair(variant)
    jopt = joptim.adamw(1e-3)
    jstep = jax.jit(jm.make_train_step(jopt))
    jstate = jopt.init(params)
    tstep = tm.make_train_step(toptim.adamw(1e-3))
    tstate = tstep.init()
    for i in range(5):
        jb, tb = _both(_batch(jm.cfg, 10 + i))
        params, jstate, jloss = jstep(params, jstate, jb)
        tstate, tloss = tstep(tstate, tb)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   err_msg=f"step {i}", **TOL)
    for path, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(params, path),
                                   err_msg=path, **TOL)


def test_train_step_updates_parameters_in_place():
    _, _, tm = _pair("deepfm")
    table = tm.embedding["table"]
    before = table.detach().clone()
    step = tm.make_train_step()
    state = step.init()
    _, tb = _both(_batch(tm.cfg, 4))
    state, loss = step(state, tb)
    assert tm.embedding["table"] is table
    assert not torch.equal(table.detach(), before)
    assert loss.dim() == 0 and not loss.requires_grad


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_parameter_tree_round_trips_through_convert(variant):
    _, params, tm = _pair(variant)
    tree = jax.device_get(params)
    exported = export_params(tm)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(list(tm.parameters()))
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        node = exported
        for key in keys:
            node = node[key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    broken = dict(tree)
    broken.pop("embedding")
    with pytest.raises(KeyError):
        load_jax_params(tm, broken)


def test_published_widths_and_flops_match_jax():
    for jmod, tmod, jcls in CFG.values():
        assert dataclasses.asdict(tmod.FULL) == {
            k: v for k, v in dataclasses.asdict(jmod.FULL).items()
            if k != "dtype"}
        for cfg_fn in ("reduced",):
            jcfg, tcfg = getattr(jmod, cfg_fn)(), getattr(tmod, cfg_fn)()
            assert tmod._flops_per_example(tcfg) == jmod._flops_per_example(
                jcfg)
        assert tmod._flops_per_example(tmod.FULL) == jmod._flops_per_example(
            jmod.FULL)
        # Parameter count of the full model, from the JAX tree's shapes
        # (no 80M-row table is allocated here).
        like = jax.eval_shape(lambda: jcls(jmod.FULL).init(
            jax.random.PRNGKey(0)))
        n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            like))
        expected = {"deepfm": 880_000_000 + 39 * 10 * 400 + 400
                    + 2 * (400 * 400 + 400) + 400 + 1 + 1,
                    "autoint": 1_280_000_000 + 4 * (16 * 32) + 2 * 4 * (
                        32 * 32) + 39 * 32 + 1}[tmod.FULL.name]
        assert n_jax == expected
    assert trecsys_common.SHAPES == jrecsys_common.SHAPES


def test_make_model_is_deterministic_in_its_seed():
    cfg = tdeepfm_cfg.reduced()
    a = tdeepfm_cfg.make_model(device="cpu", seed=3, cfg=cfg)
    b = tdeepfm_cfg.make_model(device="cpu", seed=3, cfg=cfg)
    c = tdeepfm_cfg.make_model(device="cpu", seed=4, cfg=cfg)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.embedding["table"], c.embedding["table"])


@pytest.mark.parametrize("cls", [trecsys.DeepFM, trecsys.AutoInt])
def test_entry_points_default_to_the_card(cls):
    import inspect

    assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert inspect.signature(
        tdeepfm_cfg.make_model).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# embedding substrate, dense layers, initializers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression,ratio", [("none", 1.0), ("hash", 3.0),
                                               ("qr", 4.0)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_bag_lookup_matches_jax(compression, ratio, combiner):
    jcfg = jrecsys.TableConfig(700, 6, compression, ratio)
    tcfg = trecsys.TableConfig(700, 6, compression, ratio)
    assert (tcfg.stored_rows, tcfg.qr_rem_rows, tcfg.qr_quot_rows) == (
        jcfg.stored_rows, jcfg.qr_rem_rows, jcfg.qr_quot_rows)
    params = jax.device_get(jrecsys.init_table(jcfg, jax.random.PRNGKey(5)))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, 700, (12, 7)).astype(np.int32)
    weights = rng.uniform(0.2, 1.0, (12, 7)).astype(np.float32)
    from repro.models.recsys.embedding import bag_lookup as jbag
    want = jbag(jcfg, params, jnp.asarray(ids), jnp.asarray(weights),
                combiner=combiner)
    got = trecsys.bag_lookup(tcfg, tparams, torch.from_numpy(ids),
                             torch.from_numpy(weights), combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    look = trecsys.table_lookup(tcfg, tparams,
                                torch.from_numpy(np.abs(ids)))
    np.testing.assert_array_equal(look.numpy(), np.asarray(
        jrecsys.table_lookup(jcfg, params, jnp.asarray(np.abs(ids)))))


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_mlp_matches_jax(activation):
    jm = JMLP(12, [9, 7], 3, activation=activation)
    params = jm.init(jax.random.PRNGKey(7))
    tm = MLP(12, [9, 7], 3, torch.Generator(), activation=activation,
             device="cpu")
    load_jax_params(tm, jax.device_get(params))
    x = np.random.default_rng(8).normal(size=(10, 12)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(params, jnp.asarray(x))), **TOL)
    assert set(jlayers.ACTIVATIONS) == set(ACTIVATIONS)


def test_initializers_follow_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tinit.lecun_normal()((400, 300), gen)
    assert w.shape == (400, 300) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 / 400 ** 0.5
    # std of a unit normal truncated at +-2 is 0.8796
    assert abs(float(w.std()) * 400 ** 0.5 - 0.8796) < 0.01
    t = tinit.truncated_normal(0.5)((100_000,), gen)
    assert float(t.abs().max()) <= 1.0
    n = tinit.normal(0.02)((100_000,), gen)
    assert abs(float(n.std()) - 0.02) < 0.0005
    jw = jlayers.Dense(400, 300).init(jax.random.PRNGKey(0))["kernel"]
    assert abs(float(jnp.std(jw)) - float(w.std())) < 0.01 / 400 ** 0.5
