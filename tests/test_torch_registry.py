"""The port's arch registry and configs against repro.configs, on the CPU:
``get_arch``, ``arch_shapes`` and ``list_cells`` over JAX's ten archs
(nothing waits: the registry has no ``WAITING`` left); each recsys config's ``FULL`` and ``reduced()`` field
by field and its FLOP count; the batch factories' keys, shapes and dtypes
against JAX's ``ShapeDtypeStruct``s; an unknown arch raises ``KeyError``;
``convert`` round-trips the GNN and LM trees.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import recsys_common as jcommon
from repro_torch.configs import registry as treg
from repro_torch.configs import recsys_common as tcommon

PORTED = ["deepfm", "mind", "bst", "autoint"]  # the recsys archs


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def test_ported_archs_are_jax_recsys_archs_in_order():
    """All ten of JAX's archs, in JAX's order; nothing waits."""
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    assert PORTED == list(jreg.RECSYS_ARCHS)
    assert [a for a in treg.ARCHS if a in PORTED] == PORTED
    assert treg.RECSYS_ARCHS == jreg.RECSYS_ARCHS
    assert treg.LM_ARCHS == jreg.LM_ARCHS
    assert not hasattr(treg, "WAITING")


@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_jax_field_by_field(arch):
    jmod, tmod = jreg.get_arch(arch), treg.get_arch(arch)
    assert tmod.__name__ == f"repro_torch.configs.{arch}"
    assert _fields(tmod.FULL) == _fields(jmod.FULL)
    assert _fields(tmod.reduced()) == _fields(jmod.reduced())
    for cfg in (tmod.FULL, tmod.reduced()):
        jcfg = jmod.FULL if cfg is tmod.FULL else jmod.reduced()
        assert tmod._flops_per_example(cfg) == jmod._flops_per_example(jcfg)
    assert tmod.SHAPES == jmod.SHAPES


@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_arch_shapes_match_jax(arch):
    assert treg.arch_shapes(arch) == jreg.arch_shapes(arch)


@pytest.mark.parametrize("include_extra", [False, True])
def test_list_cells_is_jax_over_the_ported_archs(include_extra):
    want = [(a, s) for a, s in jreg.list_cells(include_extra)]
    assert treg.list_cells(include_extra) == want
    assert len(treg.list_cells()) == 40
    extras = [(a, s) for a, s, _ in jreg.EXTRA_CELLS]
    assert [(a, s) for a, s, _ in treg.EXTRA_CELLS] == extras


@pytest.mark.parametrize("arch", sorted(jreg.LM_ARCHS) + ["graphsage-reddit",
                                                         "no-such-arch"])
def test_waiting_or_unknown_arch_raises_key_error(arch):
    """JAX's KeyError on an unknown arch, never a module that silently does
    less. No arch waits any more: the LM archs and GraphSAGE, which waited
    for their modules until this slice, resolve to the port's config
    module of JAX's name."""
    if arch in jreg.ARCHS:
        mod = treg.get_arch(arch)
        assert mod.__name__ == "repro_torch.configs." + \
            jreg.get_arch(arch).__name__.rsplit(".", 1)[1]
        assert treg.arch_shapes(arch) == jreg.arch_shapes(arch)
        return
    with pytest.raises(KeyError, match=repr(arch)):
        treg.get_arch(arch)
    with pytest.raises(KeyError):
        treg.arch_shapes(arch)
    with pytest.raises(KeyError):
        jreg.get_arch("no-such-arch")


def _check_factory(jfactory, tfactory, vocab):
    gen = torch.Generator().manual_seed(0)
    for shape, info in jcommon.SHAPES.items():
        info = dict(info, batch=min(info["batch"], 4096))  # not 262,144
        if "n_candidates" in info:
            info["n_candidates"] = 4096  # not 1M
        jbatch, _ = jfactory(info, ("data",))
        tbatch = tfactory(info, vocab, gen)
        assert sorted(tbatch) == sorted(jbatch), shape
        for key, sds in jbatch.items():
            t = tbatch[key]
            assert tuple(t.shape) == tuple(sds.shape), (shape, key)
            assert str(t.dtype).split(".")[-1] == str(sds.dtype), (shape, key)
            if key.endswith("ids"):
                assert int(t.min()) >= 0 and int(t.max()) < vocab
            else:
                assert set(np.unique(t.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("n_fields", [8, 39])
def test_tabular_batch_factory_matches_jax(n_fields):
    _check_factory(jcommon.tabular_batch_factory(n_fields),
                   tcommon.tabular_batch_factory(n_fields), 1000)


@pytest.mark.parametrize("history_len,with_target", [(20, True), (50, True),
                                                     (6, False)])
def test_sequence_batch_factory_matches_jax(history_len, with_target):
    _check_factory(jcommon.sequence_batch_factory(history_len, with_target),
                   tcommon.sequence_batch_factory(history_len, with_target),
                   500)


def test_factories_draw_from_their_generator():
    factory = tcommon.sequence_batch_factory(6)
    info = dict(batch=64, kind="train")
    a = factory(info, 100, torch.Generator().manual_seed(3))
    b = factory(info, 100, torch.Generator().manual_seed(3))
    c = factory(info, 100, torch.Generator().manual_seed(4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["history_ids"], c["history_ids"])


@pytest.mark.parametrize("arch", list(jreg.LM_ARCHS) + ["graphsage-reddit"])
def test_convert_round_trips_gnn_and_lm_trees(arch):
    """``export_params`` writes JAX's tree (every path and shape of JAX's
    init at the reduced width: ``("layer_0", "w_self")``, ``("embed",)``,
    a stacked ``("dense", "wq")``, ``("moe", "we_gate")``), and
    ``load_jax_params`` reads it back into a fresh model to the bit,
    bfloat16 parameters included."""
    import jax

    from repro_torch import convert

    jmod, tmod = jreg.get_arch(arch), treg.get_arch(arch)
    if arch == "graphsage-reddit":
        from repro.models.gnn import init_params as jinit
        from repro_torch.models.gnn import init_params as tinit
    else:
        from repro.models.lm import init_params as jinit
        from repro_torch.models.lm import init_params as tinit
    jcfg, tcfg = jmod.reduced(), tmod.reduced()
    want = jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0)))
    a = tinit(tcfg, device="cpu", seed=1)
    tree = convert.export_params(a)
    got_paths = {path: leaf.shape for path, leaf in
                 jax.tree_util.tree_flatten_with_path(tree)[0]}
    want_paths = {path: leaf.shape for path, leaf in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
    assert got_paths == want_paths
    b = tinit(tcfg, device="cpu", seed=2)
    convert.load_jax_params(b, tree)
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), name
