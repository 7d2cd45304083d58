"""The port's arch registry and recsys configs against repro.configs, on
the CPU: ``get_arch``, ``arch_shapes`` and ``list_cells`` over the ported
archs; each ported config's ``FULL`` and ``reduced()`` field by field and
its FLOP count; the batch factories' keys, shapes and dtypes against JAX's
``ShapeDtypeStruct``s; a waiting arch raises ``KeyError``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import recsys_common as jcommon
from repro_torch.configs import registry as treg
from repro_torch.configs import recsys_common as tcommon

PORTED = ["deepfm", "mind", "bst", "autoint"]


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def test_ported_archs_are_jax_recsys_archs_in_order():
    assert list(treg.ARCHS) == PORTED == list(jreg.RECSYS_ARCHS)
    assert treg.RECSYS_ARCHS == jreg.RECSYS_ARCHS
    assert set(treg.ARCHS) | set(treg.WAITING) == set(jreg.ARCHS)
    assert not set(treg.ARCHS) & set(treg.WAITING)


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


@pytest.mark.parametrize("arch", PORTED)
def test_arch_shapes_match_jax(arch):
    assert treg.arch_shapes(arch) == jreg.arch_shapes(arch)


@pytest.mark.parametrize("include_extra", [False, True])
def test_list_cells_is_jax_over_the_ported_archs(include_extra):
    want = [(a, s) for a, s in jreg.list_cells(include_extra)
            if a in treg.ARCHS or a.startswith("clax-")]
    assert treg.list_cells(include_extra) == want
    assert len(treg.list_cells()) == 16
    extras = [(a, s) for a, s, _ in jreg.EXTRA_CELLS]
    assert treg.EXTRA_CELLS == extras


@pytest.mark.parametrize("arch", sorted(jreg.LM_ARCHS) + ["graphsage-reddit",
                                                         "no-such-arch"])
def test_waiting_or_unknown_arch_raises_key_error(arch):
    """JAX's KeyError, never a module that silently does less; a waiting
    arch's message names the module it waits for."""
    with pytest.raises(KeyError, match=repr(arch)) as err:
        treg.get_arch(arch)
    if arch in treg.WAITING:
        assert treg.WAITING[arch] in str(err.value)
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
