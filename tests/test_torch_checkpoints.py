"""The port's CheckpointManager (``repro_torch.train.checkpoints``) against
the JAX package's, on the CPU.

Mirrors the JAX checkpoint tests (leaf checksums, newest-valid fallback,
crc bit rot, explicit corrupt step, all invalid, partial-write GC and
pre-checksum compatibility, round trip and keep-k, a partial checkpoint
ignored), and holds the on-disk format to JAX's both ways: a dict tree
written by either manager restores in the other, with equal crc32s. Leaves
are named by path as JAX names them, named-tuple fields included.
"""
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train.checkpoints import _flatten_with_paths as jax_flatten
from repro_torch.testing import truncate_tail
from repro_torch.train import (CheckpointCorruptionError, CheckpointManager,
                               select_replica, stack_replicas)
from repro_torch.tree import (flatten_with_paths, map_with_paths, nest,
                              tree_leaves, tree_map, unnest)


def _quiet(*_):
    pass


@pytest.fixture()
def ckpt_tree():
    return {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)}


def _equal_trees(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k


def test_checkpoint_writes_leaf_checksums(tmp_path, ckpt_tree):
    m = CheckpointManager(str(tmp_path), log_fn=_quiet)
    m.save(1, ckpt_tree)
    meta = json.load(open(tmp_path / "step_0000000001" / "structure.json"))
    assert set(meta["checksums"]) == {"w", "b"}


def test_restore_falls_back_to_newest_valid(tmp_path, ckpt_tree):
    logs = []
    m = CheckpointManager(str(tmp_path), keep=5, log_fn=logs.append)
    for s in (1, 2, 3):
        m.save(s, ckpt_tree, aux={"s": s})
    truncate_tail(str(tmp_path / "step_0000000003" / "arrays.npz"), 64)
    tree, aux, step = m.restore(like=ckpt_tree)
    assert step == 2 and aux["s"] == 2
    assert torch.equal(tree["w"], ckpt_tree["w"])
    assert not (tmp_path / "step_0000000003").exists()
    assert any("corrupt" in m_ for m_ in logs)


def test_restore_detects_bit_rot_via_crc(tmp_path, ckpt_tree):
    m = CheckpointManager(str(tmp_path), keep=5, log_fn=_quiet)
    m.save(1, ckpt_tree, aux={"s": 1})
    m.save(2, ckpt_tree, aux={"s": 2})
    path = tmp_path / "step_0000000002" / "arrays.npz"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    _, aux, step = m.restore(like=ckpt_tree)
    assert step == 1 and aux["s"] == 1


@pytest.mark.parametrize("explicit", [True, False])
def test_a_corrupt_only_checkpoint_raises(tmp_path, ckpt_tree, explicit):
    """An explicitly asked-for corrupt step raises the corruption error;
    with no valid checkpoint left, restore raises FileNotFoundError."""
    m = CheckpointManager(str(tmp_path), log_fn=_quiet)
    m.save(1, ckpt_tree)
    truncate_tail(str(tmp_path / "step_0000000001" / "arrays.npz"), 16)
    with pytest.raises(CheckpointCorruptionError if explicit
                       else FileNotFoundError):
        m.restore(step=1 if explicit else None, like=ckpt_tree)


def test_partial_write_gc_and_pre_checksum_compat(tmp_path, ckpt_tree):
    m = CheckpointManager(str(tmp_path), log_fn=_quiet)
    m.save(4, ckpt_tree, aux={"s": 4})
    (tmp_path / ".tmp_step_9_x").mkdir()
    partial = tmp_path / "step_0000000009"
    partial.mkdir()
    (partial / "arrays.npz").write_bytes(b"torn")
    sp = tmp_path / "step_0000000004" / "structure.json"
    meta = json.loads(sp.read_text())
    del meta["checksums"]
    sp.write_text(json.dumps(meta))
    m2 = CheckpointManager(str(tmp_path), log_fn=_quiet)
    assert not (tmp_path / ".tmp_step_9_x").exists()
    assert not partial.exists()
    assert m2.latest_step() == 4
    _, aux, step = m2.restore(like=ckpt_tree)
    assert step == 4 and aux["s"] == 4


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, log_fn=_quiet)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    for step in (1, 2, 3):
        ckpt.save(step, tree, aux={"epoch": step, "global_step": step,
                                   "loader": {"epoch": 0, "step": step}})
    assert ckpt.latest_step() == 3
    restored, aux, step = ckpt.restore(like=tree)
    assert step == 3 and aux["epoch"] == 3
    _equal_trees(restored, tree)
    assert restored["b"]["c"].dtype == torch.int32
    with pytest.raises(CheckpointCorruptionError):
        ckpt.restore(step=1, like=tree)  # collected by keep=2


class _State(NamedTuple):
    count: torch.Tensor
    mu: list


def test_leaves_are_named_by_path_as_jax_names_them(tmp_path):
    """Dict keys sorted, sequence indices, ``.field`` for a named tuple's
    field, ``None`` empty; bf16 leaves come back bf16, on like's device."""
    tree = {"params": {"z": torch.zeros(2), "a": torch.ones(3)},
            "opt_state": (_State(torch.tensor(3, dtype=torch.int32),
                                 [torch.full((2,), 0.5,
                                             dtype=torch.bfloat16)]),
                          (), None)}
    assert [k for k, _ in flatten_with_paths(tree)] == [
        "opt_state/0/.count", "opt_state/0/.mu/0", "params/a", "params/z"]
    m = CheckpointManager(str(tmp_path), log_fn=_quiet)
    m.save(7, tree)
    restored, _, _ = m.restore(like=tree)
    assert isinstance(restored["opt_state"][0], _State)
    assert restored["opt_state"][0].mu[0].dtype == torch.bfloat16
    _equal_trees(restored, tree)


def test_the_tree_walks_visit_leaves_in_jax_order():
    """``tree_leaves``, ``flatten_with_paths``, ``map_with_paths`` and
    ``tree_map`` walk one order, JAX's (leaves and their dict paths as
    ``jax.tree_util`` gives them); the maps keep the structure (dict key
    order, named tuples, ``None``); ``nest`` and ``unnest`` invert each
    other."""
    rng = np.random.default_rng(1)
    a = [rng.normal(size=(i + 1,)).astype(np.float32) for i in range(5)]

    def tree(leaf):
        return {"b": [leaf(a[0]), (leaf(a[1]), None)],
                "a": {"y": leaf(a[2]), "x": _State(leaf(a[3]),
                                                   [leaf(a[4])])}}

    ttree, jtree = tree(torch.from_numpy), tree(jnp.asarray)
    want = jax.tree_util.tree_leaves(jtree)
    got = tree_leaves(ttree)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    flat = flatten_with_paths(ttree)
    assert all(x is y for (_, x), y in zip(flat, got))
    dict_tree = {"p": {"z": torch.ones(1), "a": [torch.zeros(2)]}}
    assert [k for k, _ in flatten_with_paths(dict_tree)] == list(
        jax_flatten({"p": {"z": jnp.ones(1), "a": [jnp.zeros(2)]}})[0])
    seen = []
    doubled = map_with_paths(lambda k, t: seen.append(k) or t * 2, ttree)
    assert seen == [k for k, _ in flat]
    assert list(doubled) == ["b", "a"] and list(doubled["a"]) == ["y", "x"]
    assert isinstance(doubled["a"]["x"], _State)
    assert doubled["b"][1][1] is None
    summed = tree_map(lambda x, y: x + y, ttree, doubled)
    for s_, t in zip(tree_leaves(summed), got):
        assert torch.equal(s_, 3 * t)
    paths = [("a", "table"), ("b", "c", "kernel"), ("b", "d")]
    leaves = [torch.ones(1), torch.zeros(2), torch.full((3,), 2.0)]
    nested = nest(paths, leaves)
    assert set(nested) == {"a", "b"} and set(nested["b"]) == {"c", "d"}
    assert all(x is y for x, y in zip(unnest(paths, nested), leaves))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_the_on_disk_format_restores_across_packages(tmp_path, writer):
    """A dict tree written by JAX's CheckpointManager restores in the
    port's, and the reverse, leaf for leaf, with equal crc32s."""
    rng = np.random.default_rng(0)
    arrays = {"params": {"attraction": {"table": rng.normal(
                  size=(7, 1)).astype(np.float32)},
                         "examination": {"table": rng.normal(
                             size=(5,)).astype(np.float32)}},
              "count": np.array(4, np.int32)}
    jtree = {"params": {k: {"table": jnp.asarray(v["table"])}
                        for k, v in arrays["params"].items()},
             "count": jnp.asarray(arrays["count"])}
    ttree = {"params": {k: {"table": torch.from_numpy(v["table"])}
                        for k, v in arrays["params"].items()},
             "count": torch.from_numpy(arrays["count"])}
    jm = JaxCheckpointManager(str(tmp_path / writer), log_fn=_quiet)
    tm = CheckpointManager(str(tmp_path / writer), log_fn=_quiet)
    if writer == "jax":
        jm.save(3, jtree, aux={"epoch": 1})
        restored, aux, step = tm.restore(like=ttree)
        _equal_trees(restored, ttree)
    else:
        tm.save(3, ttree, aux={"epoch": 1})
        restored, aux, step = jm.restore(like=jtree)
        for (k, a), (_, b) in zip(flatten_with_paths(
                {k: v for k, v in arrays.items()}),
                flatten_with_paths(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)
    assert (step, aux) == (3, {"epoch": 1})
    meta = json.load(open(tmp_path / writer / "step_0000000003"
                          / "structure.json"))
    # the other package's checksums of the same leaves
    other = str(tmp_path / "other")
    if writer == "jax":
        CheckpointManager(other, log_fn=_quiet).save(3, ttree)
    else:
        JaxCheckpointManager(other, log_fn=_quiet).save(3, jtree)
    theirs = json.load(open(tmp_path / "other" / "step_0000000003"
                            / "structure.json"))
    assert meta["checksums"] == theirs["checksums"]
    assert sorted(meta["keys"]) == sorted(theirs["keys"])


def test_select_replica_and_stack_replicas_are_inverse():
    stacked = {"a": torch.arange(12.0).reshape(3, 4),
               "s": (_State(torch.arange(3, dtype=torch.int32),
                            [torch.ones(3, 2)]),)}
    parts = [select_replica(stacked, i) for i in range(3)]
    assert parts[1]["a"].shape == (4,) and parts[1]["s"][0].count.dim() == 0
    _equal_trees(stack_replicas(parts), stacked)
    with pytest.raises(ValueError):
        stack_replicas([])
