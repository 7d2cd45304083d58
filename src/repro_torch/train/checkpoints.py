"""Atomic, durable, keep-k checkpointing for trees of tensors, port of
``repro.train.checkpoints``.

A tree is nested dicts, lists, tuples and named tuples whose leaves are
tensors (on any device), numpy arrays or Python numbers; ``None`` is an
empty node. Leaves are named by their path as JAX names them: dict keys,
sequence indices, and ``.field`` for a named tuple's field, joined by
``/`` (``params/attraction/table``, ``opt_state/0/.count``), so a dict tree
written by either package restores in the other.

Layout per step:  <dir>/step_<n>/
    arrays.npz      — flat {path: array} of every leaf (host numpy)
    structure.json  — the leaf paths, aux metadata (loader state, step,
                      early-stop state, history) and a crc32 per leaf
A ``COMMIT`` marker file is written last; directories without it are treated
as partial writes (e.g. a preemption mid-save) and ignored + garbage-collected.

Durability ordering (what makes a crash at *any* instant recoverable):
``arrays.npz`` and ``structure.json`` are fsynced, then ``COMMIT`` is
written and fsynced, then the tmp directory itself is fsynced (so the
marker's directory entry is durable), then the atomic rename into place,
then the parent directory is fsynced (so the rename is durable). A power
cut between any two steps leaves either no ``step_<n>`` entry or a
COMMIT-less partial — both GC'd on the next manager construction — never a
committed-but-torn checkpoint.

Restore is **corruption-aware**: every checkpoint is validated before use
(COMMIT present, ``structure.json`` parses, ``arrays.npz`` unzips, per-leaf
crc32 matches). ``restore(step=None)`` walks committed steps newest-first
and returns the first *valid* one, quarantining (deleting) invalid entries
as it goes. An explicitly requested step that fails validation raises
:class:`CheckpointCorruptionError`.

bfloat16 tensors are written as float32 (numpy has no bfloat16) and come
back as bfloat16, which loses nothing.

Elastic restore: a checkpoint holds full tensors (a mesh's row shards are
gathered to rank 0, which alone writes), so it is mesh-agnostic.
``restore(like=..., shardings=...)`` cuts each leaf to this rank's block
of its :class:`~repro_torch.distrib.shardings.NamedSharding`, so a
checkpoint written by a world of N restores onto a world of M.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, map_with_paths, tree_map

COMMIT_MARKER = "COMMIT"


class CheckpointCorruptionError(ValueError):
    """A committed checkpoint failed validation (unreadable archive, missing
    leaf, or crc32 mismatch). Raised only for an explicitly requested step;
    latest-checkpoint restore skips invalid entries instead."""


def select_replica(tree, index: int):
    """Slice replica ``index`` out of an R-stacked tree (params, optimizer
    state, or a whole restored checkpoint tree): every leaf loses its
    leading replica axis. The result is shaped exactly like a single run's
    state, so any replica of a sweep checkpoint resumes or tests
    standalone."""
    return tree_map(lambda x: x[index], tree)


def stack_replicas(trees):
    """Inverse of :func:`select_replica`: stack per-replica trees (e.g.
    checkpoints of R independent runs) into one R-stacked tree a
    ``TrainEngine(replicas=R)`` sweep can resume from."""
    if not trees:
        raise ValueError("stack_replicas needs at least one tree")

    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return tree_map(stack, *trees)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, leaf):
    """The stored array as a leaf of the kind of ``leaf``: a tensor of its
    dtype on its device, a numpy array, or a Python number."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr
    return type(leaf)(arr.item())


def _leaf_crc32(arr: np.ndarray) -> str:
    """crc32 of the leaf's bytes (JAX's ``tobytes()``, without the copy)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return f"{zlib.crc32(flat):08x}"


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


_fsync_dir = _fsync_file


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, log_fn=print):
        self.directory = directory
        self.keep = keep
        self.log_fn = log_fn
        os.makedirs(directory, exist_ok=True)
        self._gc_partial()

    # -- public API ---------------------------------------------------------------
    def save(self, step: int, tree: Any, aux: Optional[Dict] = None) -> str:
        """Atomically + durably write a checkpoint for ``step`` (see module
        docstring for the fsync/COMMIT/rename ordering)."""
        final_dir = self._step_dir(step)
        tmp_dir = tempfile.mkdtemp(prefix=f".tmp_step_{step}_",
                                   dir=self.directory)
        try:
            arrays = {key: _to_numpy(leaf)
                      for key, leaf in flatten_with_paths(tree)}
            checksums = {k: _leaf_crc32(v) for k, v in arrays.items()}
            arrays_path = os.path.join(tmp_dir, "arrays.npz")
            np.savez(arrays_path, **arrays)
            _fsync_file(arrays_path)
            structure_path = os.path.join(tmp_dir, "structure.json")
            with open(structure_path, "w") as f:
                json.dump({"step": step, "aux": aux or {},
                           "keys": list(arrays), "checksums": checksums}, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp_dir, COMMIT_MARKER), "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp_dir)
            if os.path.exists(final_dir):
                shutil.rmtree(final_dir)
            os.rename(tmp_dir, final_dir)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        self._gc_old()
        return final_dir

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None,
                shardings: Any = None):
        """Restore (tree, aux, step). ``like`` provides the tree structure,
        and each leaf's kind: a tensor leaf comes back as a new tensor of
        its dtype on its device. Without ``like``, the flat ``{path: numpy
        array}`` dict. ``shardings`` (a tree like ``like`` of
        ``NamedSharding``) cuts each leaf to this rank's block: the elastic
        restore onto another mesh.

        With ``step=None`` the newest committed checkpoint that passes
        validation wins; invalid ones (torn archive, crc mismatch) are
        logged and deleted so they can't shadow an older good save. An
        explicit ``step`` that fails validation raises
        :class:`CheckpointCorruptionError`.
        """
        if step is None:
            meta = arrays = None
            for cand in sorted(self._committed_steps(), reverse=True):
                try:
                    meta, arrays = self._load_validated(cand)
                    break
                except CheckpointCorruptionError as e:
                    self.log_fn(f"[checkpoints] step {cand} is corrupt "
                                f"({e}); deleting and falling back")
                    shutil.rmtree(self._step_dir(cand), ignore_errors=True)
            if meta is None:
                raise FileNotFoundError(
                    f"no valid committed checkpoints in {self.directory}")
        else:
            meta, arrays = self._load_validated(step)
        if like is None:
            return dict(arrays), meta["aux"], meta["step"]
        for key, _ in flatten_with_paths(like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
        if shardings is not None:
            blocks = dict(flatten_with_paths(shardings))
            arrays = {k: blocks[k].local(v) if k in blocks else v
                      for k, v in arrays.items()}
        return (map_with_paths(lambda key, leaf: _like(arrays[key], leaf),
                               like), meta["aux"], meta["step"])

    # -- internals -----------------------------------------------------------------
    def _load_validated(self, step: int):
        """Load + validate one committed checkpoint → (meta, {key: array}).

        Validation: COMMIT marker present, structure.json parses, arrays.npz
        opens and every member decompresses (the zip layer checks its own
        crc), and — for checkpoints that recorded them — per-leaf crc32
        matches. Pre-checksum checkpoints (no "checksums" key) stay
        restorable. Any failure raises CheckpointCorruptionError.
        """
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, COMMIT_MARKER)):
            raise CheckpointCorruptionError(f"step {step}: no COMMIT marker")
        try:
            with open(os.path.join(d, "structure.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(
                f"step {step}: unreadable structure.json ({e})") from e
        try:
            with np.load(os.path.join(d, "arrays.npz")) as npz:
                arrays = {k: npz[k] for k in npz.files}
        except Exception as e:
            raise CheckpointCorruptionError(
                f"step {step}: unreadable arrays.npz ({e})") from e
        checksums = meta.get("checksums")
        if checksums is not None:
            for key, want in checksums.items():
                if key not in arrays:
                    raise CheckpointCorruptionError(
                        f"step {step}: leaf {key!r} missing from arrays.npz")
                got = _leaf_crc32(arrays[key])
                if got != want:
                    raise CheckpointCorruptionError(
                        f"step {step}: crc mismatch on leaf {key!r} "
                        f"(recorded {want}, found {got})")
        return meta, arrays

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _committed_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, COMMIT_MARKER)):
                steps.append(int(name.split("_")[1]))
        return steps

    def _gc_partial(self):
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            is_partial = (name.startswith(".tmp_") or
                          (name.startswith("step_") and
                           not os.path.exists(os.path.join(path,
                                                           COMMIT_MARKER))))
            if is_partial:
                shutil.rmtree(path, ignore_errors=True)

    def _gc_old(self):
        steps = sorted(self._committed_steps())
        for step in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
