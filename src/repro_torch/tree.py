"""Trees of tensors, the port's counterpart of ``jax.tree_util`` for the
state it carries: nested dicts, lists, tuples and named tuples whose
leaves are tensors (or numpy arrays and Python numbers); ``None`` is an
empty node.

Every function here walks a tree through :func:`_walk`, in JAX's order:
dict keys sorted, sequences and named tuples in order. A leaf's path is
its keys joined by ``/``, a named tuple's field written ``.field``
(``params/attraction/table``, ``opt_state/0/.count``), as JAX names it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def is_named_tuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(fn: Callable, tree, rest: tuple, path: Tuple[str, ...]):
    """``fn(path keys, leaf, *matching leaves of rest)`` over the leaves,
    visited in JAX's order; the result keeps ``tree``'s structure (a dict
    its own key order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _walk(fn, tree[k], tuple(r[k] for r in rest),
                        path + (str(k),)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if is_named_tuple(tree):
        return type(tree)(*(_walk(fn, x, ys, path + ("." + name,))
                            for name, x, *ys in zip(tree._fields, tree,
                                                    *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, x, ys, path + (str(i),))
                          for i, (x, *ys) in enumerate(zip(tree, *rest)))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    return _walk(lambda _, *leaves: fn(*leaves), tree, rest, ())


def map_with_paths(fn: Callable, tree):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping the
    structure."""
    return _walk(lambda path, leaf: fn("/".join(path), leaf), tree, (), ())


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's order."""
    out: List[Tuple[str, Any]] = []
    map_with_paths(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in JAX's order; other leaves are skipped."""
    out: List[torch.Tensor] = []
    _walk(lambda _, leaf: out.append(leaf)
          if isinstance(leaf, torch.Tensor) else None, tree, (), ())
    return out


@torch.no_grad()
def tree_copy_(dst, src) -> None:
    """Copy each tensor of ``src`` into the matching tensor of ``dst`` (two
    trees of one structure), in place, where the two are not one object:
    the tensors of ``dst`` keep their addresses (a CUDA graph reads them
    there)."""
    for a, b in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if a is not b:
            a.copy_(b)


def nest(paths, leaves) -> Dict[str, Any]:
    """The nested-dict tree (``{"attraction": {"table": ...}}``) with
    ``leaves`` at ``paths`` (tuples of keys)."""
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def unnest(paths, tree) -> List[Any]:
    """The leaves of a nested-dict tree at ``paths``, in that order."""
    out = []
    for path in paths:
        node = tree
        for key in path:
            node = node[key]
        out.append(node)
    return out
