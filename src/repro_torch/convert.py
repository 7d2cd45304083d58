"""Carry parameters between the JAX package and the port.

A JAX click model's ``init`` tree is ``{part: {leaf: array}}``; the port
keeps the same names on ``model.parts[part].<leaf>``, so the tree maps onto
``named_parameters()`` path by path: ``("attraction", "table")`` is
``parts.attraction.table``. The tree arrives as nested dicts of numpy
arrays (``jax.device_get(params)``), so this module needs no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_PREFIX = "parts."


def _flatten(tree, prefix=()) -> Dict[tuple, Any]:
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flatten(sub, prefix + (key,)))
        return out
    return {prefix: tree}


def _named(model) -> Dict[tuple, torch.nn.Parameter]:
    out = {}
    for name, p in model.named_parameters():
        if name.startswith(_PREFIX):
            name = name[len(_PREFIX):]
        out[tuple(name.split("."))] = p
    return out


@torch.no_grad()
def load_jax_params(model, tree) -> None:
    """Copy a JAX parameter tree into ``model`` in place. Raises on a
    missing or extra path, or a shape mismatch."""
    leaves = _flatten(tree)
    params = _named(model)
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing from the tree "
                       f"{missing}, not in the model {extra}")
    for path, p in params.items():
        value = np.asarray(leaves[path])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: tree shape {value.shape} != "
                             f"model shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def export_params(model) -> Dict[str, Any]:
    """The model's parameters as a JAX-shaped tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for path, p in _named(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().cpu().numpy().copy()
    return tree
