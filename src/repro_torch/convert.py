"""Carry parameters between the JAX package and the port.

A port model names each parameter by its path in the JAX ``init`` tree,
so the tree maps onto ``named_parameters()`` path by path. A click model's
tree is ``{part: {...: array}}`` and the port keeps it under
``model.parts``: ``("attraction", "table")`` is ``parts.attraction.table``,
a feature tower's ``("attraction", "cross_0", "kernel")`` is
``parts.attraction.cross_0.kernel``. The mixture model's tree
(``("prior_logits",)``, ``("store", "m0_attraction", "table")``) and a
recsys model's (``("embedding", "table")``, ``("mlp", "layer_0",
"kernel")``, ``("attn_0", "wq")``, a 0-d ``("bias",)``; BST's
``("pos_embed",)`` and ``("block_0", "ln1")``, MIND's ``("bilinear",)``
and ``("routing_init",)``) map with no prefix, and so do GraphSAGE's
(``("layer_0", "w_self")``) and the LM family's (``("embed",)``,
``("lm_head",)``, a stacked ``(U, ...)`` layer leaf ``("dense", "wq")``,
an expert stack ``("moe", "we_gate")``).
The tree arrives as nested dicts of numpy arrays
(``jax.device_get(params)``), so this module needs no JAX, or of tensors
(the EM fits of ``repro_torch.core.em``, on any device). A leaf is copied
into the parameter's own type: a bfloat16 leaf (the LM family's) into a
bfloat16 parameter exactly. numpy has no bfloat16, so
:func:`export_params` writes a bfloat16 parameter as float32, which loads
back to the same bits.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

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


def param_path(name: str) -> Tuple[str, ...]:
    """A ``named_parameters()`` name as its path in the JAX ``init`` tree
    (``parts.attraction.table`` -> ``("attraction", "table")``)."""
    if name.startswith(_PREFIX):
        name = name[len(_PREFIX):]
    return tuple(name.split("."))


def _named(model) -> Dict[tuple, torch.nn.Parameter]:
    return {param_path(name): p for name, p in model.named_parameters()}


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
        value = leaves[path]
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: tree shape "
                             f"{tuple(value.shape)} != model shape "
                             f"{tuple(p.shape)}")
        p.copy_(value.float())


def export_params(model) -> Dict[str, Any]:
    """The model's parameters as a JAX-shaped tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for path, p in _named(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        t = p.detach().cpu()
        node[path[-1]] = (t.float() if t.dtype == torch.bfloat16
                          else t).numpy().copy()
    return tree
