"""int8 quantization of parameter trees, port of the int8 part of
``repro.distrib.compression`` (``quantize_int8`` .. ``tree_nbytes``).

Per-tensor symmetric quantization: ``scale = max(max|x|, 1e-12) / 127``
and ``q = clip(round(x / scale), -127, 127)`` as int8, in JAX's order of
operations. ``torch.round`` rounds half to even, as ``jnp.round`` does, so
``q`` and ``scale`` equal JAX's to the bit. The serving registry keeps the
4x smaller int8 copy as its degraded tier
(:class:`repro_torch.serve.ModelRegistry`).

A tree is nested dicts, lists and tuples whose leaves are tensors or numpy
arrays (``convert.export_params`` gives the JAX-shaped one); a quantized
leaf becomes a :class:`QuantizedTensor`, which the walks here treat as a
leaf. The error-feedback all-reduce waits for the distributed slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns ``(q, scale)``:
    ``q`` int8 of ``x``'s shape, ``scale`` a float32 0-d tensor, both on
    ``x``'s device."""
    xf = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class QuantizedTensor(NamedTuple):
    """An int8 tensor and its per-tensor scale: a 4x smaller resident copy.
    ``q[rows].float() * scale`` is ``dequantize_int8(q, scale)[rows]`` to
    the bit (the product is elementwise), so a table lookup may gather
    before it widens."""

    q: Any      # int8 payload
    scale: Any  # float32 0-d

    @property
    def nbytes(self) -> int:
        return int(self.q.numel()) + 4


def _map(fn, tree):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples; a
    :class:`QuantizedTensor` is a leaf), keeping the structure."""
    if isinstance(tree, QuantizedTensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.array(leaf))


def quantize_tree(tree, min_size: int = 512):
    """int8-quantize every float leaf with ``numel >= min_size``.

    Small leaves (scalars, rank tables, baselines) stay as they are:
    quantizing them saves nothing and costs accuracy; the embedding tables
    are where both the bytes and the tolerance budget live. Invert with
    :func:`dequantize_tree`. The worst per-element error of a quantized
    leaf is ``scale / 2``."""
    def one(leaf):
        t = _as_tensor(leaf)
        if t.is_floating_point() and t.numel() >= min_size:
            return QuantizedTensor(*quantize_int8(t))
        return leaf

    return _map(one, tree)


def dequantize_tree(tree):
    """The float32 tree of :func:`quantize_tree`'s output."""
    return _map(lambda x: dequantize_int8(x.q, x.scale)
                if isinstance(x, QuantizedTensor) else x, tree)


def tree_nbytes(tree) -> int:
    """Resident bytes of a (possibly mixed float32 / int8) tree."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.nbytes
        else:
            t = _as_tensor(leaf)
            total += int(t.numel() * t.element_size())
    return total
