"""Gradient compression for the slow all-reduce, and int8 quantization of
parameter trees (port of ``repro.distrib.compression``).

Per-tensor symmetric quantization: ``scale = max(max|x|, 1e-12) / 127``
and ``q = clip(round(x / scale), -127, 127)`` as int8, in JAX's order of
operations. ``torch.round`` rounds half to even, as ``jnp.round`` does, so
``q`` and ``scale`` equal JAX's to the bit. The serving registry keeps the
4x smaller int8 copy as its degraded tier
(:class:`repro_torch.serve.ModelRegistry`).

A tree is nested dicts, lists and tuples whose leaves are tensors or numpy
arrays (``convert.export_params`` gives the JAX-shaped one); a quantized
leaf becomes a :class:`QuantizedTensor`, which the walks here treat as a
leaf.

:class:`CompressedAllReduce` is the error-feedback state (EF-SGD,
Karimireddy et al. 2019): the quantization residual is added back into the
next step's gradient, so the compression's bias vanishes over the steps.
:func:`compressed_psum` all-reduces a gradient tree over a process group
as JAX's ``compressed_psum`` does over a mesh axis: int8 payloads on one
shared scale, summed exactly as int32.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist


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


class _Pair:
    """Two results of one leaf, kept apart from the tree's own tuples."""

    def __init__(self, payload, residual):
        self.payload, self.residual = payload, residual


def _is_payload(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and all(isinstance(t, torch.Tensor) for t in x)
            and x[0].dtype == torch.int8)


def _map_payloads(fn, tree):
    """``fn`` over the ``(int8 q, scale)`` payloads of ``tree``."""
    if _is_payload(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_payloads(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_payloads(fn, v) for v in tree)
    return tree


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


class CompressedAllReduce(NamedTuple):
    """Error-feedback state and its quantize step for compressed gradient
    aggregation."""

    error: Any  # the residual tree, float32

    @staticmethod
    def init(params) -> "CompressedAllReduce":
        return CompressedAllReduce(error=_map(
            lambda p: torch.zeros_like(_as_tensor(p), dtype=torch.float32),
            params))

    def compress_correct(self, grads):
        """Returns (payloads, new_state): per leaf the ``(int8 q, float32
        scale)`` of the gradient plus the carried residual, and the
        residual this quantization leaves."""
        def one(g, e):
            corrected = _as_tensor(g).float() + e
            q, scale = quantize_int8(corrected)
            return _Pair((q, scale), corrected - dequantize_int8(q, scale))

        pairs = _map2(one, grads, self.error)
        payloads = _map(lambda p: p.payload if isinstance(p, _Pair) else p,
                        pairs)
        residual = _map(lambda p: p.residual if isinstance(p, _Pair) else p,
                        pairs)
        return payloads, CompressedAllReduce(residual)

    @staticmethod
    def decompress(payloads):
        return _map_payloads(lambda qs: dequantize_int8(*qs), payloads)


def compressed_psum(grads, group, state: CompressedAllReduce):
    """Compressed all-reduce of ``grads`` over ``group``: quantize (with
    error feedback), agree on the largest scale (an all-reduce max),
    re-quantize to it, sum the int32 payloads (exact), widen with the
    shared scale and average over the group. Returns ``(mean grads,
    new_state)``. ``torch.round`` rounds half to even as ``jnp.round``
    does, so the result is JAX's to the bit on the same gradients."""
    payloads, new_state = state.compress_correct(grads)
    n = float(dist.get_world_size(group))

    def reduce_one(payload):
        q, scale = payload
        shared = scale.clone()
        dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)
        requant = torch.clamp(torch.round(dequantize_int8(q, scale) / shared),
                              -127, 127).to(torch.int32)
        dist.all_reduce(requant, group=group)
        return requant.float() * shared / n

    return _map_payloads(reduce_one, payloads), new_state
