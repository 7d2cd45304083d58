"""The cells' weights, made from ``--seed`` on the device.

Every element of every parameter is a pure function of (seed, leaf,
element index): ``center + spread * (2u - 1)`` with ``u`` in [0, 1) from a
counter-based mix of the three. So the benchmark writes a 214,748,672-row
table in a few large calls on the card, and the plain reference works out
any row again, on its own, without a copy of the table the program holds
(the program's tables are the program's state; the reference takes nothing
from them). Integers are kept in int64 below 2^32 and every product is
reduced mod 2^32 by hand, so the CPU and the card give the same bits.

A leaf of a 16-bit type holds those float32 values rounded once to its
type (:func:`rounded`), which the reference asks for in the same way.
"""
from __future__ import annotations

from typing import Dict

import torch

_MASK = 0xFFFFFFFF
#: Elements made per block: the temporaries stay near 100 MB, well under
#: any cell's own peak.
BLOCK = 1 << 21


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform(seed: int, leaf: int, index: torch.Tensor) -> torch.Tensor:
    """float64 in [0, 1) for each int64 element ``index`` of leaf number
    ``leaf``; ``seed`` is any non-negative integer below 2^64."""
    k0 = (seed & _MASK) ^ ((leaf * 0x9E3779B9) & _MASK)
    k1 = ((seed >> 32) & _MASK) ^ 0x632BE5AB
    x = _fmix32((index & _MASK) ^ k0)
    x = _fmix32(x ^ k1 ^ ((index >> 32) & _MASK))
    return x.to(torch.float64) * (1.0 / 4294967296.0)


def values(seed: int, leaf: int, index: torch.Tensor, center: float,
           spread: float) -> torch.Tensor:
    """The float32 values of elements ``index`` (int64, any device) of leaf
    number ``leaf``."""
    u = uniform(seed, leaf, index)
    return (center + spread * (2.0 * u - 1.0)).to(torch.float32)


def rounded(seed: int, leaf: int, index: torch.Tensor, center: float,
            spread: float, dtype: torch.dtype) -> torch.Tensor:
    """The values of elements ``index`` of leaf number ``leaf`` as a leaf
    of ``dtype`` holds them: the float32 values rounded once to ``dtype``
    (for float32, the values themselves)."""
    return values(seed, leaf, index, center, spread).to(dtype)


@torch.no_grad()
def fill_(param: torch.Tensor, seed: int, leaf: int, center: float,
          spread: float) -> None:
    """Write leaf ``leaf``'s values, rounded to ``param``'s dtype, into
    ``param`` (row-major), a block at a time."""
    flat = param.view(-1)
    for lo in range(0, flat.numel(), BLOCK):
        hi = min(lo + BLOCK, flat.numel())
        idx = torch.arange(lo, hi, dtype=torch.int64, device=flat.device)
        flat[lo:hi] = rounded(seed, leaf, idx, center, spread, flat.dtype)


@torch.no_grad()
def sum_of_squares(numel: int, seed: int, leaf: int, center: float,
                   spread: float, device) -> float:
    """Sum over the whole leaf of its float32 values squared, in float64."""
    total = torch.zeros((), dtype=torch.float64, device=device)
    for lo in range(0, numel, BLOCK):
        idx = torch.arange(lo, min(lo + BLOCK, numel), dtype=torch.int64,
                           device=device)
        v = values(seed, leaf, idx, center, spread).double()
        total += torch.dot(v, v)
    return float(total)


@torch.no_grad()
def change_norm(param: torch.Tensor, seed: int, leaf: int, center: float,
                spread: float) -> float:
    """The float64 norm of ``param`` less the values the leaf was made
    with (rounded to ``param``'s dtype), a block at a time."""
    flat = param.detach().view(-1)
    total = torch.zeros((), dtype=torch.float64, device=flat.device)
    for lo in range(0, flat.numel(), BLOCK):
        hi = min(lo + BLOCK, flat.numel())
        idx = torch.arange(lo, hi, dtype=torch.int64, device=flat.device)
        d = flat[lo:hi].double() - rounded(seed, leaf, idx, center, spread,
                                           flat.dtype).double()
        total += torch.dot(d, d)
    return float(total.sqrt())


def leaf_table(config: Dict) -> Dict[str, Dict]:
    """``{path: {"index", "shape", "dtype", "center", "spread"}}`` from a
    configuration's ``leaves``, numbered in their listed order; a leaf
    without a ``dtype`` of its own has the configuration's."""
    return {path: dict(spec, index=i,
                       dtype=spec.get("dtype", config["dtype"]))
            for i, (path, spec) in enumerate(config["leaves"].items())}

