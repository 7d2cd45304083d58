"""Architecture registry (port of ``repro.configs.registry``): ``--arch``
resolution.

``ARCHS`` holds JAX's ten archs in JAX's order (the five LM archs,
GraphSAGE and the four recsys archs) and ``EXTRA_CELLS`` the paper's own
cells with their builders; :func:`get_arch` raises JAX's ``KeyError`` on
an unknown id, and :func:`build_cell` builds any cell for the dry run.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

from repro_torch.configs import (autoint, bst, clax_baidu, deepfm,
                                 graphsage_reddit,
                                 granite_moe_1b, llama3_2_1b, llama3_405b,
                                 llama4_maverick, mind, phi3_mini_3_8b)
from repro_torch.configs.lm_common import SHAPES as LM_SHAPES
from repro_torch.configs.recsys_common import SHAPES as RECSYS_SHAPES

ARCHS = {
    "llama3-405b": llama3_405b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "llama3.2-1b": llama3_2_1b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "graphsage-reddit": graphsage_reddit,
    "deepfm": deepfm,
    "mind": mind,
    "bst": bst,
    "autoint": autoint,
}

LM_ARCHS = ("llama3-405b", "phi3-mini-3.8b", "llama3.2-1b",
            "granite-moe-1b-a400m", "llama4-maverick-400b-a17b")
RECSYS_ARCHS = ("deepfm", "mind", "bst", "autoint")

#: Extra (beyond the assigned cells): the paper's own workload, as
#: (arch, shape, builder of ``mesh``).
EXTRA_CELLS = [
    ("clax-ubm-baidu", "train_batch",
     functools.partial(clax_baidu.build_cell, "train_batch", kind="ubm")),
    ("clax-ubm-baidu", "serve_bulk",
     functools.partial(clax_baidu.build_cell, "serve_bulk", kind="ubm")),
    ("clax-dbn-baidu", "train_batch",
     functools.partial(clax_baidu.build_cell, "train_batch", kind="dbn")),
]


def get_arch(arch_id: str):
    """The config module of ``arch_id``; ``KeyError`` unless the port has
    it."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def arch_shapes(arch_id: str) -> List[str]:
    get_arch(arch_id)
    if arch_id in LM_ARCHS:
        return list(LM_SHAPES)
    if arch_id == "graphsage-reddit":
        return list(graphsage_reddit.SHAPES)
    return list(RECSYS_SHAPES)


def list_cells(include_extra: bool = False) -> List[Tuple[str, str]]:
    """The assigned (arch, shape) cells (+ optional paper-own extras)."""
    cells = [(a, s) for a in ARCHS for s in arch_shapes(a)]
    if include_extra:
        cells += [(a, s) for a, s, _ in EXTRA_CELLS]
    return cells


def build_cell(arch_id: str, shape: str, mesh):
    """The dry-run cell of ``(arch_id, shape)`` on ``mesh``."""
    for a, s, fn in EXTRA_CELLS:
        if (a, s) == (arch_id, shape):
            return fn(mesh)
    return get_arch(arch_id).build_cell(shape, mesh)
