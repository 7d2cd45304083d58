"""Architecture registry (port of ``repro.configs.registry``): ``--arch``
resolution over the archs the port has.

``ARCHS`` holds the recsys archs (DeepFM, MIND, BST, AutoInt, in JAX's
order) and ``EXTRA_CELLS`` the paper's own cells. JAX's LM and GNN archs
wait for later slices (``WAITING``); :func:`get_arch` raises JAX's
``KeyError`` on them, as on any unknown id. ``build_cell`` waits with
``launch/dryrun.py``.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs import autoint, bst, deepfm, mind
from repro_torch.configs.recsys_common import SHAPES as RECSYS_SHAPES

ARCHS = {
    "deepfm": deepfm,
    "mind": mind,
    "bst": bst,
    "autoint": autoint,
}

RECSYS_ARCHS = ("deepfm", "mind", "bst", "autoint")

#: JAX's archs that no slice has ported yet, by the module they wait for.
WAITING = {
    "llama3-405b": "models/lm",
    "phi3-mini-3.8b": "models/lm",
    "llama3.2-1b": "models/lm",
    "granite-moe-1b-a400m": "models/lm",
    "llama4-maverick-400b-a17b": "models/lm",
    "graphsage-reddit": "models/gnn",
}

#: Extra (beyond the assigned cells): the paper's own workload, as
#: (arch, shape).
EXTRA_CELLS = [
    ("clax-ubm-baidu", "train_batch"),
    ("clax-ubm-baidu", "serve_bulk"),
    ("clax-dbn-baidu", "train_batch"),
]


def get_arch(arch_id: str):
    """The config module of ``arch_id``; ``KeyError`` unless the port has
    it."""
    if arch_id not in ARCHS:
        waits = (f" ({arch_id} waits for {WAITING[arch_id]})"
                 if arch_id in WAITING else "")
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}"
                       + waits)
    return ARCHS[arch_id]


def arch_shapes(arch_id: str) -> List[str]:
    get_arch(arch_id)
    return list(RECSYS_SHAPES)


def list_cells(include_extra: bool = False) -> List[Tuple[str, str]]:
    """The ported archs' (arch, shape) cells (+ optional paper-own
    extras)."""
    cells = [(a, s) for a in ARCHS for s in arch_shapes(a)]
    if include_extra:
        cells += list(EXTRA_CELLS)
    return cells
