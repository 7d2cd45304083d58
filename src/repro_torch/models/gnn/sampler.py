"""Host-side uniform neighbor sampler (GraphSAGE minibatch training), copied
from ``repro.models.gnn.sampler``.

Builds a CSR adjacency once, then samples fixed-fanout neighbor tensors per
minibatch (with replacement when degree < fanout, matching the original
GraphSAGE implementation). Produces the ``feats_hop_*`` tensors consumed by
``sampled_forward`` — static shapes, so one jit compilation serves every
batch.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """Power-law-ish random graph for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavored degree skew
    weights = rng.pareto(1.5, n_nodes) + 1.0
    weights /= weights.sum()
    src = rng.choice(n_nodes, n_edges, p=weights)
    dst = rng.integers(0, n_nodes, n_edges)
    features = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    deg = np.bincount(dst, minlength=n_nodes).astype(np.float32)
    return {
        "src": src.astype(np.int32), "dst": dst.astype(np.int32),
        "features": features, "labels": labels,
        "degree_inv": (1.0 / np.maximum(deg, 1.0)).astype(np.float32),
    }


class NeighborSampler:
    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int,
                 seed: int = 0):
        # CSR over incoming edges: for node v, neighbors = sources of v's edges
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample_hop(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """nodes (...,) -> neighbors (..., fanout); isolated nodes self-loop."""
        flat = nodes.reshape(-1)
        lo = self.offsets[flat]
        deg = self.offsets[flat + 1] - lo
        # uniform with replacement
        draw = self.rng.integers(0, 1 << 31, size=(flat.size, fanout))
        idx = lo[:, None] + draw % np.maximum(deg, 1)[:, None]
        out = self.nbr[idx]
        out = np.where(deg[:, None] > 0, out, flat[:, None])  # self-loop fallback
        return out.reshape(*nodes.shape, fanout).astype(np.int32)

    def sample_batch(self, nodes: np.ndarray, fanouts: Sequence[int],
                     features: np.ndarray, labels: np.ndarray
                     ) -> Dict[str, np.ndarray]:
        """Returns feats_hop_0..L (+ labels) for ``sampled_forward``."""
        hops = [nodes]
        for f in fanouts:
            hops.append(self.sample_hop(hops[-1], f))
        batch = {f"feats_hop_{i}": features[h] for i, h in enumerate(hops)}
        batch["labels"] = labels[nodes].astype(np.int32)
        return batch
