"""graphsage-reddit [gnn] n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10 [arXiv:1706.02216; paper].

Port of ``repro.configs.graphsage_reddit`` (``build_cell`` waits with the
dry run), plus the molecule train step, which ``chip_smoke.py`` drives.

Shapes:
  full_graph_sm  Cora-scale full-batch (2708 nodes / 10556 edges / 1433 feats)
  minibatch_lg   Reddit sampled-training (232965 nodes, batch 1024, fanout 15-10)
  ogb_products   full-batch-large (2.45M nodes / 61.9M edges / 100 feats)
  molecule       128 batched 30-node graphs (graph classification)
"""
from __future__ import annotations

import torch

from repro_torch import optim as optim_lib
from repro_torch.models.gnn import SAGEConfig
from repro_torch.models.gnn.graphsage import (full_graph_forward,
                                              make_loss_step,
                                              node_classification_loss)

FULL = SAGEConfig(name="graphsage-reddit", n_layers=2, d_in=602, d_hidden=128,
                  n_classes=41, sample_sizes=(25, 10))

SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7, kind="full"),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, n_classes=41,
                         kind="sampled"),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         n_classes=47, kind="full"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=32,
                     n_classes=2, kind="molecule"),
}


def reduced() -> SAGEConfig:
    return SAGEConfig(name="graphsage-smoke", n_layers=2, d_in=16,
                      d_hidden=32, n_classes=5, sample_sizes=(5, 3))


def shape_config(shape: str) -> SAGEConfig:
    """:data:`FULL` at a shape's feature width, classes and fanout, as JAX's
    ``build_cell`` makes it."""
    info = SHAPES[shape]
    return SAGEConfig(name=FULL.name, n_layers=FULL.n_layers,
                      d_in=info["d_feat"], d_hidden=FULL.d_hidden,
                      n_classes=info["n_classes"],
                      sample_sizes=info.get("fanout", FULL.sample_sizes))


def _flops_full(cfg, n_nodes, n_edges, d_feat):
    dims = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    total = 0.0
    for l in range(cfg.n_layers):
        total += 2.0 * 2 * n_nodes * dims[l] * dims[l + 1]  # self + neigh matmuls
        total += 2.0 * n_edges * dims[l]                    # gather-adds
    return 3 * total  # fwd + bwd(2x)


def _make_molecule_step(cfg, optimizer, n_graphs):
    """Graph classification: node logits mean-pooled per ``graph_ids``
    (JAX's ``segment_sum``: ``index_add_``), each graph labelled by the
    label of every ``n // n_graphs``-th node."""
    def loss_fn(params, graph):
        node_logits = full_graph_forward(cfg, params, graph)
        ids = graph["graph_ids"]
        pooled = node_logits.new_zeros(n_graphs, node_logits.shape[1]
                                       ).index_add(0, ids, node_logits)
        counts = torch.zeros(n_graphs, device=ids.device).index_add_(
            0, ids, torch.ones(ids.shape, device=ids.device))
        pooled = pooled / torch.clamp(counts[:, None], min=1.0)
        labels = graph["labels"][::graph["labels"].shape[0] // n_graphs]
        return node_classification_loss(pooled, labels[:n_graphs])

    return make_loss_step(loss_fn, optimizer or optim_lib.adam(1e-2))
