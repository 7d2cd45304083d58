"""graphsage-reddit [gnn] n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10 [arXiv:1706.02216; paper].

Port of ``repro.configs.graphsage_reddit``, whose molecule train step
``chip_smoke.py`` also drives.

Shapes:
  full_graph_sm  Cora-scale full-batch (2708 nodes / 10556 edges / 1433 feats)
  minibatch_lg   Reddit sampled-training (232965 nodes, batch 1024, fanout 15-10)
  ogb_products   full-batch-large (2.45M nodes / 61.9M edges / 100 feats)
  molecule       128 batched 30-node graphs (graph classification)
"""
from __future__ import annotations

import torch

from repro_torch import optim as optim_lib
from repro_torch.configs.common import (Cell, dp_axes, fake_module,
                                        local_batch)
from repro_torch.distrib.shardings import P
from repro_torch.models.gnn import SAGEConfig
from repro_torch.models.gnn.graphsage import (full_graph_forward,
                                              init_params,
                                              make_full_graph_train_step,
                                              make_loss_step,
                                              make_sampled_train_step,
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


def _make_molecule_step(cfg, optimizer, n_graphs, mesh=None):
    """Graph classification: node logits mean-pooled per ``graph_ids``
    (JAX's ``segment_sum``: ``index_add_``), each graph labelled by the
    label of every ``n // n_graphs``-th node; with ``mesh`` the
    aggregations split over its ranks, as :func:`full_graph_forward`'s."""
    def loss_fn(params, graph):
        node_logits = full_graph_forward(cfg, params, graph, mesh)
        ids = graph["graph_ids"]
        pooled = node_logits.new_zeros(n_graphs, node_logits.shape[1]
                                       ).index_add(0, ids, node_logits)
        counts = torch.zeros(n_graphs, device=ids.device).index_add_(
            0, ids, torch.ones(ids.shape, device=ids.device))
        pooled = pooled / torch.clamp(counts[:, None], min=1.0)
        labels = graph["labels"][::graph["labels"].shape[0] // n_graphs]
        return node_classification_loss(pooled, labels[:n_graphs])

    return make_loss_step(loss_fn, optimizer or optim_lib.adam(1e-2))


def _pad_edges(n_edges: int, mesh) -> int:
    from repro_torch.distrib.shardings import axis_size

    n_dev = 1
    for a in mesh.mesh_dim_names:
        n_dev *= axis_size(mesh, a)
    return -(-n_edges // n_dev) * n_dev


def _params_opt(cfg, optimizer, device):
    params = fake_module(init_params(cfg, device="meta"), device)
    return params, optimizer.init(list(params.parameters()))


def build_cell(shape: str, mesh) -> Cell:
    """The dry-run cell at ``shape`` on ``mesh``. Full-batch and molecule:
    every rank holds the whole graph (nodes replicated, JAX's placement)
    and takes its slice of the edges, padded to a multiple of the ranks as
    JAX pads them, then one all-reduce sums the aggregations
    (:func:`full_graph_forward` on a mesh); JAX holds only the slice.
    Sampled: the batch over the data axes."""
    info = SHAPES[shape]
    all_axes = tuple(mesh.mesh_dim_names)
    device = mesh.device_type
    optimizer = optim_lib.adam(1e-2)

    if info["kind"] in ("full", "molecule"):
        if info["kind"] == "molecule":
            n_nodes = info["n_nodes"] * info["batch"]
            n_edges_raw = info["n_edges"] * info["batch"]
        else:
            n_nodes, n_edges_raw = info["n_nodes"], info["n_edges"]
        cfg = shape_config(shape)
        n_edges = _pad_edges(n_edges_raw, mesh)
        shapes = {
            "features": ((n_nodes, info["d_feat"]), torch.float32),
            "src": ((n_edges,), torch.int32),
            "dst": ((n_edges,), torch.int32),
            "edge_weight": ((n_edges,), torch.float32),
            "degree_inv": ((n_nodes,), torch.float32),
            "labels": ((n_nodes,), torch.int32),
        }
        if info["kind"] == "molecule":
            shapes["graph_ids"] = ((n_nodes,), torch.int32)
            fn = _make_molecule_step(cfg, optimizer, info["batch"], mesh)
        else:
            fn = make_full_graph_train_step(cfg, optimizer, mesh)
        gspecs = {k: P(None) for k in shapes}
        graph = local_batch(mesh, shapes, gspecs, device)
        params, opt_state = _params_opt(cfg, optimizer, device)
        return Cell(
            arch=FULL.name, shape=shape, kind="train", fn=fn,
            args=(params, opt_state, graph),
            in_specs=(P(), P(), gspecs), out_specs=(P(), P(), P()),
            model_flops=_flops_full(cfg, n_nodes, n_edges_raw,
                                    info["d_feat"]),
            donate=(0, 1),
            notes=f"edges padded {n_edges_raw}->{n_edges}, each rank's "
                  f"slice over {all_axes}; nodes replicated + psum",
        )

    # sampled minibatch (Reddit)
    cfg = shape_config(shape)
    B = info["batch_nodes"]
    f1, f2 = info["fanout"]
    dp = dp_axes(mesh)
    shapes = {
        "feats_hop_0": ((B, info["d_feat"]), torch.float32),
        "feats_hop_1": ((B, f1, info["d_feat"]), torch.float32),
        "feats_hop_2": ((B, f1, f2, info["d_feat"]), torch.float32),
        "labels": ((B,), torch.int32),
    }
    bspecs = {"feats_hop_0": P(dp, None), "feats_hop_1": P(dp, None, None),
              "feats_hop_2": P(dp, None, None, None), "labels": P(dp)}
    batch = local_batch(mesh, shapes, bspecs, device)
    params, opt_state = _params_opt(cfg, optimizer, device)
    gathered = B * (1 + f1 + f1 * f2)
    flops = 3 * (2.0 * 2 * gathered * info["d_feat"] * cfg.d_hidden
                 + 2.0 * 2 * B * cfg.d_hidden * cfg.n_classes)
    return Cell(
        arch=FULL.name, shape=shape, kind="train",
        fn=make_sampled_train_step(cfg, optimizer, mesh),
        args=(params, opt_state, batch),
        in_specs=(P(), P(), bspecs), out_specs=(P(), P(), P()),
        model_flops=flops,
        donate=(0, 1),
        notes=f"host NeighborSampler feeds fixed fanout {info['fanout']}",
    )
