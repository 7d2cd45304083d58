"""GraphSAGE (port of ``repro.models.gnn``): full-graph (also split over
a mesh) and sampled forms."""
from repro_torch.models.gnn.graphsage import (
    SAGEConfig,
    init_params,
    param_specs,
    full_graph_forward,
    sampled_forward,
    node_classification_loss,
    make_full_graph_train_step,
    make_sampled_train_step,
)
from repro_torch.models.gnn.sampler import NeighborSampler, random_graph

__all__ = [
    "SAGEConfig",
    "init_params",
    "param_specs",
    "full_graph_forward",
    "sampled_forward",
    "node_classification_loss",
    "make_full_graph_train_step",
    "make_sampled_train_step",
    "NeighborSampler",
    "random_graph",
]
