"""GraphSAGE [Hamilton et al. 2017, arXiv:1706.02216], mean aggregator (port
of ``repro.models.gnn.graphsage``).

Two execution regimes:

* **full-graph**: message passing over the raw edge list, src -> dst
  (JAX's ``take`` + ``segment_sum``: ``index_select`` + ``index_add_``).
  The messages are gathered and summed in chunks of edges
  (:class:`_EdgeSum`), so no (edges, features) tensor larger than
  ``EDGE_CHUNK_BYTES`` is ever live: ogb_products' 61.9M edges would
  otherwise materialize 24.7 GB of messages at layer 0 and 31.7 GB at
  layer 1, saved again for the backward where edges carry weights. The
  sums are JAX's, in another order. On a mesh
  (``full_graph_forward(..., mesh)``, every rank holding the whole graph
  and the same node states) the edges are split over every rank, two
  ways:

  - edge-sharded (:func:`_aggregate_sharded`): rank s sums its slice of
    the edges (padded to a multiple of the ranks with weight-0 edges) into
    all the nodes, and one all-reduce merges the partial sums: wire bytes
    = nodes x features x 4 a layer, whatever the edge count;
  - dst-partitioned (``SAGEConfig.partitioned_edges``,
    :func:`_aggregate_dst_partitioned`): the edges arrive grouped so that
    rank s's slice only targets nodes ``[s * N / n, (s + 1) * N / n)``;
    its local sum is that block's final aggregate, and one all-gather a
    layer assembles it (half an all-reduce's wire).

  Everything after an aggregation is replicated, so its collective's
  backward is JAX's transpose under a replicated consumer: the identity
  for the all-reduce, the rank's own block for the all-gather (a
  reduce-scatter would add up n equal copies); the node states' gradient,
  of which each rank computes only its edges' share, is summed over the
  ranks where the states enter the aggregation
  (:class:`~repro_torch.distrib.collectives.SumGradients`).
* **sampled minibatch**: fixed-fanout neighbor tensors from the host-side
  :class:`~repro_torch.models.gnn.sampler.NeighborSampler`, a masked mean
  over each hop's fanout.

Parameters are named as in the JAX tree: ``layer_l.{w_self, w_neigh,
bias}``. The train steps update the parameters in place (one fused
``adamw`` launch per tensor on the card) and return them. The weights are
tiny and replicated (:func:`param_specs`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import optim as optim_lib
from repro_torch.nn.module import Module

#: The most bytes of gathered messages one chunk of edges holds.
EDGE_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass
class SAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    sample_sizes: Sequence[int] = (25, 10)
    dtype: Any = torch.float32
    # edges pre-partitioned by dst range: each rank owns a disjoint node
    # block, its aggregation needs no reduction and one all-gather of the
    # block a layer. Input contract: edge i lives in the slice of the rank
    # owning dst[i].
    partitioned_edges: bool = False


def _dims(cfg: SAGEConfig):
    return [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


class SAGEParams(Module):
    """The JAX tree ``{layer_l: {w_self, w_neigh, bias}}`` as a module."""

    def __init__(self, cfg: SAGEConfig, gen: Optional[torch.Generator],
                 device):
        super().__init__()
        dims = _dims(cfg)
        for l in range(cfg.n_layers):
            std = (1.0 / dims[l]) ** 0.5

            def normal():
                return (torch.randn(dims[l], dims[l + 1], generator=gen,
                                    device=device) * std).to(cfg.dtype)

            self.add_module(f"layer_{l}", torch.nn.ParameterDict({
                "w_self": normal(), "w_neigh": normal(),
                "bias": torch.zeros(dims[l + 1], dtype=cfg.dtype,
                                    device=device)}))

    def layer(self, l: int) -> torch.nn.ParameterDict:
        return getattr(self, f"layer_{l}")


def param_specs(cfg: SAGEConfig, mesh=None):
    """Weights are tiny: every leaf replicated, ``P()`` in the JAX-shaped
    tree."""
    from repro_torch.distrib.shardings import P

    del mesh
    return {f"layer_{l}": {"w_self": P(), "w_neigh": P(), "bias": P()}
            for l in range(cfg.n_layers)}


def init_params(cfg: SAGEConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda", seed: int = 0) -> SAGEParams:
    """JAX's init: per layer ``w_self`` and ``w_neigh`` ~ N(0, 1 / fan_in),
    zero bias, drawn from ``gen`` (default: a generator on ``device`` seeded
    with ``seed``)."""
    if gen is None and torch.device(device).type != "meta":
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return SAGEParams(cfg, gen, device)


# ---------------------------------------------------------------------------
# Full-graph path
# ---------------------------------------------------------------------------

class _EdgeSum(torch.autograd.Function):
    """``out[dst[e]] += h[src[e]] * w[e]`` over the edges, in chunks of
    ``chunk`` edges; its backward is the transposed sum, ``grad_h[src[e]]
    += grad[dst[e]] * w[e]``, in the same chunks. The edge weights are
    graph data: no gradient reaches them."""

    @staticmethod
    def forward(ctx, h, src, dst, weight, n_nodes, chunk):
        ctx.save_for_backward(src, dst, weight)
        ctx.chunk = chunk
        ctx.n_rows = h.shape[0]
        return _scatter(h, src, dst, weight, n_nodes, chunk)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:  # the input features
            return (None,) * 6
        src, dst, weight = ctx.saved_tensors
        grad_h = _scatter(grad.contiguous(), dst, src, weight, ctx.n_rows,
                          ctx.chunk)
        return grad_h, None, None, None, None, None


def _scatter(h, src, dst, weight, n_out, chunk):
    out = h.new_zeros(n_out, h.shape[1])
    for lo in range(0, src.shape[0], chunk):
        msgs = h.index_select(0, src[lo:lo + chunk])
        if weight is not None:
            msgs = msgs * weight[lo:lo + chunk, None]
        out.index_add_(0, dst[lo:lo + chunk], msgs)
    return out


def _aggregate_dense(h, src, dst, n_nodes, degree_inv, edge_weight=None):
    agg = _EdgeSum.apply(h, src, dst, edge_weight, n_nodes, _edge_chunk(h))
    return agg * degree_inv[:, None]


def _edge_chunk(h) -> int:
    return max(1, EDGE_CHUNK_BYTES // (h.shape[1] * h.element_size()))


def _mesh_shards(mesh):
    """(the world group, this rank's row-major index over every mesh axis,
    the number of ranks)."""
    import torch.distributed as dist

    from repro_torch.distrib.shardings import (axis_index, axis_names,
                                               axis_size)

    index, count = 0, 1
    for axis in axis_names(mesh):
        n = axis_size(mesh, axis)
        index, count = index * n + axis_index(mesh, axis), count * n
    return dist.group.WORLD, index, count


def _edge_slice(t, index, count, fill):
    """Rank ``index``'s slice of ``count`` of the edge tensor ``t``, padded
    with ``fill`` to a multiple of ``count``."""
    pad = -t.shape[0] % count
    if pad:
        t = torch.cat([t, t.new_full((pad,), fill)])
    step = t.shape[0] // count
    return t[index * step:(index + 1) * step]


def _aggregate_sharded(mesh, h, src, dst, n_nodes, degree_inv,
                       edge_weight=None):
    """Edge-sharded mean aggregation: the rank's slice of the edges summed
    into every node, then one all-reduce over the ranks. Padded edges carry
    weight 0 (without padding or weights, no weight is multiplied in)."""
    from repro_torch.distrib.collectives import AllReduceSum, SumGradients

    group, index, count = _mesh_shards(mesh)
    if edge_weight is None and src.shape[0] % count:
        edge_weight = torch.ones(src.shape, dtype=h.dtype, device=h.device)
    src_loc = _edge_slice(src, index, count, 0)
    dst_loc = _edge_slice(dst, index, count, 0)
    w_loc = (None if edge_weight is None
             else _edge_slice(edge_weight, index, count, 0.0))
    partial = _EdgeSum.apply(SumGradients.apply(h, group), src_loc, dst_loc,
                             w_loc, n_nodes, _edge_chunk(h))
    return AllReduceSum.apply(partial, group) * degree_inv[:, None]


def _aggregate_dst_partitioned(mesh, h, src, dst, n_nodes, degree_inv,
                               edge_weight=None):
    """Aggregation with dst-partitioned edges: rank s's edge slice only
    targets nodes ``[s * Nl, (s + 1) * Nl)``, so its local sum is that
    block's final aggregate; one all-gather assembles the nodes."""
    from repro_torch.distrib.collectives import AllGatherRows, SumGradients

    group, index, count = _mesh_shards(mesh)
    if n_nodes % count or src.shape[0] % count:
        raise ValueError(f"dst-partitioned edges: {n_nodes} nodes and "
                         f"{src.shape[0]} edges must split {count} ways")
    n_local = n_nodes // count
    src_loc = _edge_slice(src, index, count, 0)
    dst_loc = _edge_slice(dst, index, count, 0) - index * n_local
    w_loc = (None if edge_weight is None
             else _edge_slice(edge_weight, index, count, 0.0))
    deg_loc = degree_inv[index * n_local:(index + 1) * n_local]
    local = _EdgeSum.apply(SumGradients.apply(h, group), src_loc, dst_loc,
                           w_loc, n_local, _edge_chunk(h))
    return AllGatherRows.apply(local * deg_loc[:, None], group)


def full_graph_forward(cfg: SAGEConfig, params: SAGEParams,
                       graph: Dict[str, torch.Tensor],
                       mesh=None) -> torch.Tensor:
    """graph: features (N, F), src (E,), dst (E,), degree_inv (N,), optional
    edge_weight (E,) -> (N, n_classes) logits. With a ``mesh`` every rank
    holds the whole graph and the aggregations are split over its ranks
    (edge-sharded, or dst-partitioned with ``cfg.partitioned_edges``)."""
    h = graph["features"].to(cfg.dtype)
    n_nodes = h.shape[0]
    ew = graph.get("edge_weight")
    for l in range(cfg.n_layers):
        lp = params.layer(l)
        if mesh is None:
            neigh = _aggregate_dense(h, graph["src"], graph["dst"], n_nodes,
                                     graph["degree_inv"], ew)
        elif cfg.partitioned_edges:
            neigh = _aggregate_dst_partitioned(
                mesh, h, graph["src"], graph["dst"], n_nodes,
                graph["degree_inv"], ew)
        else:
            neigh = _aggregate_sharded(mesh, h, graph["src"], graph["dst"],
                                       n_nodes, graph["degree_inv"], ew)
        h = (h @ lp["w_self"].to(cfg.dtype)
             + neigh @ lp["w_neigh"].to(cfg.dtype) + lp["bias"])
        if l < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# Sampled-minibatch path (fixed fanout)
# ---------------------------------------------------------------------------

def _mean_agg(x, mask):
    """(..., fanout, F) -> (..., F): the mean over the fanout, over the valid
    neighbours where a mask is given."""
    if mask is None:
        return torch.mean(x, dim=-2)
    m = mask.to(x.dtype)[..., None]
    return torch.sum(x * m, dim=-2) / torch.clamp(torch.sum(m, dim=-2),
                                                  min=1.0)


def sampled_forward(cfg: SAGEConfig, params: SAGEParams,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: feats_hop_0 (B, F), feats_hop_1 (B, f1, F), feats_hop_2 (B, f1,
    f2, F), ... and optional mask_hop_i; collapses the deepest hop a layer
    at a time -> (B, n_classes)."""
    hops = [batch[f"feats_hop_{i}"].to(cfg.dtype)
            for i in range(cfg.n_layers + 1)]
    masks = [batch.get(f"mask_hop_{i}") for i in range(cfg.n_layers + 1)]
    for l in range(cfg.n_layers):
        lp = params.layer(l)
        new_hops = []
        for depth in range(len(hops) - 1):
            neigh_h = _mean_agg(hops[depth + 1], masks[depth + 1])
            h = (hops[depth] @ lp["w_self"].to(cfg.dtype)
                 + neigh_h @ lp["w_neigh"].to(cfg.dtype) + lp["bias"])
            if l < cfg.n_layers - 1:
                h = torch.relu(h)
            new_hops.append(h)
        hops = new_hops
        masks = masks[:len(hops)]
    return hops[0]


# ---------------------------------------------------------------------------
# Loss / train steps
# ---------------------------------------------------------------------------

def node_classification_loss(logits, labels, mask=None) -> torch.Tensor:
    """Mean cross entropy over the nodes whose label is >= 0 (or ``mask``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = labels >= 0
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def make_loss_step(loss_fn, optimizer, mesh=None):
    """``step(params, opt_state, data) -> (params, opt_state, loss)`` for
    ``loss_fn(params, data)``: the gradient, then ``optim.step`` in place on
    the parameters (returned as the same module). With ``mesh`` the data
    are this rank's rows of a batch split over the data axes: the loss is
    each rank's mean divided by their number, and it and every gradient
    are summed over them (the global batch's mean, as JAX's replicated
    parameters under a batch-sharded step)."""
    group, share = None, 1
    if mesh is not None:
        from repro_torch.distrib.collectives import axes_group
        from repro_torch.distrib.shardings import (DATA_AXES,
                                                   data_parallel_size)

        group = axes_group(mesh, DATA_AXES(mesh))
        share = data_parallel_size(mesh)

    def step(params, opt_state, data):
        plist = list(params.parameters())
        loss = loss_fn(params, data)
        if group is not None:
            loss = loss / share
        grads = torch.autograd.grad(loss, plist)
        loss = loss.detach()
        if group is not None:
            import torch.distributed as dist

            for t in (loss,) + grads:
                dist.all_reduce(t, group=group)
        opt_state = optim_lib.step(optimizer, grads, opt_state, plist)
        return params, opt_state, loss

    return step


def make_full_graph_train_step(cfg: SAGEConfig, optimizer=None, mesh=None):
    optimizer = optimizer or optim_lib.adam(1e-2)
    return make_loss_step(
        lambda p, graph: node_classification_loss(
            full_graph_forward(cfg, p, graph, mesh), graph["labels"],
            graph.get("label_mask")), optimizer)


def make_sampled_train_step(cfg: SAGEConfig, optimizer=None, mesh=None):
    """The sampled step; with ``mesh`` over this rank's rows of the batch
    (see :func:`make_loss_step`)."""
    optimizer = optimizer or optim_lib.adam(1e-2)
    return make_loss_step(
        lambda p, batch: node_classification_loss(
            sampled_forward(cfg, p, batch), batch["labels"]), optimizer,
        mesh)
