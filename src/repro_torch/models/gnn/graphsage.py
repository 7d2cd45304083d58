"""GraphSAGE [Hamilton et al. 2017, arXiv:1706.02216], mean aggregator (port
of ``repro.models.gnn.graphsage``, single-device forms).

Two execution regimes:

* **full-graph**: message passing over the raw edge list, src -> dst
  (JAX's ``take`` + ``segment_sum``: ``index_select`` + ``index_add_``).
  The messages are gathered and summed in chunks of edges
  (:class:`_EdgeSum`), so no (edges, features) tensor larger than
  ``EDGE_CHUNK_BYTES`` is ever live: ogb_products' 61.9M edges would
  otherwise materialize 24.7 GB of messages at layer 0 and 31.7 GB at
  layer 1, saved again for the backward where edges carry weights. The
  sums are JAX's, in another order.
* **sampled minibatch**: fixed-fanout neighbor tensors from the host-side
  :class:`~repro_torch.models.gnn.sampler.NeighborSampler`, a masked mean
  over each hop's fanout.

Parameters are named as in the JAX tree: ``layer_l.{w_self, w_neigh,
bias}``. The train steps update the parameters in place (one fused
``adamw`` launch per tensor on the card) and return them. The sharded
aggregations and ``param_specs`` wait for the distributed slice.
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


def init_params(cfg: SAGEConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda", seed: int = 0) -> SAGEParams:
    """JAX's init: per layer ``w_self`` and ``w_neigh`` ~ N(0, 1 / fan_in),
    zero bias, drawn from ``gen`` (default: a generator on ``device`` seeded
    with ``seed``)."""
    if gen is None:
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
    chunk = max(1, EDGE_CHUNK_BYTES // (h.shape[1] * h.element_size()))
    agg = _EdgeSum.apply(h, src, dst, edge_weight, n_nodes, chunk)
    return agg * degree_inv[:, None]


def full_graph_forward(cfg: SAGEConfig, params: SAGEParams,
                       graph: Dict[str, torch.Tensor]) -> torch.Tensor:
    """graph: features (N, F), src (E,), dst (E,), degree_inv (N,), optional
    edge_weight (E,) -> (N, n_classes) logits."""
    h = graph["features"].to(cfg.dtype)
    n_nodes = h.shape[0]
    for l in range(cfg.n_layers):
        lp = params.layer(l)
        neigh = _aggregate_dense(h, graph["src"], graph["dst"], n_nodes,
                                 graph["degree_inv"], graph.get("edge_weight"))
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


def make_loss_step(loss_fn, optimizer):
    """``step(params, opt_state, data) -> (params, opt_state, loss)`` for
    ``loss_fn(params, data)``: the gradient, then ``optim.step`` in place on
    the parameters (returned as the same module)."""
    def step(params, opt_state, data):
        plist = list(params.parameters())
        loss = loss_fn(params, data)
        grads = torch.autograd.grad(loss, plist)
        opt_state = optim_lib.step(optimizer, grads, opt_state, plist)
        return params, opt_state, loss.detach()

    return step


def make_full_graph_train_step(cfg: SAGEConfig, optimizer=None):
    optimizer = optimizer or optim_lib.adam(1e-2)
    return make_loss_step(
        lambda p, graph: node_classification_loss(
            full_graph_forward(cfg, p, graph), graph["labels"],
            graph.get("label_mask")), optimizer)


def make_sampled_train_step(cfg: SAGEConfig, optimizer=None):
    optimizer = optimizer or optim_lib.adam(1e-2)
    return make_loss_step(
        lambda p, batch: node_classification_loss(
            sampled_forward(cfg, p, batch), batch["labels"]), optimizer)
