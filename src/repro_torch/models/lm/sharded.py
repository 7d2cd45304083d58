"""The LM family's sharded forms (port of the mesh paths of
``repro.models.lm.transformer``): JAX's ``param_specs`` and
``cache_specs``, and the forward, loss (with the microbatch split that
``transformer.make_train_step`` takes on a mesh), prefill and decode of
one rank over its shards, with explicit collectives on local tensors over
the mesh's process groups (NCCL on the card, gloo on the CPU; no DTensor).

**Placement.** :func:`param_specs` is JAX's table: tensor parallelism over
``model`` (heads, the FFN's hidden, the vocabulary, the experts), FSDP
over the data axes ``(pod, data)`` on every weight's ``d_model``, each
axis dropped to replication where its size does not divide the dimension.
It reads only the mesh's axis names and sizes (an
:class:`~repro_torch.distrib.shardings.AbstractMesh` will do).
:func:`place_params` cuts a full :class:`LMParams` to this rank's blocks,
:func:`gather_params` puts them back together. JAX's ``_wsc`` sharding
constraints have no counterpart: the explicit layout below is the
constraint.

**The layout of one step.** Activations are this rank's rows of the batch
(split over the data axes) and are replicated over ``model``. A weight is
used as its FSDP shards gathered over the data axes
(:class:`AllGatherReduceScatter`: the backward sums the data ranks'
gradients and cuts this rank's block; a weight the guard leaves whole
there has its gradient summed over them through ``SumGradients``), its
``model`` split kept:

* a column-parallel matmul (``wq``/``wk``/``wv``/``w_gate``/``w_up``,
  ``lm_head``) takes its input through ``SumGradients`` over ``model``
  (each model rank's backward holds its columns' share) and gives this
  rank's columns;
* a row-parallel one (``wo``, ``w_down``) all-reduces the partial
  products over ``model`` (``AllReduceSum``, identity backward): in
  float32 and then cast down, as GSPMD does where the contraction is
  split (on the card one GEMM in ``cfg.dtype`` with a float32 result);
  with ``explicit_row_parallel`` cast down first and summed in
  ``cfg.dtype``, as JAX's ``_row_parallel_matmul``;
* attention runs on this rank's heads where ``model`` divides both
  ``n_heads`` and ``n_kv_heads``; otherwise the guard may have split a
  head mid-way (JAX's own test config: 2 KV heads of 16 over 4 ranks), so
  q, k and v are gathered over ``model`` and every model rank runs every
  head;
* the embedding is a masked lookup into the vocabulary block, summed over
  ``model``; the loss's logsumexp and gold logit are reduced over the
  vocabulary blocks (a max, a sum of exponentials, the masked gold): the
  (B, S, V) logits are never gathered;
* the MoE is JAX's ``shard_map`` body: experts split over ``model``, the
  router replicated, capacity ``max(int(T top_k / E capacity_factor), 1)``
  (at most T) from this data rank's T tokens of the microbatch, each local
  expert keeping its top-``capacity`` tokens by gate (ties to the lower
  token, as ``lax.top_k``), the outputs summed over ``model``. On a mesh
  it is another function than the dense oracle of the single-device form,
  whatever the mesh's size.

The loss of each microbatch is its global batch's masked mean: each rank
contributes its masked sum over the all-reduced count, summed over the
data axes. Microbatch m is the global rows ``[m B / M, (m + 1) B / M)``,
split over the data axes; each rank's block of the batch is gathered over
them first (its token ids: a few KB). Where the data ranks do not divide a
microbatch, each rank takes ``ceil(b / n)`` rows, the last ones padded
with masked rows, as GSPMD pads the dimension.

**Decode.** The cache ``(U, sub, B, S, Hkv, Dh)`` is split over the data
axes on the batch and over ``cfg.decode_seq_axes`` on the sequence; the
new token's k and v go to the rank whose block holds ``index``. With
``flash_decode`` each rank takes a partial softmax over its block (m, l,
o) and a max and two sums over the sequence axes combine them; without
it the blocks are gathered and the softmax runs over the whole cache, as
the single-device form.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distrib.collectives import (AllGatherReduceScatter,
                                             AllGatherRows, AllReduceSum,
                                             SumGradients, axes_group,
                                             gather_rows)
from repro_torch.distrib.shardings import (DATA_AXES, MODEL_AXIS,
                                           NamedSharding, P, _axes,
                                           axis_index, axis_size)
from repro_torch.models.lm import transformer as tf


# ---------------------------------------------------------------------------
# Specs and placement
# ---------------------------------------------------------------------------

def _axes_size(mesh, entry) -> int:
    out = 1
    for a in _axes(entry):
        out *= axis_size(mesh, a)
    return out


def param_specs(cfg: tf.LMConfig, mesh) -> Dict[str, Any]:
    """FSDP over the data axes on d_model dims + TP over ``model``, JAX's
    table; an axis whose size does not divide its dimension drops to
    replication (the ``guard``). The tree of the parameters' paths:
    ``{"embed", "ln_f", "lm_head", "dense": {...}[, "moe": {...}]}``."""
    tf.single_device_only(cfg, "the mesh forms", mesh=True)
    fsdp = DATA_AXES(mesh)
    tp = MODEL_AXIS

    def guard(spec: P, shape: tuple) -> P:
        entries = tuple(spec) + (None,) * len(shape)
        return P(*[e if dim % _axes_size(mesh, e) == 0 else None
                   for dim, e in zip(shape, entries)])

    def spec_for(name: str, shape: tuple) -> P:
        if name.startswith("ln"):
            return P(*([None] * len(shape)))
        table = {
            "wq": P(None, fsdp, tp), "wk": P(None, fsdp, tp),
            "wv": P(None, fsdp, tp), "wo": P(None, tp, fsdp),
            "w_gate": P(None, fsdp, tp), "w_up": P(None, fsdp, tp),
            "w_down": P(None, tp, fsdp),
            "ws_gate": P(None, fsdp, tp), "ws_up": P(None, fsdp, tp),
            "ws_down": P(None, tp, fsdp),
            "router": P(None, None, None),
            # experts: EP over model, FSDP on the d_model dim
            "we_gate": P(None, tp, fsdp, None),
            "we_up": P(None, tp, fsdp, None),
            "we_down": P(None, tp, None, fsdp),
        }
        return guard(table[name], shape)

    D, V = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, Any] = {
        "embed": guard(P(tp, fsdp), (V, D)),
        "ln_f": P(None),
        "lm_head": guard(P(fsdp, tp), (D, V)),
    }
    for stack, shapes in tf._stack_shapes(cfg).items():
        specs[stack] = {name: spec_for(name, (cfg.n_units,) + shape)
                        for name, shape in shapes.items()}
    return specs


def cache_specs(cfg: tf.LMConfig, mesh, *, shard_seq: bool = True
                ) -> Dict[str, P]:
    """The cache ``(U, sub, B, S, Hkv, Dh)``: the batch over the data axes,
    the sequence over ``model`` with ``shard_seq``."""
    tf.single_device_only(cfg, "the mesh forms", mesh=True)
    dp = DATA_AXES(mesh)
    spec = P(None, None, dp, MODEL_AXIS if shard_seq else None, None, None)
    return {"k": spec, "v": spec}


def _spec_of(specs, name: str) -> P:
    node = specs
    for key in name.split("."):
        node = node[key]
    return node


def _with_params(cfg, tensors: Dict[str, torch.Tensor]) -> tf.LMParams:
    """An :class:`LMParams` holding ``tensors`` (by parameter name)."""
    out = tf.init_params(cfg, device="meta")
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        module = out.get_submodule(owner) if owner else out
        if isinstance(module, torch.nn.ParameterDict):
            module[leaf] = torch.nn.Parameter(t)
        else:
            setattr(module, leaf, torch.nn.Parameter(t))
    return out


def place_params(cfg: tf.LMConfig, params: tf.LMParams, mesh
                 ) -> tf.LMParams:
    """This rank's blocks of the full ``params`` by :func:`param_specs`
    (a new :class:`LMParams`, the blocks copied)."""
    specs = param_specs(cfg, mesh)
    return _with_params(cfg, {
        name: NamedSharding(mesh, _spec_of(specs, name)).local(
            p.detach()).clone()
        for name, p in params.named_parameters()})


def gather_params(cfg: tf.LMConfig, params: tf.LMParams, mesh
                  ) -> tf.LMParams:
    """The full parameters from every rank's blocks (a collective: every
    rank calls it)."""
    specs = param_specs(cfg, mesh)
    full = {}
    for name, p in params.named_parameters():
        t = p.detach()
        for dim, entry in enumerate(_spec_of(specs, name)):
            if entry is not None:
                t = gather_rows(t, axes_group(mesh, _axes(entry)), dim)
        full[name] = t
    return _with_params(cfg, full)


def local_cache_dims(cfg: tf.LMConfig, mesh, batch: int, seq: int,
                     dp_axes=None) -> Tuple[int, int]:
    """This rank's (batch, seq) of a ``(batch, seq)`` cache: the batch over
    ``dp_axes`` (default the data axes), the sequence over
    ``cfg.decode_seq_axes``."""
    dp = DATA_AXES(mesh) if dp_axes is None else tuple(dp_axes)
    seq_axes = tuple(cfg.decode_seq_axes)
    if set(dp) & set(seq_axes):
        raise ValueError(f"the cache's batch axes {dp} and sequence axes "
                         f"{seq_axes} overlap")
    nb, ns = _axes_size(mesh, dp), _axes_size(mesh, seq_axes)
    if batch % nb or seq % ns:
        raise ValueError(f"a ({batch}, {seq}) cache does not split over "
                         f"{dp} x {seq_axes} ({nb} x {ns})")
    return batch // nb, seq // ns


# ---------------------------------------------------------------------------
# One rank's layout and its collectives
# ---------------------------------------------------------------------------

class _Layout:
    """What one step reads of the mesh: the specs, the groups, this rank's
    coordinates. ``dp_axes`` are the axes the activations' batch is split
    over (default the data axes; decode may take none)."""

    def __init__(self, cfg: tf.LMConfig, mesh, dp_axes=None):
        self.cfg, self.mesh = cfg, mesh
        self.specs = param_specs(cfg, mesh)
        self.fsdp = DATA_AXES(mesh)
        self.dp_axes = self.fsdp if dp_axes is None else tuple(dp_axes)
        self.fsdp_group = axes_group(mesh, self.fsdp) if self.fsdp else None
        self.dp_group = (axes_group(mesh, self.dp_axes) if self.dp_axes
                         else None)
        self.tp = mesh.get_group(MODEL_AXIS)
        self.tp_size = axis_size(mesh, MODEL_AXIS)
        self.tp_index = axis_index(mesh, MODEL_AXIS)

    def index(self, axes) -> int:
        """This rank's row-major coordinate over ``axes``."""
        out = 0
        for a in axes:
            out = out * axis_size(self.mesh, a) + axis_index(self.mesh, a)
        return out

    def weight(self, t: torch.Tensor, spec: P) -> torch.Tensor:
        """The tensor this rank computes with: its FSDP blocks gathered over
        the data axes, with a reduce-scatter backward (the data ranks'
        gradients summed), or, whole there, itself with its gradient summed
        over them; the ``model`` split kept."""
        if self.fsdp_group is None:
            return t
        entries = tuple(spec) + (None,) * t.dim()
        dims = [d for d in range(t.dim()) if entries[d] is not None
                and MODEL_AXIS not in _axes(entries[d])]
        if not dims:
            return SumGradients.apply(t, self.fsdp_group)
        for d in dims:
            t = AllGatherReduceScatter.apply(t, self.fsdp_group, d)
        return t


def _split(spec: P, dim: int) -> bool:
    """Whether ``spec`` splits ``dim`` over ``model``."""
    return dim < len(spec) and MODEL_AXIS in _axes(spec[dim])


def _gather_last(lay: _Layout, x: torch.Tensor) -> torch.Tensor:
    """``x``'s column blocks gathered over ``model`` (its consumer is
    replicated there: the backward keeps this rank's columns), laid out as
    the unsharded tensor."""
    return AllGatherRows.apply(x.movedim(-1, 0), lay.tp).movedim(
        0, -1).contiguous()


def _columns(lay: _Layout, x, weights):
    """``x @ w`` for each ``(w, split)``: this rank's columns where ``w``'s
    are split over ``model``; x's gradient through those products is
    summed there (one all-reduce for all of them)."""
    shared = None
    out = []
    for w, split in weights:
        if split and shared is None:
            shared = SumGradients.apply(x, lay.tp)
        out.append((shared if split else x) @ w.to(lay.cfg.dtype))
    return out


def _project(lay: _Layout, x, x_split: bool, w, w_split: bool,
             explicit: bool):
    """``x @ w`` with ``x``'s last dim split over ``model`` or whole
    (``x_split``) and ``w``'s rows split or whole (``w_split``): both split
    is the row-parallel matmul, its partial products summed over
    ``model``."""
    dtype = lay.cfg.dtype
    if x_split and not w_split:
        x, x_split = _gather_last(lay, x), False
    if not x_split and w_split:
        x = SumGradients.apply(x, lay.tp)
        n = w.shape[0]
        x = x[..., lay.tp_index * n:(lay.tp_index + 1) * n]
    if not w_split:
        return x @ w.to(dtype)
    if explicit or lay.tp_size == 1 or dtype == torch.float32:
        # explicit: cast down, then summed in dtype; on one rank (no
        # partial sums) or in float32 that is GSPMD's form too
        y = (x @ w.to(dtype)).to(dtype)
        return AllReduceSum.apply(y, lay.tp)
    y = _MatmulF32.apply(x, w.to(dtype))
    return AllReduceSum.apply(y, lay.tp).to(dtype)


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` (x (..., K), w (K, N) in ``cfg.dtype``) with float32
    output: the partial products of the row-parallel matmul that GSPMD
    sums in float32. On the card one GEMM in their type accumulating in
    float32 (``out_dtype``); on the CPU, which has none, the float32 GEMM
    of the upcast operands (products of bfloat16 values are exact in
    float32, so the two differ only in the order of the sums). Backward:
    the gradient is cast to x's type (exact: the product's consumer sums
    it and casts it down, so it arrives as the upcast of one in that type)
    and the two gradient GEMMs run in that type, as every other matmul's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        y = (torch.mm(x2, w, out_dtype=torch.float32) if x.is_cuda
             else x2.float() @ w.float())
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype).reshape(-1, grad.shape[-1])
        gx = (g @ w.t()).reshape(x.shape)
        gw = x.reshape(-1, x.shape[-1]).t() @ g
        return gx, gw


def _heads_split(lay: _Layout, sp) -> bool:
    """Attention on this rank's heads: ``model`` divides both head counts
    and the projections are split over it."""
    cfg = lay.cfg
    return (cfg.n_heads % lay.tp_size == 0
            and cfg.n_kv_heads % lay.tp_size == 0
            and all(_split(sp[n], 1) for n in ("wq", "wk", "wv"))
            and _split(sp["wo"], 0))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _unit_specs(lay: _Layout, kind: str) -> Dict[str, P]:
    """The per-unit specs of a stack (the leading U dimension dropped)."""
    return {n: P(*s[1:]) for n, s in lay.specs[kind].items()}


def _qkv(lay: _Layout, lp, sp, x, positions, gather: bool):
    """q (B, S, H, Dh), k and v (B, S, Hkv, Dh) after rope: this rank's
    heads where they are split, else every head (``gather`` always takes
    every head)."""
    cfg = lay.cfg
    B, S, _ = x.shape
    names = ("wq", "wk", "wv")
    ys = _columns(lay, x, [(lay.weight(lp[n], sp[n]), _split(sp[n], 1))
                           for n in names])
    gather = gather or not _heads_split(lay, sp)
    q, k, v = ((_gather_last(lay, y) if _split(sp[n], 1) and gather else y
                ).reshape(B, S, -1, cfg.head_dim) for n, y in zip(names, ys))
    return (tf._rope(q, positions, cfg.rope_theta),
            tf._rope(k, positions, cfg.rope_theta), v)


def _attention(lay: _Layout, lp, sp, h, positions):
    """The train / prefill sublayer: (out, prefill cache entry (B, S,
    Hkv or this rank's Hkv, Dh), whether the entry is split by head)."""
    cfg = lay.cfg
    B, S, _ = h.shape
    x = tf._rmsnorm(h, lay.weight(lp["ln1"], sp["ln1"]))
    heads = _heads_split(lay, sp)
    q, k, v = _qkv(lay, lp, sp, x, positions, gather=False)
    out = tf._chunked_attention(q.transpose(1, 2),
                                tf._repeat_kv(cfg, k).transpose(1, 2),
                                tf._repeat_kv(cfg, v).transpose(1, 2),
                                causal=True, chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, S, -1)
    y = _project(lay, out, heads, lay.weight(lp["wo"], sp["wo"]),
                 _split(sp["wo"], 0), cfg.explicit_row_parallel)
    return h + y, {"k": k, "v": v}, heads


def _dense_ffn(lay: _Layout, lp, sp, h, explicit: bool):
    x = tf._rmsnorm(h, lay.weight(lp["ln2"], sp["ln2"]))
    return h + _swiglu(lay, lp, sp, x, ("w_gate", "w_up", "w_down"),
                       explicit)


def _swiglu(lay: _Layout, lp, sp, x, names, explicit: bool):
    """``(silu(x @ gate) * (x @ up)) @ down``: gate and up column-split
    over ``model`` (one guard: the same hidden width), down row-split."""
    gate, up, down = names
    split = _split(sp[gate], 1)
    g, u = _columns(lay, x, [(lay.weight(lp[gate], sp[gate]), split),
                             (lay.weight(lp[up], sp[up]), split)])
    return _project(lay, F.silu(g) * u, split,
                    lay.weight(lp[down], sp[down]), _split(sp[down], 0),
                    explicit)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: the k largest, ties to the lower
    index (a stable descending sort)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _moe_ffn(lay: _Layout, lp, sp, h):
    """JAX's ``shard_map`` MoE body on this rank: its experts over its
    tokens, capacity-bounded, summed over ``model``; then the shared
    expert."""
    cfg = lay.cfg
    dtype = cfg.dtype
    if cfg.n_experts % lay.tp_size:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"'model' of {lay.tp_size}")
    B, S, D = h.shape
    x = tf._rmsnorm(h, lay.weight(lp["ln2"], sp["ln2"]))
    # each model rank's experts read a share of x and of the router
    xt = SumGradients.apply(x, lay.tp).reshape(B * S, D)
    router = SumGradients.apply(lay.weight(lp["router"], sp["router"]),
                                lay.tp)
    wg, wu, wd = (lay.weight(lp[n], sp[n])
                  for n in ("we_gate", "we_up", "we_down"))
    E, E_loc = cfg.n_experts, wg.shape[0]
    T = B * S
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_p, top_i = _top_k(probs, cfg.top_k)
    top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True), min=1e-9)
    capacity = min(max(int(T * cfg.top_k / E * cfg.capacity_factor), 1), T)
    out = torch.zeros(T, D, dtype=torch.float32, device=h.device)
    for e in range(E_loc):
        eid = lay.tp_index * E_loc + e
        gate = torch.sum(torch.where(top_i == eid, top_p, 0.0), dim=-1)
        sel_gate, sel = _top_k(gate, capacity)
        xe = xt[sel].to(dtype)
        hid = F.silu(xe @ wg[e].to(dtype)) * (xe @ wu[e].to(dtype))
        ye = (hid @ wd[e].to(dtype)).float()
        out = out.index_add(0, sel, ye * sel_gate[:, None])
    y = AllReduceSum.apply(out, lay.tp).reshape(B, S, D).to(dtype)
    if cfg.n_shared_experts:
        y = y + _swiglu(lay, lp, sp, x, ("ws_gate", "ws_up", "ws_down"),
                        False)
    return h + y


def _ffn(lay: _Layout, kind: str, lp, sp, h, explicit: bool):
    if kind == "moe":
        return _moe_ffn(lay, lp, sp, h)
    return _dense_ffn(lay, lp, sp, h, explicit)


def _unit_body(lay: _Layout, h, positions, unit_params, collect_kv=False):
    entries = []
    for kind in tf._sub_kinds(lay.cfg):
        sp = _unit_specs(lay, kind)
        h, entry, heads = _attention(lay, unit_params[kind], sp, h,
                                     positions)
        entries.append((entry, heads))
        h = _ffn(lay, kind, unit_params[kind], sp, h,
                 lay.cfg.explicit_row_parallel)
    return (h, entries) if collect_kv else h


def _embed(lay: _Layout, params, tokens):
    """The token rows: a masked lookup into this rank's vocabulary block,
    summed over ``model``, where ``embed`` is split there."""
    spec = lay.specs["embed"]
    table = lay.weight(params.embed, spec)
    tokens = tokens.long()
    if not _split(spec, 0):
        return F.embedding(tokens, table).to(lay.cfg.dtype)
    rows = table.shape[0]
    local = tokens - lay.tp_index * rows
    owned = (local >= 0) & (local < rows)
    emb = F.embedding(torch.clamp(local, 0, rows - 1), table)
    emb = torch.where(owned[..., None], emb, torch.zeros_like(emb))
    return AllReduceSum.apply(emb, lay.tp).to(lay.cfg.dtype)


def _head(lay: _Layout, params, h):
    """(logits of this rank's vocabulary block, its first column)."""
    spec = lay.specs["lm_head"]
    h = tf._rmsnorm(h, lay.weight(params.ln_f, lay.specs["ln_f"]))
    split = _split(spec, 1)
    logits, = _columns(lay, h, [(lay.weight(params.lm_head, spec), split)])
    return logits, (lay.tp_index * logits.shape[-1] if split else 0), split


def _mask_vocab(cfg, logits, lo):
    """Padded vocabulary columns (global index >= vocab) to -inf; a block
    with none comes back as it is."""
    if lo + logits.shape[-1] <= cfg.vocab:
        return logits
    cols = lo + torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols >= cfg.vocab, float("-inf"))


def _hidden(lay: _Layout, params, tokens):
    S = tokens.shape[1]
    h = _embed(lay, params, tokens)
    positions = torch.arange(S, device=h.device)
    return tf._run_units(lay.cfg, tf._units(lay.cfg, params), h, positions,
                         functools.partial(_unit_body, lay))


# ---------------------------------------------------------------------------
# Forward, loss, microbatches (``transformer.make_train_step`` takes them)
# ---------------------------------------------------------------------------

def forward(cfg: tf.LMConfig, params, tokens, mesh):
    """tokens (this rank's rows, S) -> logits (rows, S, V or this rank's
    vocabulary block where ``lm_head`` is split over ``model``): JAX's
    ``P(dp, None, "model")`` layout."""
    lay = _Layout(cfg, mesh)
    logits, _, _ = _head(lay, params, _hidden(lay, params, tokens))
    return logits


def _global_sum(lay: _Layout, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch's data axes, without a gradient."""
    t = t.detach().clone()
    if lay.dp_group is not None:
        dist.all_reduce(t, group=lay.dp_group)
    return t


def _loss(lay: _Layout, params, batch) -> torch.Tensor:
    cfg = lay.cfg
    logits, lo, split = _head(lay, params, _hidden(lay, params,
                                                   batch["tokens"]))
    logits = _mask_vocab(cfg, logits.float(), lo)
    targets = batch["targets"].long()
    mx = torch.amax(logits, dim=-1).detach()
    if split:
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=lay.tp)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    sumexp = torch.sum(torch.exp_(logits - mx[..., None]), dim=-1)
    local = torch.clamp(targets, min=0) - lo
    owned = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.clamp(
        local, 0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = torch.where(owned, gold, 0.0)
    if split:
        sumexp = AllReduceSum.apply(sumexp, lay.tp)
        gold = AllReduceSum.apply(gold, lay.tp)
    nll = torch.log(sumexp) + mx - gold
    mask = (targets >= 0).float()
    count = _global_sum(lay, torch.sum(mask))
    share = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    if lay.dp_group is None:
        return share
    return AllReduceSum.apply(share, lay.dp_group)


def lm_loss(cfg: tf.LMConfig, params, batch, mesh) -> torch.Tensor:
    """The global batch's masked mean NLL, on every rank, from this rank's
    rows: each rank's masked sum over the all-reduced count, summed over
    the data axes (identity backward: each rank differentiates its own
    share, and the weights' backwards sum the shares)."""
    return _loss(_Layout(cfg, mesh), params, batch)


#: The value of a padded row, by batch key (else 0, a valid token id): a
#: target of -1 is masked, so the row adds nothing to the loss, its count
#: or any gradient.
_PAD = {"targets": -1}


def _microbatches(lay: _Layout, batch, M: int):
    """Microbatch m of the global batch is its rows ``[m B / M, (m + 1) B /
    M)``, split over the data axes: each rank's rows are gathered over them
    (rank order is row order) and this rank takes its block of each.

    A microbatch of ``b`` rows that the ``n`` data ranks do not divide is
    laid out as GSPMD lays such a dimension: ``c = ceil(b / n)`` rows a
    rank, rank r the rows ``[r c, min((r + 1) c, b))``, each rank padded to
    ``c`` rows with masked rows (:data:`_PAD`), so every rank runs the same
    shapes and enters every collective. JAX's ``shard_map`` bodies (the
    capacity MoE, the explicit row-parallel matmul) refuse such a split,
    and so does this; ``B % M`` must be 0, as JAX's reshape needs."""
    full = {k: (gather_rows(v, lay.dp_group) if lay.dp_group is not None
                else v) for k, v in batch.items()}
    n = 1 if lay.dp_group is None else dist.get_world_size(lay.dp_group)
    r = 0 if lay.dp_group is None else dist.get_rank(lay.dp_group)
    B = next(iter(full.values())).shape[0]
    if B % M:
        raise TypeError(f"cannot reshape a global batch of {B} rows into "
                        f"{M} microbatches of {B / M:g}")
    b = B // M
    c = -(-b // n)
    if b % n and (lay.cfg.moe or lay.cfg.explicit_row_parallel):
        body = ("capacity MoE" if lay.cfg.moe
                else "explicit row-parallel matmul")
        raise ValueError(f"a microbatch of {b} rows is not evenly divisible "
                         f"by the {n} data ranks, which the {body}'s "
                         f"shard_map needs")
    lo, hi = min(r * c, b), min((r + 1) * c, b)

    def block(key, v, m):
        rows = v[m * b + lo:m * b + hi]
        if hi - lo == c:
            return rows
        pad = rows.new_full((c - (hi - lo),) + tuple(v.shape[1:]),
                            _PAD.get(key, 0))
        return torch.cat([rows, pad])

    return [{k: block(k, v, m) for k, v in full.items()} for m in range(M)]


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def _full_vocab(lay: _Layout, logits, lo, split):
    """The whole vocabulary's logits on every model rank, padded columns
    -inf."""
    cfg = lay.cfg
    if split:
        logits = gather_rows(logits, lay.tp, dim=logits.dim() - 1)
    return _mask_vocab(cfg, logits, 0)


def make_prefill_step(cfg: tf.LMConfig, mesh, dp_axes=None):
    """prefill(params, tokens (this rank's rows, S)) -> (the last
    position's logits over the whole vocabulary (rows, 1, V), this rank's
    block of the cache in :func:`cache_specs`' placement: its rows, its
    sequence block over ``model``). Keys and values that leave a layer
    split by head are gathered over ``model`` and re-split by sequence."""
    lay = _Layout(cfg, mesh, dp_axes)

    @torch.no_grad()
    def prefill(params, tokens):
        B, S = tokens.shape
        if S % lay.tp_size:
            raise ValueError(f"a prompt of {S} does not split over 'model' "
                             f"of {lay.tp_size}")
        s_loc = S // lay.tp_size
        lo = lay.tp_index * s_loc
        h = _embed(lay, params, tokens)
        positions = torch.arange(S, device=h.device)
        cache = {k: torch.zeros((cfg.n_units, cfg.layers_per_unit, B, s_loc,
                                 cfg.n_kv_heads, cfg.head_dim),
                                dtype=cfg.dtype, device=h.device)
                 for k in ("k", "v")}
        for u, up in enumerate(tf._units(cfg, params)):
            h, entries = _unit_body(lay, h, positions, up, collect_kv=True)
            for sub, (entry, heads) in enumerate(entries):
                for k in ("k", "v"):
                    t = entry[k]
                    if heads:
                        t = gather_rows(t, lay.tp, dim=2)
                    cache[k][u, sub] = t[:, lo:lo + s_loc]
        logits, vlo, split = _head(lay, params, h[:, -1:])
        return _full_vocab(lay, logits, vlo, split), cache

    return prefill


def _decode_attention(lay: _Layout, lp, sp, h, positions, k_loc, v_loc,
                      index: int, seq_group, shard: int):
    """One decode step's attention over this rank's sequence block of the
    cache (written in place at ``index`` by the rank that holds it): the
    flash-decoding combine with ``flash_decode``, else the blocks gathered
    and one softmax over the whole cache."""
    cfg = lay.cfg
    B = h.shape[0]
    Dh = cfg.head_dim
    x = tf._rmsnorm(h, lay.weight(lp["ln1"], sp["ln1"]))
    q, k, v = _qkv(lay, lp, sp, x, positions, gather=True)
    s_loc = k_loc.shape[1]
    offset = shard * s_loc
    if offset <= index < offset + s_loc:
        k_loc[:, index - offset] = k[:, 0].to(k_loc.dtype)
        v_loc[:, index - offset] = v[:, 0].to(v_loc.dtype)
    n = 1 if seq_group is None else dist.get_world_size(seq_group)
    if cfg.flash_decode:
        # the scores in the single-device form's layout
        kt = tf._repeat_kv(cfg, k_loc).transpose(1, 2)
        vt = tf._repeat_kv(cfg, v_loc).transpose(1, 2)
        s = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2).float(),
                         kt.float()) * (Dh ** -0.5)
        valid = offset + torch.arange(s_loc, device=h.device) <= index
        s = s.masked_fill(~valid, float("-inf"))
        m_loc = torch.amax(s, dim=-1)                      # (B, H, 1)
        # a block with every position masked contributes zero weight
        m_safe = torch.where(torch.isfinite(m_loc), m_loc, 0.0)
        p = torch.exp(torch.where(torch.isfinite(s), s - m_safe[..., None],
                                  float("-inf")))
        l_loc = torch.sum(p, dim=-1)
        o_loc = torch.einsum("bhqk,bhkd->bhqd", p, vt.float())
        m_g = m_safe.clone()
        if seq_group is not None:
            dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=seq_group)
        scale = torch.where(l_loc > 0, torch.exp(m_safe - m_g), 0.0)
        l_g, o_g = l_loc * scale, o_loc * scale[..., None]
        if seq_group is not None:
            dist.all_reduce(l_g, group=seq_group)
            dist.all_reduce(o_g, group=seq_group)
        out = (o_g / torch.clamp(l_g[..., None], min=1e-30)).to(cfg.dtype)
    else:
        # the single-device form's softmax over the gathered blocks
        k_all = k_loc if n == 1 else gather_rows(k_loc, seq_group, dim=1)
        v_all = v_loc if n == 1 else gather_rows(v_loc, seq_group, dim=1)
        out = tf._decode_softmax(cfg, q, k_all, v_all, index)
    out = out.transpose(1, 2).reshape(B, 1, cfg.n_heads * Dh)
    return h + _project(lay, out, False, lay.weight(lp["wo"], sp["wo"]),
                        _split(sp["wo"], 0), False)


def make_decode_step(cfg: tf.LMConfig, mesh, dp_axes=None):
    """decode_step(params, cache, tokens (rows, 1), index) -> (logits over
    the whole vocabulary (rows, 1, V), cache): this rank's rows (over
    ``dp_axes``, default the data axes; ``()`` for a batch the data ranks
    do not divide) and its block of the cache, the sequence split over
    ``cfg.decode_seq_axes``, written in place."""
    lay = _Layout(cfg, mesh, dp_axes)
    seq_axes = tuple(cfg.decode_seq_axes)
    if set(lay.dp_axes) & set(seq_axes):
        raise ValueError(f"decode's batch axes {lay.dp_axes} and sequence "
                         f"axes {seq_axes} overlap")
    seq_group = axes_group(mesh, seq_axes) if seq_axes else None
    shard = lay.index(seq_axes)

    @torch.no_grad()
    def decode_step(params, cache, tokens, index):
        B = tokens.shape[0]
        index = int(index)
        h = _embed(lay, params, tokens)
        positions = torch.full((B, 1), index, dtype=torch.int32,
                               device=h.device)
        for u, up in enumerate(tf._units(cfg, params)):
            for sub, kind in enumerate(tf._sub_kinds(cfg)):
                sp = _unit_specs(lay, kind)
                h = _decode_attention(lay, up[kind], sp, h, positions,
                                      cache["k"][u, sub], cache["v"][u, sub],
                                      index, seq_group, shard)
                h = _ffn(lay, kind, up[kind], sp, h, False)
        logits, lo, split = _head(lay, params, h)
        return _full_vocab(lay, logits, lo, split), cache

    return decode_step
