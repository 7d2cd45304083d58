"""Public kernel ops with autograd: ``session_nll``, ``examination_nll``,
``embedding_bag``, ``fm_interaction``, ``flash_attention`` and
``dcn_cross``.

Port of ``repro.kernels.ops``. The device picks the forward: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor takes the
kernel's plain version. There is no registry and no fallback from a kernel
to its plain version. Gradients do not depend on the forward route, and
each backward is plain PyTorch (no TPU kernel has a Pallas backward):

* ``session_nll``: the closed form (``ops.py:212-221``),
  d/dx = (sigmoid(x) - c) m / count, d/dc = -x m / count.
* ``examination_nll``: autograd of the plain ref composition
  (``ops.py:254-265``), so it inherits the saturating VJP of
  ``core.recursions``.
* ``embedding_bag``: ``_bag_bwd`` (``ops.py:153-175``), one ``index_add_``
  and one row dot per bag slot, never a (B*L, D) buffer; d_w is 0 at
  padding, and an id >= N scatters into row N - 1, as the forward reads.
* ``fm_interaction``: the closed form
  dv[b,f,d] = g[b] (sum_f v[b,:,d] - v[b,f,d]).
* ``flash_attention``: autograd of the plain version, recomputed.
* ``dcn_cross``: the closed form with z = x W + b recomputed and h = g x0:
  dx0 = g z, dx = h W^T + g, dW = x^T h, db = sum_rows h. When x is x0
  (the first cross layer), autograd adds both contributions into it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dcn_cross import dcn_cross_cuda, dcn_cross_plain
from repro_torch.kernels.embedding_bag import (ID_TYPES, embedding_bag_cuda,
                                               embedding_bag_plain)
from repro_torch.kernels.examination_nll import (examination_nll_cuda,
                                                 examination_nll_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import layout as attention_layout
from repro_torch.kernels.fm_interaction import (fm_interaction_plain,
                                                fm_interaction_triton)
from repro_torch.kernels.ref import examination_nll_ref
from repro_torch.kernels.session_nll import (session_nll_plain,
                                             session_nll_triton)


def _route(device: torch.device, kernel, plain):
    if device.type == "cuda":
        return kernel
    if device.type == "cpu":
        return plain
    raise ValueError(f"no route for tensors on {device}")


class _SessionNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, clicks, mask):
        ctx.save_for_backward(logits, clicks, mask)
        fn = _route(logits.device, session_nll_triton, session_nll_plain)
        return fn(logits, clicks, mask)

    @staticmethod
    def backward(ctx, g):
        logits, clicks, mask = ctx.saved_tensors
        x = logits.float()
        m = mask.float()
        scale = g * m / torch.clamp_min(torch.sum(m), 1.0)
        d_logits = d_clicks = None
        if ctx.needs_input_grad[0]:
            d_logits = ((torch.sigmoid(x) - clicks.float()) * scale
                        ).to(logits.dtype)
        if ctx.needs_input_grad[1]:
            d_clicks = (-x * scale).to(clicks.dtype)
        return d_logits, d_clicks, None


def session_nll(logits: torch.Tensor, clicks: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked-mean Bernoulli click NLL straight from (B, K) logits."""
    return _SessionNLL.apply(logits.contiguous(), clicks.contiguous(),
                             mask.contiguous())


class _ExaminationNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, clicks, mask, pss, pd, pr, prn):
        ctx.save_for_backward(x, clicks, mask, pss, pd, pr, prn)
        fn = _route(x.device, examination_nll_cuda, examination_nll_plain)
        return fn(x, clicks, mask, pss, pd, pr, prn)

    @staticmethod
    def backward(ctx, g):
        x, clicks, mask, pss, pd, pr, prn = ctx.saved_tensors
        diff = [x, clicks, None, pss, pd, pr, prn]
        wanted = [i for i, t in enumerate(diff)
                  if t is not None and ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) if t is not None
                      else mask for i, t in enumerate(diff)]
            loss = examination_nll_ref(*leaves)
            grads = torch.autograd.grad(loss, [leaves[i] for i in wanted], g)
        out = [None] * 7
        for i, d in zip(wanted, grads):
            out[i] = d
        return tuple(out)


def examination_nll(attr_logits, clicks, mask, p_skip_survive, p_death,
                    p_reset, p_reset_not) -> torch.Tensor:
    """Fused conditional click NLL of the examination-chain models.

    Inputs are the raw attraction logits, the clicks, the bool mask and the
    four probability-space factors of
    ``core.recursions.conditional_examination_odds``, all (B, K); the output
    is the scalar masked-mean NLL that ``_ChainModel.compute_loss``
    minimizes.
    """
    return _ExaminationNLL.apply(
        *(t.contiguous() for t in (attr_logits, clicks, mask, p_skip_survive,
                                   p_death, p_reset, p_reset_not)))


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(table, ids, weights)
        fn = _route(table.device, embedding_bag_cuda, embedding_bag_plain)
        return fn(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        g = g.float()
        live = ids >= 0
        w = live.float() if weights is None else torch.where(
            live, weights, 0.0).float()
        safe = torch.clamp(ids, 0, max(table.shape[0] - 1, 0)).long()
        d_table = d_w = None
        want_table = ctx.needs_input_grad[0]
        want_w = weights is not None and ctx.needs_input_grad[2]
        if want_table:
            d_table = torch.zeros(table.shape, dtype=torch.float32,
                                  device=table.device)
        if want_w:
            d_w = torch.empty(ids.shape, dtype=torch.float32,
                              device=ids.device)
        # One bag slot at a time, as _bag_bwd scans: each step touches a
        # (B, D) slice, never a (B*L, D) buffer.
        safe_t, w_t = safe.t().contiguous(), w.t().contiguous()  # (L, B)
        for l in range(ids.shape[1]):
            rows = safe_t[l]
            if want_table:
                d_table.index_add_(0, rows, w_t[l, :, None] * g)
            if want_w:
                d_w[:, l] = torch.sum(table[rows].float() * g, dim=-1)
        if want_table:
            d_table = d_table.to(table.dtype)
        if want_w:
            d_w = torch.where(live, d_w, 0.0).to(weights.dtype)
        return d_table, None, d_w


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum") -> torch.Tensor:
    """out[b] = reduce_l table[ids[b, l]]; ids < 0 are padding.

    combiner: "sum" | "mean" (mean over non-padding entries). Ids >= N
    read the table's last row. int32 and int64 ids are handed over as they
    are; other integer types are read as int64.
    """
    if ids.dtype not in ID_TYPES:
        ids = ids.long()
    ids = ids.contiguous()
    if combiner == "mean":
        count = torch.sum((ids >= 0).float(), dim=1, keepdim=True)
        if weights is None:
            weights = torch.ones(ids.shape, dtype=torch.float32,
                                 device=ids.device)
        weights = weights / torch.clamp_min(count, 1.0)
    elif combiner != "sum":
        raise ValueError(f"unknown combiner {combiner!r}")
    if weights is not None:
        weights = weights.contiguous()
    return _EmbeddingBag.apply(table.contiguous(), ids, weights)


class _FMInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        fn = _route(v.device, fm_interaction_triton, fm_interaction_plain)
        return fn(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        vf = v.float()
        s = torch.sum(vf, dim=1, keepdim=True)                 # (B, 1, D)
        return (g[:, None, None] * (s - vf)).to(v.dtype)


def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """FM second-order term: (B, F, D) field embeddings -> (B,) float32."""
    return _FMInteraction.apply(v.contiguous())


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        fn = _route(q.device, flash_attention_cuda, flash_attention_plain)
        return fn(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(saved)]
            out = flash_attention_plain(*leaves, causal=ctx.causal,
                                        scale=ctx.scale)
            grads = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        result = [None] * 5
        for i, d in zip(wanted, grads):
            result[i] = d
        return tuple(result)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention, q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh) with
    Hq % Hkv == 0 -> (B, Hq, Sq, Dh) in q's layout; causal aligns q to the
    end of KV. Each input is taken as it is when contiguous or the
    transpose(1, 2) view of a contiguous (B, S, H, Dh) tensor, and copied
    to contiguous otherwise."""
    q, k, v = (t if attention_layout(t) is not None else t.contiguous()
               for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, scale)


class _DcnCross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x, w, b):
        ctx.save_for_backward(x0, x, w, b)
        fn = _route(x.device, dcn_cross_cuda, dcn_cross_plain)
        return fn(x0, x, w, b)

    @staticmethod
    def backward(ctx, g):
        x0, x, w, b = ctx.saved_tensors
        g = g.float()
        wf = w.float()
        h = g * x0.float()
        d = [None] * 4
        if ctx.needs_input_grad[0]:
            z = torch.matmul(x.float(), wf) + b.float()
            d[0] = (g * z).to(x0.dtype)
        if ctx.needs_input_grad[1]:
            d[1] = (torch.matmul(h, wf.t()) + g).to(x.dtype)
        if ctx.needs_input_grad[2]:
            d[2] = torch.matmul(x.float().t(), h).to(w.dtype)
        if ctx.needs_input_grad[3]:
            d[3] = torch.sum(h, dim=0).to(b.dtype)
        return tuple(d)


def dcn_cross(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """DCN-V2 cross layer x0 * (x @ W + b) + x: x0 and x (B, D), W (D, D)
    in the (in, out) layout, b (D,) -> (B, D) float32. Inputs of mixed
    dtypes are all cast to float32 (the function casts each to float32)."""
    ts = (x0, x, w, b)
    if len({t.dtype for t in ts}) > 1:
        ts = tuple(t.float() for t in ts)
    # x0 and x are often one tensor (the first cross layer); contiguous()
    # keeps it one, so the kernel reads a single buffer.
    return _DcnCross.apply(*(t.contiguous() for t in ts))
