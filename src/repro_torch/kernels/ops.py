"""Public loss ops with autograd: ``session_nll`` and ``examination_nll``.

Port of the custom-VJP half of ``repro.kernels.ops``. The device picks the
forward: a CUDA tensor launches the hand-written kernel (or raises), a CPU
tensor takes the kernel's plain version. There is no registry and no
fallback from a kernel to its plain version. Gradients do not depend on the
forward route:

* ``session_nll`` backward is the closed form (``ops.py:212-221``):
  d/dx = (sigmoid(x) - c) m / count, d/dc = -x m / count.
* ``examination_nll`` backward is autograd of the plain ref composition
  (``ops.py:254-265``), so it inherits the saturating VJP of
  ``core.recursions``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.examination_nll import (examination_nll_cuda,
                                                 examination_nll_plain)
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
