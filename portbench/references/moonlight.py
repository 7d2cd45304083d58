"""Plain reference of Moonlight-16B-A3B (DeepSeek-V3's architecture,
``modeling_deepseek.py``, ``model_type`` ``deepseek_v3``), scoring: the
log P of each next token of a batch of sequences, in float32.

Written from the published modeling code and config; it reads every size
from the configuration's own keys (``hidden_size``, ``num_attention_heads``,
``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
``v_head_dim``, ``first_k_dense_replace``, ``n_routed_experts``,
``num_experts_per_tok``, ``n_shared_experts``, ``routed_scaling_factor``,
``rms_norm_eps``, ``rope_theta``, ``vocab_size``, ``num_hidden_layers``)
and imports nothing of the program, its kernels or JAX. The loop hands it
``leaf(path, unit)``: a leaf's start as ``yardstick.weights.rounded``
gives it at the leaf's dtype, in float32 (``unit`` picks one layer of a
stacked leaf), so each layer's weights are made again from the seed one
layer at a time, after the program's model is freed.

Per layer, as modeling_deepseek: RMSNorm; MLA without a q LoRA (q =
x W_q; [latent | k_pe] = x W_kv_a; latent RMSNormed, then W_kv_b to each
head's k_nope and v; rope on q_pe and the one k_pe every head shares;
scores over ``qk_nope + qk_rope`` dims scaled by that width to the -1/2;
causal softmax; W_o); RMSNorm; the first ``first_k_dense_replace`` layers
a SwiGLU MLP, the others the MoE: sigmoid scores of the router's float32
logits, the top-k chosen by score plus the float32
``e_score_correction_bias`` (``noaux_tc``, one group), weights the chosen
scores without the bias, normalised (``norm_topk_prob``) and multiplied by
``routed_scaling_factor``, each expert run over the tokens routed to it
(gathered), plus the shared experts as one MLP of ``n_shared_experts``
times the expert width. Final RMSNorm, the untied head, log-softmax.

Departures from modeling_deepseek, none of which changes the function:

* Rope rotates each interleaved pair (x[2i], x[2i+1]) by position times
  ``rope_theta ** (-2i / d)`` in place. modeling_deepseek first
  de-interleaves the pairs into halves and rotates halves; that permutes
  q's and k's rope dims alike, so every score is the same.
* Everything is float32 (the checkpoint's bfloat16 compute is the
  program's business); TF32 is off for matrix products and convolutions.
* Attention is computed one sequence at a time, the head a block of rows
  at a time, and a layer's weights are dropped before the next layer's are
  made, so the reference fits beside nothing on the card.
* The router's group-limited choice is left out: with ``n_group`` =
  ``topk_group`` = 1 it keeps every expert.

``mm`` is every matrix product it makes (the control passes one that
rounds both inputs to float8_e4m3 under a per-tensor scale).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

#: Rows of the head a block.
HEAD_ROWS = 4096


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: each input rounded to float8_e4m3 (max
    448) under one scale for the whole tensor, then multiplied in float32."""
    return torch.matmul(_fp8(a), _fp8(b))


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """x (..., S, d): each pair (x[2i], x[2i+1]) rotated by
    position * theta ** (-2i / d)."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                   device=x.device) / d)
    angle = positions.double()[:, None] * freq[None, :]
    cos, sin = angle.cos().float(), angle.sin().float()
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], -1).flatten(-2)


def _swiglu(x, gate, up, down, mm):
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def _attention(c, h, w, mm):
    """One sequence's MLA sublayer: h (S, D) -> its output (S, D); ``w``
    the layer's leaves by name."""
    H, eps = c["num_attention_heads"], c["rms_norm_eps"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, rank = c["v_head_dim"], c["kv_lora_rank"]
    S = h.shape[0]
    x = _norm(h, w("ln1"), eps)
    q = mm(x, w("wq")).view(S, H, nope + rope).transpose(0, 1)
    kv_a = mm(x, w("wkv_a"))
    latent = _norm(kv_a[:, :rank], w("kv_norm"), eps)
    kv = mm(latent, w("wkv_b")).view(S, H, nope + vd)
    kv = kv.transpose(0, 1)
    positions = torch.arange(S, device=h.device)
    q_pe = _rope(q[..., nope:], positions, c["rope_theta"])
    k_pe = _rope(kv_a[:, rank:], positions, c["rope_theta"])
    q = torch.cat([q[..., :nope], q_pe], -1)
    k = torch.cat([kv[..., :nope], k_pe.expand(H, S, rope)], -1)
    scores = mm(q, k.transpose(1, 2)) * (nope + rope) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = mm(p, kv[..., nope:]).transpose(0, 1).reshape(S, H * vd)
    return mm(out, w("wo"))


def _moe(c, x, w, mm):
    """The routed experts and the shared ones over tokens x (T, D)."""
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    logits = mm(x, w("router"))
    scores = torch.sigmoid(logits)
    chosen = torch.topk(scores + w("router_bias"), k, -1).indices
    weight = scores.gather(-1, chosen)
    if c["norm_topk_prob"] and k > 1:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * c["routed_scaling_factor"]
    gate, up, down = w("we_gate"), w("we_up"), w("we_down")
    y = torch.zeros_like(x)
    for e in range(E):
        token, slot = torch.nonzero(chosen == e, as_tuple=True)
        if len(token):
            out = _swiglu(x[token], gate[e], up[e], down[e], mm)
            y.index_add_(0, token, out * weight[token, slot, None])
    return y + _swiglu(x, w("ws_gate"), w("ws_up"), w("ws_down"), mm)


@torch.no_grad()
def next_token_logp(config, leaf: Callable[[str, Optional[int]],
                                           torch.Tensor],
                    tokens: torch.Tensor,
                    mm: Callable = matmul) -> torch.Tensor:
    """``(n, S - 1)`` float32 log P of each next token of the ``(n, S)``
    int64 ``tokens`` (on the device the reference runs on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = config
    eps, dense = c["rms_norm_eps"], c["first_k_dense_replace"]
    n, S = tokens.shape
    h = leaf("embed", None)[tokens]
    for layer in range(c["num_hidden_layers"]):
        stack, u = ("dense", layer) if layer < dense else ("moe",
                                                            layer - dense)
        made = {}

        def w(name):  # the layer's leaf, made once
            if name not in made:
                made[name] = leaf(f"{stack}/{name}", u)
            return made[name]

        h = h + torch.stack([_attention(c, h[i], w, mm) for i in range(n)])
        x = _norm(h, w("ln2"), eps).reshape(n * S, -1)
        if stack == "dense":
            y = _swiglu(x, w("w_gate"), w("w_up"), w("w_down"), mm)
        else:
            y = _moe(c, x, w, mm)
        h = h + y.view(n, S, -1)
        del made
    rows = _norm(h, leaf("ln_f", None), eps)[:, :-1].reshape(n * (S - 1), -1)
    targets = tokens[:, 1:].reshape(-1, 1)
    head = leaf("lm_head", None)[:, :c["vocab_size"]]
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=h.device)
    for lo in range(0, rows.shape[0], HEAD_ROWS):
        logits = mm(rows[lo:lo + HEAD_ROWS], head)
        out[lo:lo + HEAD_ROWS] = (logits.gather(1, targets[lo:lo + HEAD_ROWS])
                                  [:, 0] - torch.logsumexp(logits, -1))
    return out.view(n, S - 1)
