"""The yardstick's arithmetic of a language model's scoring call, counted
from the configuration's own numbers (its published keys), and the least
time one H100 could take for it.

Frozen with the benchmark, as ``cost.py`` is: the program may change its
own arithmetic, this stays. Matrix products count 2 operations a
multiply-add; elementwise work (norms, rope, softmax, SiLU, the combine)
is left out. Every weight byte is counted once a call, and the tokens in
and the answer out once.
"""
from __future__ import annotations

from typing import List

from yardstick.cost import PEAK_BYTES_PER_S, Cost

#: NVIDIA H100 SXM data sheet: dense bfloat16 on the tensor cores, at the
#: card's full power limit of 700 W.
PEAK_BF16_PER_S = 989e12


def bound_s(cost: Cost) -> float:
    """The least seconds one H100 takes for ``cost``: the larger of its
    bytes over the memory rate and its operations over the bf16 rate."""
    return max(cost.bytes / PEAK_BYTES_PER_S, cost.flops / PEAK_BF16_PER_S)


def _sizes(c):
    D, H = c["hidden_size"], c["num_attention_heads"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, rank = c["v_head_dim"], c["kv_lora_rank"]
    return D, H, nope, rope, vd, rank


def attention_params(c) -> int:
    """One MLA layer's projection weights (no q LoRA)."""
    D, H, nope, rope, vd, rank = _sizes(c)
    return (D * H * (nope + rope) + D * (rank + rope)
            + rank * H * (nope + vd) + H * vd * D)


def params(c) -> int:
    """Every parameter of the model."""
    D, E = c["hidden_size"], c["n_routed_experts"]
    F, Fm = c["intermediate_size"], c["moe_intermediate_size"]
    L, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    moe = L - dense
    per_layer = attention_params(c) + _sizes(c)[5] + 2 * D
    return (2 * c["vocab_size"] * D + D + L * per_layer
            + dense * 3 * D * F
            + moe * (3 * D * Fm * (E + c["n_shared_experts"]) + D * E + E))


def score_call(c, batch: int, seq: int) -> Cost:
    """One scoring call of ``batch`` sequences of ``seq`` tokens: every
    token through every layer (the causal attention's scores over the
    positions at or before each query), the head over the ``seq - 1``
    scored positions of each; all the weights read once (bfloat16, the
    choice bias float32), int32 tokens in, float32 log Ps out."""
    D, H, nope, rope, vd, rank = _sizes(c)
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    F, Fm = c["intermediate_size"], c["moe_intermediate_size"]
    L, dense = c["num_hidden_layers"], c["first_k_dense_replace"]
    moe = L - dense
    tokens = batch * seq
    pairs = batch * seq * (seq + 1) // 2  # (query, key) pairs, causal
    flops = L * (2 * tokens * attention_params(c)
                 + 2 * pairs * H * (nope + rope + vd))
    flops += dense * 2 * tokens * 3 * D * F
    flops += moe * 2 * tokens * (D * E + 3 * D * Fm
                                 * (k + c["n_shared_experts"]))
    flops += 2 * batch * (seq - 1) * D * c["vocab_size"]
    weight_bytes = 2 * params(c) + 2 * moe * E  # the float32 bias
    return Cost(flops, weight_bytes + 4 * tokens + 4 * batch * (seq - 1))


def grouped_mm(c, tokens: int) -> List[Cost]:
    """The grouped products of one call over ``tokens`` tokens, three a MoE
    layer: the gate, the up and the down projection of the ``tokens x
    top_k`` routed rows; each reads every expert's weights and its rows
    once and writes its rows once (bfloat16)."""
    D, E, k = c["hidden_size"], c["n_routed_experts"], c["num_experts_per_tok"]
    Fm = c["moe_intermediate_size"]
    M = tokens * k
    up = Cost(2 * M * D * Fm, 2 * (E * D * Fm + M * D + M * Fm))
    down = Cost(2 * M * Fm * D, 2 * (E * Fm * D + M * Fm + M * D))
    moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return [up, up, down] * moe
