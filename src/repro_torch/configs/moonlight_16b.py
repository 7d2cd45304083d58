"""Moonlight-16B-A3B [moe, mla] 27L d_model=2048 16H, MLA (no q LoRA,
kv_lora_rank 512, nope / rope / v head dims 128 / 64 / 128), layer 0 dense
(d_ff 11264), 26 MoE layers of 64 routed experts (width 1408, top-6,
sigmoid scores with a float32 choice bias, weights normalised then scaled
by 2.446) and 2 shared experts, vocab 163840 untied, rope theta 50000,
RMSNorm eps 1e-5 [hf:moonshotai/Moonlight-16B-A3B config.json,
model_type deepseek_v3]. 15.96B parameters: 31.9 GB in bfloat16, whole on
one H100.

The port runs it on its normal LM path (``models/lm/transformer.py``):
MLA attention, the sigmoid router, the leading dense stack and the
dispatched MoE over grouped GEMMs. Single device only: its KV cache,
prefill, decode and mesh forms raise. :func:`make_model` is the
benchmark's builder; :func:`repro_torch.configs.lm_common.score_bulk` scores
a batch of sequences on it.
"""
import dataclasses

import torch

from repro_torch.models.lm import LMConfig
from repro_torch.models.lm import transformer as tf

FULL = LMConfig(
    name="moonlight-16b-a3b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=11264, vocab=163840, head_dim=192,
    rope_theta=50_000.0,
    moe=True, n_experts=64, top_k=6, d_ff_moe=1408, moe_layer_step=1,
    n_shared_experts=2, remat=False,
    attention="mla", kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
    router="sigmoid", routed_scaling_factor=2.446,
    first_k_dense=1, norm_eps=1e-5, moe_impl="dispatched",
)


def reduced() -> LMConfig:
    """1 dense and 2 MoE layers at width 64: 4 heads, latent 32, nope /
    rope / v 16 / 8 / 16, 8 experts with top-2 and 2 shared, vocab 256;
    q blocks of 8 so a 16-token row takes two. It computes in float32
    over its bfloat16 leaves (the float32 choice bias beside them), so
    that a CPU test's gap to a float32 reference is the path's and not
    bfloat16's."""
    return dataclasses.replace(
        FULL, name="moonlight-smoke", dtype=torch.float32, n_layers=3,
        d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, head_dim=24, n_experts=8,
        top_k=2, d_ff_moe=32, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, attn_chunk=8)


def _build(cfg: LMConfig, device):
    model = tf.init_params(cfg, device=device, draw=False)
    model.lm_config = cfg
    return model


def make_model(kind: str = "lm", device="cuda"):
    """:data:`FULL`'s leaves allocated on ``device`` and left unwritten
    (whoever builds it writes every leaf), the config on ``lm_config``."""
    return _build(FULL, device)


def make_reduced(kind: str = "lm", device="cpu"):
    """:func:`reduced`'s leaves, as :func:`make_model` makes them."""
    return _build(reduced(), device)
