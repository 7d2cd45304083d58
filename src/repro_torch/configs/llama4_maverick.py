"""llama4-maverick-400b-a17b [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1, interleaved (every 2nd layer) + shared expert —
MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

The early-fusion modality frontend is a stub per the brief: input_specs
provide token ids for the backbone.


Port of ``repro.configs.llama4_maverick``."""
import torch

from repro_torch.configs.lm_common import SHAPES, build_lm_cell  # noqa: F401
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    rope_theta=500_000.0,
    moe=True, n_experts=128, top_k=1, d_ff_moe=8192, moe_layer_step=2,
    n_shared_experts=1,
    opt_dtype=torch.bfloat16, grad_accum_dtype=torch.bfloat16,
    microbatches=8, scan_chunks=4, attn_chunk=512,
)


def reduced() -> LMConfig:
    return LMConfig(name="llama4-maverick-smoke", n_layers=4, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                    moe=True, n_experts=8, top_k=1, d_ff_moe=128,
                    moe_layer_step=2, n_shared_experts=1, attn_chunk=16)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    return build_lm_cell(FULL, shape, mesh)
