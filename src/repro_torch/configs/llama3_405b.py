"""llama3-405b [dense] 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA 128k vocab [arXiv:2407.21783; unverified].

Port of ``repro.configs.llama3_405b``."""
import torch

from repro_torch.configs.lm_common import SHAPES, build_lm_cell  # noqa: F401
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, d_ff=53248, vocab=128256, head_dim=128,
    rope_theta=500_000.0,
    opt_dtype=torch.bfloat16,      # 405B AdamW moments in bf16
    grad_accum_dtype=torch.bfloat16,
    microbatches=16, scan_chunks=9, attn_chunk=512,
)


def reduced() -> LMConfig:
    return LMConfig(name="llama3-405b-smoke", n_layers=4, d_model=128,
                    n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
                    head_dim=16, attn_chunk=16, scan_chunks=2)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    return build_lm_cell(FULL, shape, mesh)
