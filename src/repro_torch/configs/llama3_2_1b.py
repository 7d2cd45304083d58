"""llama3.2-1b [dense] 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

Port of ``repro.configs.llama3_2_1b``."""
from repro_torch.configs.lm_common import SHAPES, build_lm_cell  # noqa: F401
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
    n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=64,
    rope_theta=500_000.0, microbatches=2,
)


def reduced() -> LMConfig:
    return LMConfig(name="llama3.2-1b-smoke", n_layers=3, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=256, vocab=499,
                    head_dim=16, attn_chunk=16)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    return build_lm_cell(FULL, shape, mesh)
