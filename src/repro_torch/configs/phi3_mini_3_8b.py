"""phi3-mini-3.8b [dense] 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

Port of ``repro.configs.phi3_mini_3_8b``."""
from repro_torch.configs.lm_common import SHAPES, build_lm_cell  # noqa: F401
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96,
    rope_theta=10_000.0, microbatches=4, scan_chunks=4,
)


def reduced() -> LMConfig:
    return LMConfig(name="phi3-mini-smoke", n_layers=4, d_model=96,
                    n_heads=4, n_kv_heads=4, d_ff=192, vocab=307,
                    head_dim=24, attn_chunk=16)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    return build_lm_cell(FULL, shape, mesh)
