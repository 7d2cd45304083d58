"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Port of ``repro.configs.granite_moe_1b``."""
from repro_torch.configs.lm_common import SHAPES, build_lm_cell  # noqa: F401
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    rope_theta=10_000.0,
    moe=True, n_experts=32, top_k=8, d_ff_moe=512, moe_layer_step=1,
    microbatches=1,
)


def reduced() -> LMConfig:
    return LMConfig(name="granite-moe-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab=211, head_dim=16,
                    moe=True, n_experts=8, top_k=2, d_ff_moe=64,
                    moe_layer_step=1, attn_chunk=16)


def build_cell(shape: str, mesh):
    """The dry-run cell of :data:`FULL` at ``shape`` on ``mesh``."""
    return build_lm_cell(FULL, shape, mesh)
