"""Decoder-only LM family: dense (llama3/phi3) and MoE (granite/llama4),
single-device forms (port of ``repro.models.lm``; ``param_specs`` and
``cache_specs`` wait for the distributed slice)."""
from repro_torch.models.lm.transformer import (
    LMConfig,
    init_params,
    forward,
    lm_loss,
    make_train_step,
    make_prefill_step,
    make_decode_step,
    init_cache,
)

__all__ = [
    "LMConfig",
    "init_params",
    "forward",
    "lm_loss",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "init_cache",
]
