"""Decoder-only LM family: dense (llama3/phi3) and MoE (granite/llama4),
port of ``repro.models.lm``: the single-device forms, and with ``mesh=``
the sharded ones (``param_specs``, ``cache_specs``; see
:mod:`repro_torch.models.lm.sharded`)."""
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
from repro_torch.models.lm.sharded import (
    param_specs,
    cache_specs,
    place_params,
    gather_params,
)

__all__ = [
    "LMConfig",
    "init_params",
    "param_specs",
    "cache_specs",
    "place_params",
    "gather_params",
    "forward",
    "lm_loss",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "init_cache",
]
