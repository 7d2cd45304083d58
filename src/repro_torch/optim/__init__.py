"""Optimizers (port of the AdamW path of ``repro.optim``)."""
from repro_torch.optim.optimizers import (GradientTransformation,
                                          ScaleByAdamState,
                                          add_decayed_weights, adamw,
                                          apply_updates, chain, global_norm,
                                          scale, scale_by_adam)

__all__ = [
    "GradientTransformation", "ScaleByAdamState", "add_decayed_weights",
    "adamw", "apply_updates", "chain", "global_norm", "scale",
    "scale_by_adam",
]
