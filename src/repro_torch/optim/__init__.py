"""Optimizers (port of ``repro.optim``): the optax-style transformations,
their schedules, the fused training-step entry point :func:`step`, and
sparse lazy AdamW for embedding tables (:mod:`repro_torch.optim.sparse`)."""
from repro_torch.optim.optimizers import (GradientTransformation,
                                          InjectLRState, ScaleByAdamState,
                                          accumulate_gradients,
                                          add_decayed_weights, adagrad, adam,
                                          adamw, apply_updates, chain,
                                          clip_by_global_norm,
                                          get_injected_lr, global_norm,
                                          inject_lr, scale, scale_by_adam,
                                          scale_by_schedule, set_injected_lr,
                                          sgd, step)
from repro_torch.optim.schedules import (constant_schedule, cosine_decay,
                                         linear_decay, warmup_cosine)

__all__ = [
    "GradientTransformation", "InjectLRState", "ScaleByAdamState",
    "accumulate_gradients", "add_decayed_weights", "adagrad", "adam",
    "adamw", "apply_updates", "chain", "clip_by_global_norm",
    "constant_schedule", "cosine_decay", "get_injected_lr", "global_norm",
    "inject_lr", "linear_decay", "scale", "scale_by_adam",
    "scale_by_schedule", "set_injected_lr", "sgd", "step", "warmup_cosine",
]
