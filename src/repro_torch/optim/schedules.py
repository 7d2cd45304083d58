"""Learning-rate schedules (step count -> lr), port of
``repro.optim.schedules``. A schedule takes the int32 0-d step count and
returns a float32 0-d tensor on its device."""
from __future__ import annotations

import math

import torch


def constant_schedule(value: float):
    def schedule(count):
        return torch.full((), value, dtype=torch.float32, device=count.device)

    return schedule


def linear_decay(init_value: float, end_value: float, decay_steps: int):
    def schedule(count):
        frac = torch.clip(count.float() / decay_steps, 0.0, 1.0)
        return init_value + (end_value - init_value) * frac

    return schedule


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    def schedule(count):
        frac = torch.clip(count.float() / decay_steps, 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine(peak_value: float, warmup_steps: int, decay_steps: int,
                  end_value: float = 0.0):
    def schedule(count):
        count = count.float()
        warm = peak_value * count / max(warmup_steps, 1)
        frac = torch.clip((count - warmup_steps)
                          / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cosine = end_value + (peak_value - end_value) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(count < warmup_steps, warm, cosine)

    return schedule
