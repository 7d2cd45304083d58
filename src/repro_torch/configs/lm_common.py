"""The LM-family architectures' shapes and smoke batch (port of
``repro.configs.lm_common``; ``build_lm_cell`` waits with the dry run).

Shapes (assigned set):
  train_4k     seq 4096,   global_batch 256  -> train_step (AdamW, microbatched)
  prefill_32k  seq 32768,  global_batch 32   -> prefill (logits + KV cache out)
  decode_32k   seq 32768,  global_batch 128  -> serve_step (1 new token vs cache)
  long_500k    seq 524288, global_batch 1    -> serve_step
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.lm import LMConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def lm_smoke_batch(cfg: LMConfig, batch: int = 2, seq: int = 16,
                   gen: Optional[torch.Generator] = None, device="cuda"):
    """Random tokens in [0, vocab), the targets equal to the tokens (JAX's
    smoke batch, drawn from ``gen``, default seeded with 0)."""
    if gen is None:
        gen = torch.Generator(device=torch.device(device)).manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                        device=device, dtype=torch.int32)
    return {"tokens": tok, "targets": tok}
