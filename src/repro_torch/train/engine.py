"""Single-device training engine: chunked steps with device-resident losses.

Port of the single-device core of ``repro.train.engine.TrainEngine``.
``DevicePrefetcher(chunk_batches=N)`` stacks N host batches into one
``(N, B, ...)`` device tensor per key; :meth:`TrainEngine.step` runs the N
optimizer steps over it as a Python loop (the JAX version's ``lax.scan``)
and returns the per-step losses as one ``(N,)`` tensor that stays on the
device until the caller drains it. The loop body is :meth:`_one_step`, so a
chunk of N gives bit-for-bit the same parameters and losses as N chunks of
one. Parameters live in the model and are updated in place; replicas, the
mesh, sparse tables, the non-finite guard and telemetry wait for later
slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import optim as optim_lib


class TrainEngine:
    """Usage (what ``Trainer.train`` does)::

        engine = TrainEngine(model, optimizer, chunk_batches=4)
        opt_state = engine.init_opt_state()
        for chunk, loader_state, n in DevicePrefetcher(
                loader, chunk_batches=engine.chunk_batches, device=device):
            opt_state, losses = engine.step(opt_state, chunk)
            # losses: (n,) device tensor; read it one chunk behind
    """

    def __init__(self, model, optimizer, *, chunk_batches: int = 1):
        if chunk_batches < 1:
            raise ValueError(f"chunk_batches must be >= 1, got {chunk_batches}")
        self.model = model
        self.optimizer = optimizer
        self.chunk_batches = int(chunk_batches)
        self.params = list(model.parameters())

    def init_opt_state(self):
        return self.optimizer.init(self.params)

    def _one_step(self, opt_state, batch: Dict[str, torch.Tensor]):
        """One optimizer step; returns the new state and the detached loss."""
        for p in self.params:
            p.grad = None
        loss = self.model.compute_loss(batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        updates, opt_state = self.optimizer.update(grads, opt_state,
                                                   self.params)
        optim_lib.apply_updates(self.params, updates)
        for p in self.params:
            p.grad = None
        return opt_state, loss.detach()

    def step(self, opt_state, chunk: Dict[str, torch.Tensor]) -> Any:
        """``n = chunk[k].shape[0]`` optimizer steps, one per stacked batch.
        Returns the new optimizer state and the ``(n,)`` loss tensor."""
        n = next(iter(chunk.values())).shape[0]
        losses = []
        for i in range(n):
            opt_state, loss = self._one_step(
                opt_state, {k: v[i] for k, v in chunk.items()})
            losses.append(loss)
        return opt_state, torch.stack(losses)
