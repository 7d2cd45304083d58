"""Trainer: the paper's Listing-1 entry point, port of the single-device
path of ``repro.train.trainer``.

    trainer = Trainer(optimizer=adamw(0.003), epochs=50)
    history = trainer.train(model, train_loader, val_loader)
    results = trainer.test(model, test_loader)

Training runs through :class:`TrainEngine` in chunks of ``chunk_batches``
steps; each chunk's ``(n,)`` loss tensor is read one chunk behind, so the
host waits on the device once per chunk and never on the chunk it just
queued. Each epoch is validated with the paper's click metrics (LL,
perplexity, conditional perplexity) and training stops after ``patience``
epochs without a val-loss improvement (paper §6). Checkpoints, preemption,
the watchdog, replica sweeps and profiling wait for later slices.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from repro_torch.core.metrics import (ConditionalPerplexity, LogLikelihood,
                                      MultiMetric, Perplexity)
from repro_torch.data.loader import DevicePrefetcher
from repro_torch.train.engine import TrainEngine


def _stage(losses: torch.Tensor):
    """Start moving a chunk's ``(n,)`` losses to the host, right after the
    chunk is queued. On CUDA the copy goes to pinned memory without
    blocking, and an event marks the end of this chunk's work: reading a
    CUDA tensor directly (``.tolist()``) would wait for everything queued
    on the stream, the next chunk included."""
    if losses.device.type != "cuda":
        return losses, None
    host = torch.empty(losses.shape, dtype=losses.dtype, pin_memory=True)
    host.copy_(losses, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _read(staged) -> List[float]:
    """The staged losses as floats; waits for their chunk only."""
    host, done = staged
    if done is not None:
        done.synchronize()
    return host.tolist()


def default_metrics() -> MultiMetric:
    return MultiMetric({
        "ll": LogLikelihood(),
        "ppl": Perplexity(),
        "cond_ppl": ConditionalPerplexity(),
    })


class Trainer:
    def __init__(self, optimizer, epochs: int = 100, patience: int = 1,
                 chunk_batches: int = 1, device="cuda",
                 metrics_factory: Callable[[], MultiMetric] = default_metrics,
                 log_fn: Callable[[str], None] = print):
        self.optimizer = optimizer
        self.epochs = epochs
        self.patience = patience
        self.chunk_batches = chunk_batches
        self.device = torch.device(device)
        self.metrics_factory = metrics_factory
        self.log_fn = log_fn

    def _check_device(self, model) -> None:
        where = {p.device.type for p in model.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"model parameters on {sorted(where)}, trainer "
                             f"runs on {self.device}")

    def train(self, model, train_loader, val_loader=None
              ) -> List[Dict[str, float]]:
        self._check_device(model)
        engine = TrainEngine(model, self.optimizer,
                             chunk_batches=self.chunk_batches)
        opt_state = engine.init_opt_state()
        history: List[Dict[str, float]] = []
        best_val, bad_epochs = float("inf"), 0
        for epoch in range(1, self.epochs + 1):
            t0 = time.perf_counter()
            loss_sum, n_batches = 0.0, 0
            pending = None  # the previous chunk's staged losses
            for chunk, _, _ in DevicePrefetcher(
                    train_loader, device=self.device,
                    chunk_batches=engine.chunk_batches):
                opt_state, losses = engine.step(opt_state, chunk)
                staged = _stage(losses)
                if pending is not None:
                    # Reading the previous chunk's losses waits only for it;
                    # the chunk just queued keeps the device busy meanwhile.
                    for loss in _read(pending):
                        loss_sum += loss
                        n_batches += 1
                pending = staged
            if pending is not None:
                for loss in _read(pending):
                    loss_sum += loss
                    n_batches += 1
            record = {"epoch": epoch,
                      "train_loss": loss_sum / max(n_batches, 1),
                      "seconds": time.perf_counter() - t0}
            stop = False
            if val_loader is not None:
                val = self.evaluate(model, val_loader)
                record.update({f"val_{k}": v for k, v in val.items()})
                val_loss = -val["ll"]
                if val_loss < best_val - 1e-6:
                    best_val, bad_epochs = val_loss, 0
                else:
                    bad_epochs += 1
                stop = bad_epochs >= self.patience
            history.append(record)
            self.log_fn(f"[trainer] {record}")
            if stop:
                self.log_fn(f"[trainer] early stop at epoch {epoch}")
                break
        return history

    @torch.no_grad()
    def evaluate(self, model, loader, per_rank: bool = False):
        """Stream ``loader`` through the click metrics; the metric state
        stays on the device and is read once at the end."""
        self._check_device(model)
        metrics = self.metrics_factory()
        state = None
        for batch, _ in DevicePrefetcher(loader, device=self.device):
            if state is None:
                state = metrics.init_state(batch["positions"].shape[1],
                                           self.device)
            state = metrics.update(
                state, log_probs=model.predict_clicks(batch),
                conditional_log_probs=model.predict_conditional_clicks(batch),
                clicks=batch["clicks"], where=batch["mask"])
        if state is None:
            raise ValueError(
                "evaluation loader produced no batches — dataset smaller than "
                "batch_size with drop_last=True? Pass drop_last=False.")
        finals = metrics.compute(state)
        names = list(finals)
        values = torch.stack([finals[k] for k in names]).tolist()
        out = dict(zip(names, values))
        if per_rank:
            per = metrics.compute_per_rank(state)
            out["per_rank"] = {k: v.tolist() for k, v in per.items()}
        return out

    def test(self, model, test_loader, per_rank: bool = True):
        """Evaluate the model's current parameters on the test split."""
        return self.evaluate(model, test_loader, per_rank=per_rank)
