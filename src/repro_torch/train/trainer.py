"""Trainer: the paper's Listing-1 entry point, port of the single-device
path of ``repro.train.trainer``.

    trainer = Trainer(optimizer=adamw(0.003), epochs=50)
    history = trainer.train(model, train_loader, val_loader)
    results = trainer.test(model, test_loader)

Training runs through :class:`TrainEngine` in chunks of ``chunk_batches``
steps (on the card, one CUDA-graph replay per chunk), fed by the
overlapped :class:`DevicePrefetcher`; each chunk's ``(n,)`` loss tensor is
read one chunk behind, so the host waits on the device once per chunk and
never on the chunk it just queued. With ``sparse_tables=True`` the
embedding tables take sparse lazy AdamW (see :class:`TrainEngine`). Each
epoch is validated with the paper's click metrics (LL, perplexity,
conditional perplexity), in chunks of ``chunk_batches`` batches too: on
the card a captured loss-free body with the metric state as its carry,
cached for the last few models evaluated. Training stops after
``patience`` epochs without a val-loss improvement (paper §6).
Checkpoints, preemption, the watchdog, replica sweeps and profiling wait
for later slices.
"""
from __future__ import annotations

import collections
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.metrics import (ConditionalPerplexity, LogLikelihood,
                                      MultiMetric, Perplexity)
from repro_torch.data.loader import DevicePrefetcher
from repro_torch.train.capture import ChunkGraphs
from repro_torch.train.engine import TrainEngine

#: Models whose evaluation graphs a Trainer keeps (least recently used
#: first out), as the JAX Trainer bounds its cache of compiled eval steps.
#: The cache holds each model weakly: a model the caller drops frees its
#: parameters and its graphs.
EVAL_CACHE = 4


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


_STATE = "metric_state/"


def _flat(state) -> Dict[str, torch.Tensor]:
    """A MultiMetric state (name -> {"sum", "count"}) as one flat dict."""
    return {f"{_STATE}{name}/{k}": v for name, part in state.items()
            for k, v in part.items()}


def _nest(flat) -> Dict[str, Dict[str, torch.Tensor]]:
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, v in flat.items():
        if key.startswith(_STATE):
            name, k = key[len(_STATE):].rsplit("/", 1)
            state.setdefault(name, {})[k] = v
    return state


class _EvalStep:
    """One model's chunked evaluation: :meth:`loop` folds a stacked ``(n,
    B, K)`` chunk into the metric state batch by batch (the CPU's route);
    :meth:`replayed` is that loop captured per chunk signature, bound to
    the model's parameters, with the metric state as its carry (the card's
    route; JAX ``Trainer._make_eval_chunk_step``). It keeps no reference to
    the model (each call is given it), and its graphs none to it."""

    def __init__(self, metrics: MultiMetric):
        self.metrics = metrics
        self.graphs = ChunkGraphs(self._body)

    def loop(self, model, state, chunk):
        for i in range(next(iter(chunk.values())).shape[0]):
            batch = {k: v[i] for k, v in chunk.items()}
            state = self.metrics.update(
                state, log_probs=model.predict_clicks(batch),
                conditional_log_probs=model.predict_conditional_clicks(batch),
                clicks=batch["clicks"], where=batch["mask"])
        return state

    @staticmethod
    def _body(inputs, bound):
        step, model, _ = bound
        chunk = {k: v for k, v in inputs.items() if not k.startswith(_STATE)}
        return _flat(step.loop(model, _nest(inputs), chunk))

    def replayed(self, model, state, chunk):
        return _nest(self.graphs({**chunk, **_flat(state)},
                                 (self, model, list(model.parameters()))))


def default_metrics() -> MultiMetric:
    return MultiMetric({
        "ll": LogLikelihood(),
        "ppl": Perplexity(),
        "cond_ppl": ConditionalPerplexity(),
    })


class Trainer:
    def __init__(self, optimizer, epochs: int = 100, patience: int = 1,
                 chunk_batches: int = 1, device="cuda",
                 sparse_tables: bool = False,
                 sparse_table_kwargs: Optional[Dict[str, Any]] = None,
                 metrics_factory: Callable[[], MultiMetric] = default_metrics,
                 log_fn: Callable[[str], None] = print):
        self.optimizer = optimizer
        self.sparse_tables = sparse_tables
        self.sparse_table_kwargs = sparse_table_kwargs
        self.epochs = epochs
        self.patience = patience
        self.chunk_batches = chunk_batches
        self.device = torch.device(device)
        self.metrics_factory = metrics_factory
        self.log_fn = log_fn
        # id(model) -> (weak reference to the model, its _EvalStep)
        self._eval_cache: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()

    def _check_device(self, model) -> None:
        where = {p.device.type for p in model.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"model parameters on {sorted(where)}, trainer "
                             f"runs on {self.device}")

    def train(self, model, train_loader, val_loader=None
              ) -> List[Dict[str, float]]:
        self._check_device(model)
        engine = TrainEngine(model, self.optimizer,
                             chunk_batches=self.chunk_batches,
                             sparse_tables=self.sparse_tables,
                             sparse_table_kwargs=self.sparse_table_kwargs)
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

    def _eval_step(self, model) -> "_EvalStep":
        """The cached :class:`_EvalStep` of ``model``; the entry goes when
        the model is collected."""
        cache, key = self._eval_cache, id(model)
        entry = cache.get(key)
        if entry is not None and entry[0]() is model:
            cache.move_to_end(key)
            return entry[1]
        cache.pop(key, None)
        while len(cache) >= EVAL_CACHE:
            cache.popitem(last=False)

        # weakly: the cache holds forget, so a strong reference would be
        # a cycle, kept until the collector runs
        held = weakref.ref(cache)

        def forget(ref):
            live = held()
            if live is not None and key in live and live[key][0] is ref:
                del live[key]

        step = _EvalStep(self.metrics_factory())
        cache[key] = (weakref.ref(model, forget), step)
        return step

    @torch.no_grad()
    def evaluate(self, model, loader, per_rank: bool = False):
        """Stream ``loader`` through the click metrics in chunks of
        ``chunk_batches`` batches, each chunk one graph replay on the card;
        the metric state stays on the device and is read once at the end."""
        self._check_device(model)
        step = self._eval_step(model)
        update = step.replayed if self.device.type == "cuda" else step.loop
        metrics, state = step.metrics, None
        for chunk, _, _ in DevicePrefetcher(loader, device=self.device,
                                            chunk_batches=self.chunk_batches):
            if state is None:
                state = metrics.init_state(chunk["positions"].shape[2],
                                           self.device)
            state = update(model, state, chunk)
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
