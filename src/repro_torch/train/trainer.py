"""Trainer: the paper's Listing-1 entry point, port of
``repro.train.trainer``.

    trainer = Trainer(optimizer=adamw(0.003), epochs=50)
    history = trainer.train(model, train_loader, val_loader)
    results = trainer.test(model, test_loader)

Training runs through :class:`TrainEngine` in chunks of ``chunk_batches``
steps (on the card, one CUDA-graph replay per chunk), fed by the
overlapped :class:`DevicePrefetcher`; each chunk's losses are read one
chunk behind, so the host waits on the device once per chunk and never on
the chunk it just queued. With ``sparse_tables=True`` the embedding tables
take sparse lazy AdamW (see :class:`TrainEngine`). Each epoch is validated
with the paper's click metrics (LL, perplexity, conditional perplexity), in
chunks of ``chunk_batches`` batches too: on the card a captured loss-free
body with the metric state as its carry, cached for the last few models
evaluated. Training stops after ``patience`` epochs without a val-loss
improvement (paper §6).

The run contract of a long run:

* **Checkpoints** (``checkpoint_dir``): atomic saves every
  ``checkpoint_every_steps`` steps (at chunk granularity), at every
  epoch's end and on preemption, ``keep_checkpoints`` kept. A checkpoint
  holds the parameters, the optimizer state, the loader's resume point
  after the last chunk consumed, the early-stop state, the epoch's running
  loss accumulators and the history, so ``train(..., resume=True)`` is
  bit-exact, mid-epoch too. Restoring writes into the live tensors, so no
  graph replays against freed state.
* **Preemption** (``handle_preemption``): SIGTERM/SIGINT end the run after
  the chunk in flight, with a final checkpoint.
* **Non-finite guard** (``nonfinite_guard``): a step with a non-finite loss
  or gradient is skipped on the device; the epoch mean leaves it out and
  the record counts it (``skipped_steps``).
* **Watchdog** (``step_budget_seconds``): chunks slower than the budget
  per step are counted (``watchdog_violations``) and logged.
* **Sweeps** (``replicas=R``): R independent runs in one engine, replica i
  seeded ``replica_seeds[i]`` (default ``seed + i``) and trained at
  ``replica_lrs[i]`` (an ``inject_lr=True`` optimizer). Validation gives
  each metric as an R-list, early stopping is tracked per replica (a
  finished replica freezes in place through the engine's active mask while
  the others train on), records carry per-replica lists, and checkpoints
  hold the R-stacked trees (``select_replica`` extracts any run).
* **Meshes** (``mesh``, one process per rank, see
  :mod:`repro_torch.launch.mesh`): the engine places the model on the
  mesh and each rank trains on its rows of every global batch (the batch
  size must divide by the data-parallel size, and ``drop_last=False`` is
  refused, as in JAX). Validation runs each rank on its rows; a batch the
  data axes do not divide (the ``drop_last=False`` tail) goes whole to
  data rank 0, and the metric sums are all-reduced over ``data`` once at
  the end. Every host decision (early stopping from the reduced metrics,
  checkpoint steps, the preemption flag, reduced with a max over the
  world's gloo group) is the same on every rank; only rank 0 logs, writes
  checkpoints (the row shards gathered to it) and profiles. A checkpoint
  holds full tensors, so one written by a world of N restores onto a world
  of M, each leaf cut to its rank's block (elastic restore).

Observability (:mod:`repro_torch.obs`): the epoch's losses go through one
:class:`~repro_torch.obs.TelemetryDrain`, fed each chunk's staged payload
one chunk behind, which also emits a ``metric`` event per step
(``obs_every`` thins them) with the engine's on-device series when
``telemetry=True`` (grad and parameter norms, the injected lr). The epoch,
each validation and each checkpoint are spans; every epoch ends with an
``epoch`` event, a counters snapshot and the process's memory (host RSS
and the card's). ``profile_steps="A:B"`` opens a ``torch.profiler`` window
into ``profile_dir`` around the chunks covering those global steps.
``emit_roofline=True`` emits the first chunk's per-device cost once, in a
``roofline`` span, as a ``roofline`` event (:meth:`TrainEngine.roofline`:
a fake run of the eager route, which changes and launches nothing). Events
go to ``recorder``, else to the process-global one. Leaving an epoch by any
path (its end, preemption, an exception) closes the prefetcher's iteration,
which stops and joins its staging thread and, through it, the loader's
iteration (a streaming loader's read-ahead producer).

A single run trains the model's own parameters (the model was built with
its own seed); ``TrainState.params`` is their JAX-shaped tree.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.metrics import (ConditionalPerplexity, LogLikelihood,
                                      MultiMetric, Perplexity)
from repro_torch.data.loader import DevicePrefetcher
from repro_torch.obs import (ProfileWindow, TelemetryDrain, get_recorder,
                             make_event, parse_profile_steps)
from repro_torch.obs.telemetry import stage
from repro_torch.train.capture import ChunkGraphs
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.convert import param_path
from repro_torch.train.engine import TrainEngine, call_with
from repro_torch.train.fault_tolerance import PreemptionHandler, StepWatchdog
from repro_torch.tree import (flatten_with_paths, nest, tree_copy_,
                              tree_leaves, unnest)

#: Models whose evaluation graphs a Trainer keeps (least recently used
#: first out), as the JAX Trainer bounds its cache of compiled eval steps.
#: The cache holds each model weakly: a model the caller drops frees its
#: parameters and its graphs.
EVAL_CACHE = 4


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    epoch: int = 0
    global_step: int = 0


_STATE = "metric_state/"


def _flat(state) -> Dict[str, torch.Tensor]:
    """A MultiMetric state (name -> {"sum", "count"}), or a list of them
    (one per run), as one flat dict keyed by path."""
    return {_STATE + path: v for path, v in flatten_with_paths(state)}


def _nest(flat):
    """The inverse of :func:`_flat` (the keys of ``flat`` that hold no
    metric state are left out)."""
    items = [(k[len(_STATE):].split("/"), v) for k, v in flat.items()
             if k.startswith(_STATE)]
    tree = nest([path for path, _ in items], [v for _, v in items])
    if all(k.isdigit() for k in tree):  # one state per run
        return [tree[str(j)] for j in range(len(tree))]
    return tree


class _EvalStep:
    """One model's chunked evaluation: :meth:`loop` folds a stacked ``(n,
    B, K)`` chunk into the metric state batch by batch (the CPU's route);
    :meth:`replayed` is that loop captured per chunk signature, bound to
    the parameters it reads, with the metric state as its carry (the card's
    route; JAX ``Trainer._make_eval_chunk_step``). ``runs`` is None (one
    state, the model's own parameters) or a list of parameter lists, one
    per run, aligned with ``model.named_parameters()`` (a list of states,
    one per run: the sweep's replicas, or an explicit tree). It keeps no
    reference to the model (each call is given it), and its graphs none to
    it."""

    def __init__(self, metrics: MultiMetric):
        self.metrics = metrics
        self.graphs = ChunkGraphs(self._body)

    def loop(self, model, state, chunk, runs=None):
        single = runs is None
        states = [state] if single else list(state)
        names = None if single else [n for n, _ in model.named_parameters()]
        for i in range(next(iter(chunk.values())).shape[0]):
            batch = {k: v[i] for k, v in chunk.items()}
            for j, tensors in enumerate([None] if single else runs):
                states[j] = self.metrics.update(
                    states[j],
                    log_probs=call_with(model, names, tensors,
                                        "predict_clicks", batch),
                    conditional_log_probs=call_with(
                        model, names, tensors, "predict_conditional_clicks",
                        batch),
                    clicks=batch["clicks"], where=batch["mask"])
        return states[0] if single else states

    @staticmethod
    def _body(inputs, bound):
        step, model, runs, _ = bound
        chunk = {k: v for k, v in inputs.items() if not k.startswith(_STATE)}
        return _flat(step.loop(model, _nest(inputs), chunk, runs))

    def replayed(self, model, state, chunk, runs=None):
        tensors = (list(model.parameters()) if runs is None
                   else [t for run in runs for t in run])
        return _nest(self.graphs({**chunk, **_flat(state)},
                                 (self, model, runs, tensors)))


def default_metrics() -> MultiMetric:
    return MultiMetric({
        "ll": LogLikelihood(),
        "ppl": Perplexity(),
        "cond_ppl": ConditionalPerplexity(),
    })


class Trainer:
    def __init__(self, optimizer, epochs: int = 100, patience: int = 1,
                 seed: int = 0, checkpoint_dir: Optional[str] = None,
                 checkpoint_every_steps: Optional[int] = None,
                 keep_checkpoints: int = 3,
                 metrics_factory: Callable[[], MultiMetric] = default_metrics,
                 log_fn: Callable[[str], None] = print,
                 handle_preemption: bool = False,
                 chunk_batches: int = 1, device="cuda",
                 sparse_tables: bool = False,
                 sparse_table_kwargs: Optional[Dict[str, Any]] = None,
                 replicas: Optional[int] = None,
                 replica_lrs: Optional[List[float]] = None,
                 replica_seeds: Optional[List[int]] = None,
                 nonfinite_guard: bool = False,
                 step_budget_seconds: Optional[float] = None,
                 telemetry: bool = False, recorder=None, obs_every: int = 1,
                 profile_steps=None, profile_dir: Optional[str] = None,
                 mesh=None, emit_roofline: bool = False):
        self.optimizer = optimizer
        self.mesh = mesh
        # only rank 0 of a mesh logs, writes checkpoints and profiles
        self.lead = mesh is None or dist.get_rank() == 0
        if not self.lead:
            log_fn = _silent
        self.epochs = epochs
        self.patience = patience
        self.seed = seed
        self.metrics_factory = metrics_factory
        self.log_fn = log_fn
        self.checkpoint_every_steps = checkpoint_every_steps
        self.ckpt = (CheckpointManager(checkpoint_dir, keep=keep_checkpoints,
                                       log_fn=log_fn)
                     if checkpoint_dir else None)
        self.handle_preemption = handle_preemption
        self.nonfinite_guard = nonfinite_guard
        self.step_budget_seconds = step_budget_seconds
        # Observability (see repro_torch.obs): `telemetry` turns on the
        # engine's on-device per-step series; `recorder` pins a Recorder
        # (default: the process-global one, resolved at use so a later
        # obs.configure() still takes effect); `obs_every` thins per-step
        # metric events; `profile_steps` ("A:B") opens a torch.profiler
        # window into `profile_dir` around those global steps.
        self.telemetry = bool(telemetry)
        self.recorder = recorder
        self.obs_every = int(obs_every)
        self.profile_steps = (parse_profile_steps(profile_steps)
                              if isinstance(profile_steps, str)
                              else profile_steps)
        self.profile_dir = profile_dir
        # `emit_roofline` emits the chunk step's per-device cost once, as a
        # `roofline` event (TrainEngine.roofline: a fake run, no kernel).
        self.emit_roofline = bool(emit_roofline)
        self.chunk_batches = chunk_batches
        self.device = torch.device(device)
        self.sparse_tables = sparse_tables
        self.sparse_table_kwargs = sparse_table_kwargs
        if replicas is None and (replica_lrs is not None
                                 or replica_seeds is not None):
            raise ValueError("replica_lrs/replica_seeds require replicas=R")
        for name, knob in (("replica_lrs", replica_lrs),
                           ("replica_seeds", replica_seeds)):
            if knob is not None and len(knob) != replicas:
                raise ValueError(f"{name} has {len(knob)} entries for "
                                 f"replicas={replicas}")
        self.replicas = replicas
        self.replica_lrs = replica_lrs
        self.replica_seeds = replica_seeds
        # id(model) -> (weak reference to the model, its _EvalStep)
        self._eval_cache: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()

    def _rec(self):
        """The recorder events go to: the pinned one, else the global."""
        return self.recorder if self.recorder is not None else get_recorder()

    def _check_device(self, model) -> None:
        where = {p.device.type for p in model.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"model parameters on {sorted(where)}, trainer "
                             f"runs on {self.device}")
        if self.mesh is not None and self.mesh.device_type != \
                self.device.type:
            raise ValueError(f"a {self.mesh.device_type} mesh for a trainer "
                             f"on {self.device}")

    def _make_engine(self, model) -> TrainEngine:
        return TrainEngine(model, self.optimizer,
                           chunk_batches=self.chunk_batches, mesh=self.mesh,
                           sparse_tables=self.sparse_tables,
                           sparse_table_kwargs=self.sparse_table_kwargs,
                           replicas=self.replicas,
                           nonfinite_guard=self.nonfinite_guard,
                           telemetry=self.telemetry)

    def _init_state(self, engine) -> TrainState:
        """The run's live state: the model's parameters, or a sweep's
        stacked ones (seeded, their learning rates set), with the optimizer
        state."""
        R = self.replicas
        if R is None:
            return TrainState(params=nest(engine.paths, engine.params),
                              opt_state=engine.init_opt_state())
        seeds = (self.replica_seeds if self.replica_seeds is not None
                 else [self.seed + i for i in range(R)])
        params = engine.init_replica_params(seeds)
        opt_state = engine.init_opt_state()
        if self.replica_lrs is not None:
            opt_state = engine.set_replica_lrs(opt_state, self.replica_lrs)
        return TrainState(params=params, opt_state=opt_state)

    # -- public API ----------------------------------------------------------------
    def train(self, model, train_loader, val_loader=None,
              state: Optional[TrainState] = None,
              resume: bool = False) -> List[Dict[str, Any]]:
        """Train, validate and checkpoint; returns the history (the whole
        run's, a resumed one's included). ``state`` starts from another
        run's parameters and optimizer state (copied into this run's
        tensors); ``resume=True`` restores the newest valid checkpoint of
        ``checkpoint_dir``, if there is one."""
        self._check_device(model)
        engine = self._make_engine(model)
        R = self.replicas
        live = self._init_state(engine)
        if state is not None:
            tree_copy_(live.params, state.params)
            tree_copy_(live.opt_state, state.opt_state)
            live.epoch, live.global_step = state.epoch, state.global_step
        state = live
        resumed_early_stop = None
        resume_accum = None
        history: List[Dict[str, Any]] = []
        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            live_tree = {"params": state.params, "opt_state": state.opt_state}
            arrays, aux, _ = self.ckpt.restore()
            _load_arrays(live_tree, arrays, engine.shardings(live_tree))
            state.epoch = int(aux["epoch"])
            state.global_step = int(aux["global_step"])
            resumed_early_stop = aux.get("early_stop")
            # Mid-epoch crash recovery: the checkpoint carries the epoch's
            # running loss accumulators and the completed-epoch history, so
            # the resumed run's returned history is identical to an
            # uninterrupted run's — not just from-here-on.
            resume_accum = aux.get("epoch_accum")
            history = [dict(r) for r in aux.get("history") or []]
            if aux.get("loader") is not None and hasattr(train_loader,
                                                         "load_state_dict"):
                train_loader.load_state_dict(aux["loader"])
            self.log_fn(f"[trainer] resumed at epoch={state.epoch} "
                        f"step={state.global_step}")
        dp = engine.data_parallel_size()
        batch_size = getattr(train_loader, "batch_size", None)
        if dp > 1 and batch_size is not None and batch_size % dp:
            raise ValueError(
                f"batch_size {batch_size} is not divisible by the "
                f"{dp}-way data-parallel mesh")
        if dp > 1 and getattr(train_loader, "drop_last", True) is False:
            raise ValueError(
                "data-parallel training requires drop_last=True: the "
                "tail batch generally cannot be split across the "
                f"{dp}-way data axis (same rule as multi-host streaming)")

        preempt = (PreemptionHandler(group=self._host_group())
                   if self.handle_preemption else None)
        watchdog = (StepWatchdog(
            self.step_budget_seconds,
            on_violation=lambda step, sec: self.log_fn(
                f"[trainer] watchdog: step ~{step} averaged {sec:.3f}s/step, "
                f"over budget {self.step_budget_seconds}s"),
            recorder=self.recorder)
            if self.step_budget_seconds else None)
        rec = self._rec()
        profile = (ProfileWindow(*self.profile_steps,
                                 log_dir=self.profile_dir or "profile",
                                 recorder=self.recorder)
                   if self.profile_steps and self.lead else None)
        roofline_pending = self.emit_roofline
        if R is None:
            best_val, bad_epochs = float("inf"), 0
        else:
            # Per-replica early stopping: a replica that exhausts its
            # patience goes inactive — the engine's device-resident mask
            # freezes its parameters and optimizer state in place while the
            # others keep training, and no graph is captured anew.
            best_val = np.full(R, np.inf)
            bad_epochs = np.zeros(R, dtype=int)
            active = np.ones(R, dtype=bool)
        if resumed_early_stop is not None:
            # A resumed sweep must not reactivate stopped replicas, nor a
            # resumed run forget its patience counter.
            if R is None:
                best_val = float(resumed_early_stop["best_val"])
                bad_epochs = int(resumed_early_stop["bad_epochs"])
            else:
                best_val = np.asarray(resumed_early_stop["best_val"],
                                      np.float64)
                bad_epochs = np.asarray(resumed_early_stop["bad_epochs"], int)
                active = np.asarray(resumed_early_stop["active"], bool)

        def snapshot_early_stop():
            # JSON-able early-stop state for the checkpoint's aux. Counters
            # only move at epoch boundaries, so a mid-epoch checkpoint
            # carries the state the epoch started with.
            if R is None:
                self._early_stop_aux = {"best_val": best_val,
                                        "bad_epochs": bad_epochs}
            else:
                self._early_stop_aux = {"best_val": best_val.tolist(),
                                        "bad_epochs": bad_epochs.tolist(),
                                        "active": active.tolist()}

        snapshot_early_stop()
        # Signal handlers must not outlive the loop they guard: restored on
        # every exit path (completion, early stop, preemption, exception).
        try:
            while state.epoch < self.epochs:
                t0 = time.perf_counter()
                # The epoch's one source of truth for the loss, skip and
                # batch accumulators and the per-step metric events.
                acc = TelemetryDrain(replicas=R, recorder=self.recorder,
                                     every=self.obs_every, epoch=state.epoch)
                wd_epoch_start = watchdog.violations if watchdog else 0
                if resume_accum is not None:
                    # First epoch after a mid-epoch resume: start from the
                    # checkpointed accumulators so the epoch's loss covers
                    # every batch, not just the post-crash ones.
                    acc.load(resume_accum)
                    resume_accum = None
                epoch_active = None if R is None else active.copy()
                # (staged payload, first global step of its chunk)
                pending = None
                stop = False
                chunk_t0 = time.perf_counter()
                # loader_state is the resume point after the chunk's last
                # batch (the staging thread itself has run ahead).
                items = iter(DevicePrefetcher(
                    train_loader, device=self.device,
                    chunk_batches=engine.chunk_batches,
                    shard=engine.batch_shard(), recorder=self.recorder))
                try:
                    with rec.span("epoch", epoch=state.epoch), \
                            contextlib.closing(_chunks(rec, items,
                                                       state)) as chunks:
                        for chunk, loader_state, n in chunks:
                            if roofline_pending:
                                # once, before the first chunk runs
                                roofline_pending = False
                                with rec.span("roofline"):
                                    cost = engine.roofline(state.opt_state,
                                                           chunk)
                                rec.emit(make_event(
                                    "roofline", "chunk_step", data=cost,
                                    step=state.global_step))
                            if profile is not None:
                                profile.before_chunk(state.global_step)
                            with rec.span("train.step", detail=True):
                                state.opt_state, losses = engine.step(
                                    state.opt_state, chunk,
                                    active=epoch_active)
                            staged = stage(losses)
                            if pending is not None:
                                # Reading the previous chunk's payload waits
                                # only for it; the chunk just queued keeps
                                # the device busy.
                                with rec.span("train.drain", detail=True):
                                    acc.drain(*pending)
                            pending = (staged, state.global_step)
                            prev_step = state.global_step
                            state.global_step += n
                            if profile is not None:
                                profile.after_chunk(state.global_step)
                            if watchdog is not None:
                                now = time.perf_counter()
                                watchdog.check((now - chunk_t0) / max(n, 1),
                                               state.global_step)
                                chunk_t0 = now
                            every = self.checkpoint_every_steps
                            save_now = bool(self.ckpt and every
                                            and prev_step // every
                                            < state.global_step // every)
                            preempted = (preempt is not None
                                         and preempt.stop_requested())
                            if save_now or (preempted and self.ckpt):
                                # A mid-epoch checkpoint's accumulators must
                                # cover exactly the batches its loader cursor
                                # has passed: drain the chunk in flight first
                                # (the one host sync a checkpoint costs).
                                with rec.span("train.drain", detail=True):
                                    acc.drain(*pending)
                                pending = None
                                with rec.span("checkpoint",
                                              step=state.global_step):
                                    self._save(engine, state, train_loader,
                                               loader_state,
                                               epoch_accum=acc.aux(),
                                               history=history)
                            if preempted:
                                self.log_fn(
                                    "[trainer] preempted; checkpoint written"
                                    if self.ckpt else
                                    "[trainer] preempted; no checkpoint_dir "
                                    "configured — stopping without saving")
                                stop = True
                                break
                        if pending is not None:
                            with rec.span("train.drain", detail=True,
                                          chunk=pending[1]):
                                acc.drain(*pending)
                finally:
                    # stops and joins the staging thread, which closes the
                    # loader's iteration (a streaming loader's producer)
                    items.close()
                if stop:
                    self._final_state = state
                    return history
                state.epoch += 1
                mean_loss = acc.mean_loss()
                record: Dict[str, Any] = {
                    "epoch": state.epoch,
                    "train_loss": (mean_loss if R is None
                                   else mean_loss.tolist()),
                    "seconds": time.perf_counter() - t0}
                if self.nonfinite_guard:
                    record["skipped_steps"] = (
                        int(acc.skipped_steps) if R is None
                        else np.asarray(acc.skipped_steps).tolist())
                if watchdog is not None:
                    record["watchdog_violations"] = (watchdog.violations
                                                     - wd_epoch_start)
                if R is not None:
                    record["active"] = epoch_active.tolist()
                if val_loader is not None:
                    with rec.span("eval", epoch=state.epoch):
                        val = self.evaluate(
                            model, val_loader,
                            params=None if R is None else state.params,
                            replicas=R)
                    record.update({f"val_{k}": v for k, v in val.items()})
                    if R is None:
                        val_loss = -val["ll"]
                        if val_loss < best_val - 1e-6:
                            best_val, bad_epochs = val_loss, 0
                        else:
                            bad_epochs += 1
                    else:
                        # The scalar rule, elementwise over the replicas
                        # still training; finished ones keep their counters.
                        val_loss = -np.asarray(val["ll"], np.float64)
                        improved = val_loss < best_val - 1e-6
                        best_val = np.where(improved & active, val_loss,
                                            best_val)
                        bad_epochs = np.where(improved & active, 0,
                                              bad_epochs + active.astype(int))
                history.append(record)
                self.log_fn(f"[trainer] {record}")
                if rec.enabled:
                    # The epoch record as one event, with the counters and
                    # the process's memory: the heartbeat a dashboard tails.
                    rec.emit(make_event("epoch", "epoch_record", data=record,
                                        epoch=state.epoch - 1,
                                        step=state.global_step))
                    rec.flush_counters(epoch=state.epoch - 1,
                                       step=state.global_step)
                    rec.process_stats(epoch=state.epoch - 1,
                                      step=state.global_step)
                # Resolve stopping before the end-of-epoch checkpoint, so the
                # saved early-stop state is the one the next epoch trains
                # under.
                stop_now = False
                if val_loader is not None:
                    if R is None:
                        stop_now = bad_epochs >= self.patience
                    else:
                        stopping = active & (bad_epochs >= self.patience)
                        if stopping.any():
                            active = active & ~stopping
                            self.log_fn(
                                f"[trainer] replicas "
                                f"{np.flatnonzero(stopping).tolist()} "
                                f"early-stop at epoch {state.epoch} "
                                f"({int(active.sum())}/{R} still training)")
                        stop_now = not active.any()
                snapshot_early_stop()
                if self.ckpt:
                    # End of epoch: the loader's cursor is at the next
                    # epoch's start, and a fresh epoch has no accumulators.
                    with rec.span("checkpoint", step=state.global_step):
                        self._save(engine, state, train_loader,
                                   history=history)
                if stop_now:
                    self.log_fn(f"[trainer] early stop at epoch {state.epoch}"
                                if R is None else
                                f"[trainer] all replicas stopped at epoch "
                                f"{state.epoch}")
                    break
            self._final_state = state
            return history
        finally:
            if profile is not None:
                # idempotent: a window still open past the last trained step
                # (or an exception inside it) writes its trace here
                profile.close(state.global_step)
            if preempt is not None:
                preempt.restore()

    def _host_group(self):
        """The world's gloo group when a mesh spans more than one rank
        (the host's flags are reduced there), else None."""
        if self.mesh is None or dist.get_world_size() == 1:
            return None
        from repro_torch.launch.mesh import host_group

        return host_group()

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
    def evaluate(self, model, loader, per_rank: bool = False, *,
                 params=None, replicas: Optional[int] = None):
        """Stream ``loader`` through the click metrics in chunks of
        ``chunk_batches`` batches, each chunk one graph replay on the card;
        the metric state stays on the device and is read once at the end.

        ``params`` (a JAX-shaped tree of tensors) evaluates other
        parameters than the model's own; with ``replicas=R`` it is a
        sweep's R-stacked tree, and every metric comes back as an R-list.

        On a mesh each rank runs its rows of every batch (the whole of a
        batch the data axes do not divide on data rank 0, and nothing on
        the others), and the metric sums are all-reduced over ``data``
        once, before they are read.
        """
        self._check_device(model)
        step = self._eval_step(model)
        update = step.replayed if self.device.type == "cuda" else step.loop
        paths = [param_path(n) for n, _ in model.named_parameters()]
        if replicas is not None:
            stacked = unnest(paths, params)
            runs = [[t[r] for t in stacked] for r in range(replicas)]
        else:
            runs = None if params is None else [unnest(paths, params)]
        metrics, state = step.metrics, None
        shard = None
        if self.mesh is not None:
            from repro_torch.distrib.shardings import (data_parallel_index,
                                                       data_parallel_size)

            shard = (data_parallel_index(self.mesh),
                     data_parallel_size(self.mesh))
        for chunk, _, _ in DevicePrefetcher(loader, device=self.device,
                                            chunk_batches=self.chunk_batches,
                                            shard=shard,
                                            recorder=self.recorder):
            if state is None:
                positions = chunk["positions"].shape[2]
                state = (metrics.init_state(positions, self.device)
                         if runs is None else
                         [metrics.init_state(positions, self.device)
                          for _ in runs])
            if chunk["positions"].shape[1]:  # this rank's rows: maybe none
                state = update(model, state, chunk, runs)
        if state is None:
            raise ValueError(
                "evaluation loader produced no batches — dataset smaller than "
                "batch_size with drop_last=True? Pass drop_last=False.")
        if self.mesh is not None:
            from repro_torch.distrib.collectives import axes_group
            from repro_torch.distrib.shardings import DATA_AXES

            group = axes_group(self.mesh, DATA_AXES(self.mesh))
            for t in tree_leaves(state):
                dist.all_reduce(t, group=group)
        states = [state] if runs is None else state
        names = list(metrics.metrics)
        tensors = [metrics.compute(st)[k] for st in states for k in names]
        if per_rank:
            tensors += [metrics.compute_per_rank(st)[k] for st in states
                        for k in names]
        # one host transfer for every metric of every run
        flat = torch.cat([t.reshape(-1) for t in tensors]).tolist()
        values, at = [], 0
        for t in tensors:
            values.append(flat[at:at + t.numel()])
            at += t.numel()
        n = len(names)
        out = {k: [values[j * n + i][0] for j in range(len(states))]
               for i, k in enumerate(names)}
        if per_rank:
            ranks = values[len(states) * n:]
            out["per_rank"] = {k: [ranks[j * n + i]
                                   for j in range(len(states))]
                               for i, k in enumerate(names)}
        if replicas is None:  # one run: its values, not 1-lists
            out = {k: (v[0] if k != "per_rank" else
                       {m: r[0] for m, r in v.items()})
                   for k, v in out.items()}
        return out

    def test(self, model, test_loader, params=None, per_rank: bool = True,
             replicas="auto"):
        """Evaluate on the test split. With no explicit ``params``, the
        trainer's own final state is used (R-stacked on a sweep trainer, so
        metrics come back as R-lists; the model's own parameters for a
        single run). Explicit ``params`` are a single run — the
        ``select_replica`` workflow — unless ``replicas=R`` says
        otherwise."""
        if replicas == "auto":
            replicas = self.replicas if params is None else None
        if params is None and replicas is not None:
            params = self._final_state.params
        return self.evaluate(model, test_loader, per_rank=per_rank,
                             params=params, replicas=replicas)

    # -- internals -------------------------------------------------------------------
    def _save(self, engine, state: TrainState, loader, loader_state=None,
              epoch_accum=None, history=None):
        if loader_state is None:
            get_state = getattr(loader, "state_dict", lambda: None)
            loader_state = get_state()
        # row shards gathered to full tensors (every rank takes part)
        tree = engine.gathered({"params": state.params,
                                "opt_state": state.opt_state})
        if not self.lead:
            return
        self.ckpt.save(state.global_step, tree,
                       aux={"epoch": state.epoch,
                            "global_step": state.global_step,
                            "loader": loader_state,
                            "early_stop": getattr(self, "_early_stop_aux",
                                                  None),
                            "epoch_accum": epoch_accum,
                            "history": history or []})


def _chunks(rec, items, state):
    """The prefetcher's items, each yielded inside a detail span
    ``train.chunk`` (tags: ``chunk``, its first global step, read from
    ``state`` as it starts, and ``n``) that opens with the wait for it,
    ``train.wait_input`` (tag: ``item``). The chunk's own work runs inside
    the span; the wait that finds the epoch's end is a ``train.chunk`` of
    its own, with no ``n``."""
    for item in itertools.count():
        with rec.span("train.chunk", detail=True,
                      chunk=state.global_step) as span:
            with rec.span("train.wait_input", detail=True, item=item):
                got = next(items, None)
            if got is None:
                return
            span.tags["n"] = got[2]
            rec.add("train.chunks", detail=True)
            yield got


def _silent(*_args, **_kwargs) -> None:
    return None


@torch.no_grad()
def _load_arrays(live, arrays: Dict[str, np.ndarray],
                 shardings=None) -> None:
    """Copy a checkpoint's flat ``{path: array}`` into the tensors of
    ``live`` in place (the graphs keep their addresses), each cut to this
    rank's block by its sharding where ``shardings`` (a tree like
    ``live``) is given. Raises on a leaf the checkpoint lacks."""
    blocks = dict(flatten_with_paths(shardings)) if shardings else {}
    for key, dst in flatten_with_paths(live):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.asarray(arrays[key])
        if key in blocks:
            arr = blocks[key].local(arr)
        dst.copy_(torch.from_numpy(np.array(arr)))
