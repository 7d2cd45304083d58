"""The training loop: the configuration trained by ``Trainer.train`` on a
``ClickLogLoader`` over the mix's pool, as a user of the paper's workload
runs it.

One ``Trainer`` (AdamW as the configuration states, ``chunk_batches`` from
the mix, dense tables) and one :class:`Feed` over the loader drive every
call:

1. The check's steps: ``check_steps`` calls of one step each, each handing
   its state to the next (``state=``). After the first the optimizer's
   first moment gives the gradient as the optimizer got it; after the last
   the parameters' change from the weights they were made with. Each
   call's one-step history gives that step's loss.
2. The timed call, on the same model and feed: a fresh optimizer state,
   ``warmup_chunks`` chunks (the first runs eagerly and is captured, the
   rest replay), then the window: whole chunks until ``--seconds`` have
   passed since the window began, so no capture and no epoch restart falls
   in it. The window begins when the Trainer reads the last warm-up
   chunk's losses (its per-chunk telemetry event, on the thread that runs
   the chunks) and ends when ``Trainer.train`` returns.

Device memory's peak is read over the timed call: the check's hand-offs
hold two optimizer states at once, which no run of a user does.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from yardstick import check, cost, inputs, weights
from yardstick.outcome import Outcome, Parts
from yardstick.trace import Profiled

#: A window that has not begun this long after its call started has
#: failed (the Trainer's per-chunk event never came).
START_LIMIT_S = 120.0


class Feed:
    """The loader ``Trainer.train`` reads: the ``ClickLogLoader``'s
    batches, pass after pass over the pool (the loader reshuffles each),
    handed out call by call as :meth:`steps` or :meth:`window` plans. The
    time each batch takes to make (the loader's gather) is kept for the
    window's batches; with ``trace`` it is also a ``portbench.gather``
    span in the profiler's trace."""

    def __init__(self, loader, chunk: int):
        self.loader = loader
        self.batch_size = loader.batch_size
        self.drop_last = True
        self.chunk = chunk
        self.trace = False
        self._epoch = None
        self._plan = None
        self.gather_s = 0.0
        self.gathered = 0
        self.handed = 0
        self.timed_out = False

    def state_dict(self):
        return self.loader.state_dict()

    def steps(self, n: int) -> None:
        self._plan = ("steps", n, None, None)

    def window(self, clock, warmup_chunks: int, seconds: float) -> None:
        self._plan = ("window", warmup_chunks * self.chunk, clock, seconds)

    def _next(self):
        t0 = time.perf_counter()
        span = (torch.profiler.record_function("portbench.gather")
                if self.trace else contextlib.nullcontext())
        with span:
            while True:
                if self._epoch is None:
                    self._epoch = iter(self.loader)
                try:
                    batch = next(self._epoch)
                    break
                except StopIteration:
                    self._epoch = None
        return batch, time.perf_counter() - t0

    def __iter__(self):
        kind, n, clock, seconds = self._plan
        started = time.perf_counter()
        self.handed = 0
        while True:
            if kind == "steps" and self.handed == n:
                return
            if (kind == "window" and self.handed >= n
                    and self.handed % self.chunk == 0):
                now = time.perf_counter()
                if clock.t_start is not None and now - clock.t_start >= seconds:
                    return
                if clock.t_start is None and now - started > START_LIMIT_S:
                    self.timed_out = True
                    return
            batch, dt = self._next()
            if kind == "window" and self.handed >= n:
                self.gather_s += dt
                self.gathered += 1
            self.handed += 1
            yield batch


class Clock:
    """A sink for the Trainer's telemetry events. With ``obs_every`` equal
    to the chunk, one ``train_step`` event comes a chunk, on the thread that
    runs the chunks, once the chunk's losses have been read: the
    ``warmup``-th marks the window's start. With a profiler window it is
    opened at the ``at``-th chunk read after the start and closed
    ``chunks`` later."""

    def __init__(self):
        self.arm(0)

    def arm(self, warmup: int, profiled: Optional[Profiled] = None,
            at: int = 0, chunks: int = 0) -> None:
        self.warmup, self.read, self.t_start = warmup, 0, None
        self.profiled, self.at, self.chunks = profiled, at, chunks

    def emit(self, event: Dict) -> None:
        if event.get("kind") != "metric" or event.get("name") != "train_step":
            return
        self.read += 1
        if self.read == self.warmup:
            self.t_start = time.perf_counter()
        p = self.profiled
        if p is not None and self.t_start is not None:
            since = self.read - self.warmup
            if since == self.at and p.prof is None:
                p.start()
            elif since == self.at + self.chunks and p.active:
                p.stop()

    def close(self) -> None:
        pass


def _adam_state(opt_state):
    """The optimizer state's Adam part (``count``, ``mu``, ``nu``)."""
    stack = [opt_state]
    while stack:
        s = stack.pop()
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
        if isinstance(s, (tuple, list)):
            stack.extend(s)
        elif isinstance(s, dict):
            stack.extend(s.values())
    raise TypeError("no Adam moments in the Trainer's optimizer state")


def loader_seed(seed: int) -> int:
    return seed + 1


def check_batches(pool, traffic, seed: int):
    """The batches of the check's steps, worked out from the pool as the
    loader's definition (copied from ``repro.data.loader``) orders them:
    the first of the first pass's permutation, seeded (loader seed,
    epoch 0)."""
    order = np.random.default_rng((loader_seed(seed), 0)).permutation(
        len(pool["clicks"]))
    B = traffic["batch"]
    return [{k: v[order[i * B:(i + 1) * B]] for k, v in pool.items()}
            for i in range(traffic["check_steps"])]


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        builder=None, t_process: Optional[float] = None) -> Outcome:
    from repro_torch.data import ClickLogLoader
    from repro_torch.obs import Recorder
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer

    config, traffic = cell.config, cell.traffic
    t_process = time.perf_counter() if t_process is None else t_process
    cuda = torch.device(device).type == "cuda"
    opt = config["optimizer"]
    chunk = traffic["chunk_batches"]
    parts = Parts(t_process)
    parts.mark("start")
    pool = inputs.make_pool(config, traffic, seed)
    parts.mark("pool")
    model = inputs.build_model(config, seed, device, builder)
    parts.mark("model")
    leaves = weights.leaf_table(config)
    params = inputs.leaf_params(model)
    loader = ClickLogLoader(pool, batch_size=traffic["batch"], shuffle=True,
                            seed=loader_seed(seed))
    feed = Feed(loader, chunk)
    clock = Clock()
    trainer = Trainer(adamw(opt["learning_rate"], b1=opt["b1"], b2=opt["b2"],
                            eps=opt["eps"],
                            weight_decay=opt["weight_decay"]),
                      epochs=1, chunk_batches=chunk, device=device,
                      log_fn=lambda _: None, recorder=Recorder(sinks=[clock]),
                      obs_every=chunk)

    # 1. the check's steps through the same Trainer.train
    losses, grads, state = [], {}, None
    for step in range(traffic["check_steps"]):
        feed.steps(1)
        history = trainer.train(model, feed, state=state)
        state, trainer._final_state = trainer._final_state, None
        state.epoch = 0  # the next call is an epoch of its own
        losses.append(float(history[-1]["train_loss"]))
        if step == 0:
            mu = _adam_state(state.opt_state).mu
            for path, m in zip(params, mu):
                grads[path] = float(torch.linalg.vector_norm(
                    m.double())) / (1 - opt["b1"])
    changes = {path: weights.change_norm(params[path], seed, leaf["index"],
                                         leaf["center"], leaf["spread"])
               for path, leaf in leaves.items()}
    program = check.TrainReadings(losses, grads, changes)
    parts.mark("check_steps")
    del state
    gc.collect()

    # 2. the timed call
    profiled = Profiled() if trace and cuda else None
    feed.trace = profiled is not None
    clock.arm(traffic["warmup_chunks"], profiled, traffic["trace_at_chunk"],
              traffic["trace_chunks"])
    feed.window(clock, traffic["warmup_chunks"], seconds)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    history = trainer.train(model, feed)
    t_end = time.perf_counter()
    if feed.timed_out or clock.t_start is None:
        raise RuntimeError("the timed call's window never began: no "
                           "per-chunk telemetry event came from the Trainer")
    if profiled is not None and profiled.active:
        profiled.stop()
    parts.mark("warmup", clock.t_start)
    window_s = t_end - clock.t_start
    steps = feed.handed - traffic["warmup_chunks"] * chunk
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    mean_loss = float(history[-1]["train_loss"])
    setup_s = clock.t_start - t_process
    gather_s, gathered = feed.gather_s, feed.gathered
    trainer._final_state = None
    del trainer, history, model, params, feed, loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # 3. the reference follows the check's steps
    B = traffic["batch"]
    reference = check.train_reference(config, seed,
                                      check_batches(pool, traffic, seed),
                                      torch.float64, device)
    gaps = check.train_gaps(program, reference)

    numels = [int(np.prod(leaf["shape"])) for leaf in leaves.values()]
    items = B * config["positions"]
    batch_bytes = sum(pool[k].dtype.itemsize for k in pool) * items
    step_cost = cost.train_step(numels, batch_bytes,
                                config["flops_per_item"]["train"] * items)
    ctx = {
        "window_s": window_s, "steps": steps,
        "overhead_s": profiled.overhead_s if profiled else 0.0,
        "trace": profiled.trace() if profiled else None,
        "gather_s": gather_s, "gathered": gathered,
        "launches_per_step": {"adamw": len(numels), "examination_nll": 1},
        "chunk": chunk,
        "bound_s": {"adamw": cost.bound_s(cost.adamw(numels)),
                    "examination_nll": cost.bound_s(
                        cost.examination_nll(B, config["positions"])),
                    "step": cost.bound_s(step_cost)},
    }
    e2e = {"train_sessions_per_s": steps * B / window_s,
           "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    return Outcome(e2e=e2e, ctx=ctx, gaps=gaps, attempted=steps,
                   failed=0 if np.isfinite(mean_loss) else steps,
                   memory_peak_bytes=peak, setup_parts=parts.seconds)
