"""The bulk serving loop: one caller scores sessions through the mix's
``entry`` (``configs.clax_baidu.serve_bulk``: a numpy batch in, a numpy
``(B, K)`` log P(click) out), call after call with no pause (a closed
loop), cycling over ``batches`` distinct batches cut from the pool.

Every batch is served ``warmup_calls`` times before the window, a call is
timed host to host, and the window runs whole calls until ``--seconds``
have passed. ``sample_calls`` answers are kept, drawn from the seed over
all the window's calls (a reservoir), and held to the reference once the
window has closed.
"""
from __future__ import annotations

import gc
import importlib
import random
import time
from typing import Optional

import numpy as np
import torch

from yardstick import check, cost, inputs
from yardstick.outcome import Outcome, Parts
from yardstick.trace import Profiled

#: What a serving call is given: the session fields but the clicks.
SERVED = ("positions", "query_doc_ids", "mask")


def _sectors(config, batch) -> int:
    """The 32-byte table sectors the batch's hashed rows lie in, summed
    over the hashed leaves."""
    total = 0
    for leaf in config["leaves"].values():
        if not leaf.get("hashed"):
            continue
        width = 4 * int(np.prod(leaf["shape"][1:]))
        rows = check.hashed_rows(batch[leaf["hashed"]].reshape(-1),
                                 leaf["shape"][0])
        first = rows * width // cost.SECTOR
        last = (rows * width + width - 1) // cost.SECTOR
        total += len(np.union1d(first, last))
    return total


def served_batches(pool, traffic):
    """The mix's distinct batches, cut from the pool in order."""
    B = traffic["batch"]
    return [{k: np.ascontiguousarray(pool[k][i * B:(i + 1) * B])
             for k in SERVED} for i in range(traffic["batches"])]


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        builder=None, t_process: Optional[float] = None) -> Outcome:
    config, traffic = cell.config, cell.traffic
    t_process = time.perf_counter() if t_process is None else t_process
    cuda = torch.device(device).type == "cuda"
    module, attr = traffic["entry"].rsplit(".", 1)
    entry = getattr(importlib.import_module(module), attr)
    parts = Parts(t_process)
    parts.mark("start")
    pool = inputs.make_pool(config, traffic, seed)
    parts.mark("pool")
    B, n = traffic["batch"], traffic["batches"]
    batches = served_batches(pool, traffic)
    del pool
    model = inputs.build_model(config, seed, device, builder)
    parts.mark("model")
    shape = (B, config["positions"])
    for i in range(traffic["warmup_calls"]):
        entry(model, batches[i % n])

    profiled = Profiled() if trace and cuda else None
    at, last = traffic["trace_at_call"], (traffic["trace_at_call"]
                                          + traffic["trace_calls"] - 1)
    keep = traffic["sample_calls"]
    draw = random.Random(seed)
    sample, latencies, failed = [], [], 0
    t_start = time.perf_counter()
    parts.mark("warmup", t_start)
    while time.perf_counter() - t_start < seconds:
        i = len(latencies)
        if profiled is not None and i == at:
            profiled.start()
        b = i % n
        t0 = time.perf_counter()
        out = entry(model, batches[b])
        latencies.append(time.perf_counter() - t0)
        if profiled is not None and i == last:
            profiled.stop()
        if out.shape != shape or out.dtype != np.float32:
            failed += 1
        if len(sample) < keep:
            sample.append((b, out))
        else:
            j = draw.randrange(i + 1)
            if j < keep:
                sample[j] = (b, out)
    t_end = time.perf_counter()
    calls = len(latencies)
    traced = min(calls, last + 1) - at
    if profiled is not None and profiled.active:
        profiled.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    want = {}
    gap = 0.0
    for b, out in sample:
        if b not in want:
            want[b] = check.serve_reference(config, seed, batches[b],
                                            torch.float64, device)
        if out.shape != shape:
            gap = float("inf")
            continue
        gap = max(gap, check.logp_gap(out, want[b]))

    items = B * config["positions"]
    ctx = {"window_s": t_end - t_start, "calls": calls,
           "call_s": latencies,
           "overhead_s": profiled.overhead_s if profiled else 0.0,
           "trace": profiled.trace() if profiled else None,
           "calls_traced": traced}
    if profiled is not None:
        batch_bytes = sum(batches[0][k].dtype.itemsize for k in SERVED) * items
        sectors = np.mean([_sectors(config, x) for x in batches])
        ctx["bound_s"] = {"call": cost.bound_s(cost.serve_call(
            batch_bytes, items * 4, int(sectors),
            config["flops_per_item"]["serve"] * items))}
    e2e = {"serve_sessions_per_s": calls * B / (t_end - t_start),
           "peak_mem_gb": peak / 1e9, "setup_s": t_start - t_process}
    return Outcome(e2e=e2e, ctx=ctx, gaps={"logp_gap": gap},
                   attempted=calls, failed=failed, memory_peak_bytes=peak,
                   setup_parts=parts.seconds)
