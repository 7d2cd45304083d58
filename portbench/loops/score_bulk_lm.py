"""The bulk scoring loop of a language model: one caller scores packed
sequences through the mix's ``entry`` (``configs.lm_common.score_bulk``:
a ``(batch, seq)`` int32 numpy batch in, the ``(batch, seq - 1)`` float32
log P of each next token out), call after call with no pause (a closed
loop), cycling over ``batches`` distinct batches.

The tokens are drawn from the seed: Zipf with exponent ``zipf_exponent``
over the configuration's ``vocab_size`` ids, ranks mapped to ids by a
seeded permutation. Every batch is served ``warmup_calls`` times over
before the window, a call is timed host to host, and the window runs whole
calls until ``--seconds`` have passed. ``sample_calls`` answers are kept,
drawn from the seed over all the window's calls (a reservoir); after the
window, once the program's model is freed, one row of each (``check_rows``
distinct rows in all) is held to the plain reference, every scored token
of it: ``logp_mean_gap``, the mean |program - reference| of log P over
those tokens (and ``logp_tail_share``, the share of them whose gap is over
the mix's ``tail_gap``, which the limits leave out: through the whole
stack most tokens lie past it).

Rows are independent (causal attention within a row, a dropless MoE
routes each token alone), so a subset of rows is exact.

Through 27 layers of random weights bfloat16's rounding flips near-tied
experts, and each flip moves the stream further downstream, so the whole
stack's gaps cannot tell a subtle routing fault (a choice bias in the
weights, a dropped slot) from rounding. So after the window the model is
cut to its first ``shallow_layers`` layers (:func:`cut`: the leaves
``shallow_zero`` of every later layer zeroed, so those layers add nothing
to the stream), the batch of the first checked row is scored once more
through the same entry, at the same shapes, and every row of it is held
to the reference over as many layers: ``shallow_logp_mean_gap`` and
``shallow_logp_tail_share``, where the routed experts' output reaches the
head through no chaotic stack. Every row of the batch, since a capacity
bound drops the slots of the tokens that come last.

With ``--trace 1`` the profiler window covers ``trace_calls`` calls from
``trace_at_call`` on; beside the trace, the loop reads the device time of
the work launched inside the program's ``lm.attention`` and ``lm.moe``
spans from the profiler's own events (:func:`span_device_s`).

:func:`control` is the reference with every matrix product's inputs
rounded to float8_e4m3 under a per-tensor scale, in the program's place.
"""
from __future__ import annotations

import gc
import importlib
import random
import time
from typing import Optional

import numpy as np
import torch

from yardstick import check, inputs, lm_cost, spans, weights
from yardstick.outcome import Outcome, Parts
from yardstick.trace import Profiled
from yardstick.trace import _union as trace_union

#: The program's spans whose kernels' device time the loop sums.
SPANS = ("lm.attention", "lm.moe")


def token_batches(config, traffic, seed: int):
    """The mix's distinct ``(batch, seq)`` int32 batches: Zipf ranks over
    the vocabulary, mapped to ids by a seeded permutation."""
    rng = np.random.default_rng(seed)
    V = config["vocab_size"]
    ids = rng.permutation(V)
    cdf = np.cumsum(np.arange(1, V + 1, dtype=np.float64)
                    ** -traffic["zipf_exponent"])
    u = rng.random((traffic["batches"], traffic["batch"], traffic["seq"]))
    ranks = np.minimum(np.searchsorted(cdf / cdf[-1], u, side="right"), V - 1)
    return [np.ascontiguousarray(ids[r].astype(np.int32)) for r in ranks]


def leaf_maker(config, seed: int, device):
    """``leaf(path, unit)``: the leaf's start as its dtype holds it
    (``weights.rounded``), in float32, whole or layer ``unit`` of a stacked
    leaf, made a block at a time."""
    table = weights.leaf_table(config)

    def leaf(path, unit=None):
        t = table[path]
        shape = list(t["shape"]) if unit is None else list(t["shape"][1:])
        n = int(np.prod(shape)) if shape else 1
        lo = 0 if unit is None else unit * n
        out = torch.empty(n, dtype=torch.float32, device=device)
        for b in range(0, n, weights.BLOCK):
            idx = torch.arange(lo + b, lo + min(b + weights.BLOCK, n),
                               dtype=torch.int64, device=device)
            out[b:b + len(idx)] = weights.rounded(
                seed, t["index"], idx, t["center"], t["spread"],
                getattr(torch, t["dtype"])).float()
        return out.view(shape)
    return leaf


def reference_logp(config, seed: int, rows: np.ndarray, device,
                   control: bool = False, layers: Optional[int] = None
                   ) -> np.ndarray:
    """The reference's ``(n, seq - 1)`` log P of the ``(n, seq)`` rows, as
    float64 numpy; ``control``: every product's inputs in float8_e4m3;
    ``layers``: through the first ``layers`` layers only."""
    ref = check.reference_module(config)
    if layers is not None:
        config = dict(config, num_hidden_layers=layers)
    tokens = torch.from_numpy(rows.astype(np.int64)).to(device)
    mm = ref.fp8_matmul if control else ref.matmul
    out = ref.next_token_logp(config, leaf_maker(config, seed, device),
                              tokens, mm)
    return out.double().cpu().numpy()


def gaps(got: np.ndarray, want: np.ndarray, tail_gap: float,
         prefix: str = ""):
    """``logp_mean_gap`` and ``logp_tail_share``, under ``prefix``; a gap
    that is not finite makes both infinite."""
    d = np.abs(got.astype(np.float64) - want)
    if not np.all(np.isfinite(d)):
        return {prefix + "logp_mean_gap": float("inf"),
                prefix + "logp_tail_share": float("inf")}
    return {prefix + "logp_mean_gap": float(d.mean()),
            prefix + "logp_tail_share": float((d > tail_gap).mean())}


def cut(model, config, traffic) -> None:
    """The model cut, in place, to its first ``shallow_layers`` layers: the
    stacked leaves ``shallow_zero`` (the sublayers' last projections, each
    of which writes into the stream) zeroed in every later layer, so each
    later layer adds an exact zero. The stack those leaves are layers of
    begins after ``first_k_dense_replace`` dense layers."""
    params = inputs.leaf_params(model)
    first = traffic["shallow_layers"] - config["first_k_dense_replace"]
    with torch.no_grad():
        for path in traffic["shallow_zero"]:
            params[path][first:].zero_()


def all_gaps(program, tokens, shallow, shallow_tokens, config, traffic,
             seed: int, device, control: bool = False):
    """The numbers ``correct`` is decided by, against the reference: of the
    whole stack's answers ``program`` for the rows ``tokens``, and of the
    cut stack's ``shallow`` for the rows ``shallow_tokens`` (``shallow_``);
    ``control``: the float8 reference's in the program's place."""
    layers = traffic["shallow_layers"]
    out = {}
    for prefix, got, rows, depth in (("", program, tokens, None),
                                     ("shallow_", shallow, shallow_tokens,
                                      layers)):
        want = reference_logp(config, seed, rows, device, layers=depth)
        if control:
            got = reference_logp(config, seed, rows, device, True, depth)
        out.update(gaps(np.asarray(got, dtype=np.float32), want,
                        traffic["tail_gap"], prefix))
    return out


def check_rows(sample, traffic, seed: int):
    """``[(batch index, row, answer)]``: ``check_rows`` distinct (batch,
    row) pairs, seeded rows of the sampled ``(batch index, answer)``s
    taken in turn, one of each a round (fewer only where the samples hold
    fewer rows)."""
    draw = random.Random(seed ^ 0x5EED)
    taken, out = set(), []
    while len(out) < traffic["check_rows"]:
        grew = False
        for b, answer in sample:
            free = [r for r in range(traffic["batch"]) if (b, r) not in taken]
            if free and len(out) < traffic["check_rows"]:
                r = draw.choice(free)
                taken.add((b, r))
                out.append((b, r, answer))
                grew = True
        if not grew:
            return out
    return out


def span_device_s(prof):
    """Device seconds of the work launched inside each of :data:`SPANS`,
    summed by name: a span's shadow on the device (the profiler's GPU
    annotation of a ``record_function`` range, from the first kernel it
    launched to the end of its last) bounds the work one stream ran for
    it in order, and the union of the kernels, copies and sets that ran
    inside it is counted. (The host ranges' ``device_time_total`` is not
    read: on the H100 it gave attention alone 2.4 s a call, as long as
    the device was busy a call in all.)"""
    from torch.autograd import DeviceType

    shadows = {name: [] for name in SPANS}
    work = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        interval = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name in shadows:
            shadows[e.name].append(interval)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith("portbench.")):
            work.append(interval)
    busy = trace_union(np.asarray(work, dtype=np.float64).reshape(-1, 2))
    return {name: spans.overlap_s(np.asarray(iv, dtype=np.float64)
                                  .reshape(-1, 2), busy)
            for name, iv in shadows.items()}


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        builder=None, t_process: Optional[float] = None) -> Outcome:
    config, traffic = cell.config, cell.traffic
    t_process = time.perf_counter() if t_process is None else t_process
    cuda = torch.device(device).type == "cuda"
    module, attr = traffic["entry"].rsplit(".", 1)
    entry = getattr(importlib.import_module(module), attr)
    parts = Parts(t_process)
    parts.mark("start")
    batches = token_batches(config, traffic, seed)
    parts.mark("tokens")
    model = inputs.build_model(config, seed, device, builder)
    parts.mark("model")
    B, S, n = traffic["batch"], traffic["seq"], traffic["batches"]
    shape = (B, S - 1)
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
    rows = check_rows([(b, out) for b, out in sample if out.shape == shape],
                      traffic, seed)
    cut(model, config, traffic)
    b_cut = rows[0][0] if rows else 0
    shallow = entry(model, batches[b_cut])
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    measured = {name: float("inf") for name in cell.limits}
    if rows and shallow.shape == shape:
        tokens = np.stack([batches[b][r] for b, r, _ in rows])
        measured = all_gaps(np.stack([a[r] for _, r, a in rows]), tokens,
                            shallow, batches[b_cut], config, traffic, seed,
                            device)

    ctx = {"window_s": t_end - t_start, "calls": calls, "call_s": latencies,
           "overhead_s": profiled.overhead_s if profiled else 0.0,
           "trace": profiled.trace() if profiled else None,
           "calls_traced": traced}
    if profiled is not None:
        ctx["span_device_s"] = span_device_s(profiled.prof)
        ctx["bound_s"] = {
            "call": lm_cost.bound_s(lm_cost.score_call(config, B, S)),
            "grouped_mm": sum(lm_cost.bound_s(c) for c in
                              lm_cost.grouped_mm(config, B * S))}
    e2e = {"serve_sessions_per_s": calls * B / (t_end - t_start),
           "peak_mem_gb": peak / 1e9, "setup_s": t_start - t_process}
    return Outcome(e2e=e2e, ctx=ctx, gaps=measured, attempted=calls,
                   failed=failed, memory_peak_bytes=peak,
                   setup_parts=parts.seconds)


def control(cell, seed: int, device="cuda"):
    """The control's gaps on ``seed``'s inputs: ``check_rows`` rows of the
    mix's batches, the float8 reference against the float32 one, over the
    whole stack and the cut one."""
    batches = token_batches(cell.config, cell.traffic, seed)
    picks = check_rows([(b, None) for b in range(len(batches))],
                       cell.traffic, seed)
    tokens = np.stack([batches[b][r] for b, r, _ in picks])
    return all_gaps(None, tokens, None, batches[picks[0][0]], cell.config,
                    cell.traffic, seed, device, control=True)
