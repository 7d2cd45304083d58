#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device         the card's name, count, power limit (nvidia-smi).
2. build          nvcc builds every CUDA source (examination_nll,
                  session_nll, embedding_bag, flash_attention, dcn_cross,
                  adamw, sparse_adamw)
                  at once into src/repro_torch/kernels/build/, with
                  ptxas's registers and spill bytes for every kernel entry
                  (flash_attention's attention_rows_kernel and
                  attention_tiles_kernel instances among them).
   profile        torch.profiler's device kernels, one line each, of one
                  examination_nll_cuda and one session_nll_cuda call at
                  65,536 x 10 and of DeepFM's first-order bag_lookup at its
                  main shape.
3. kernels        each hand-written kernel against its plain PyTorch
                  version on the card, at its main-path shape and at edge
                  shapes; times of kernel, plain version, library call, and
                  the bound. The loss kernels at 65,536 x 10, each with
                  repeated calls, two batches back to back and a graph
                  replay equal to the bit, calls in flight at once on two
                  streams and two graphs replayed at once equal to their
                  eager bits (each call its own last-block counter), one
                  kernel node in a captured call, its launch plan
                  beside its neighbours and two yardsticks (a torch.sum
                  over the same bytes, a one-float launch); session_nll
                  also on views with a storage offset (equal to the bit to
                  their aligned copies) and its first design (Triton)
                  timed;
                  embedding_bag at DeepFM's first-order bag over the real
                  80,000,000-row table with int32 and int64 ids, edge cases
                  with ids past the table, L = 130 and int32 ids, the
                  variant each case took, its tile sizes swept, and the
                  main shape on L2-resident and on uniform
                  ids; fm_interaction at (65,536, 39, 10);
                  flash_attention at AutoInt's (65,536, 2, 2, 39, 39, 16)
                  in float32 and bfloat16, contiguous and in AutoInt's
                  (B, S, H, Dh)-backed layout, each case with the variant
                  (rows or tiles) its launch plan took, and the first
                  design (the tiles variant) timed at the main shape;
                  dcn_cross at the two-tower's (655,360, 16), the
                  conformance and sweep shapes, (65,536, 1024) and bf16;
                  adamw over the DBN's two 214,748,672-row tables against
                  the plain chain (moments and parameters, equal to the bit
                  or not), timed beside torch.optim.AdamW(fused=True), and
                  its edges (n = 1, 7, 1,000,003, 10 x 10, a 0-d scalar,
                  bf16 moments, an injected lr, adam, count 1 and 10,000,
                  an unaligned view, and lr = 0.05, wd = 0.1 over five
                  steps, where dropping the decay term would fail the hold
                  by over a hundred tolerances); sparse_adamw over one such
                  table at the 655,360 slots of the DBN log's first batch,
                  hashed as row_ids does, with sentinel padding against its
                  plain version, untouched rows equal to the bit, row 0
                  untouched and row R-1 touched, its dedupe timed, beside
                  torch.optim.SparseAdam; edges: unhashed Zipf ranks at
                  the same size, d = 3, bf16 moments, every row touched,
                  and the same decay case.
4. train_dbn      the paper-width DBN (2 x 214,748,672 hashed rows, batch
                  65,536, AdamW 3e-3) takes 16 steps through the Trainer;
                  the examination_nll kernel must be launched 16 times,
                  adamw 5 times a step (one per parameter tensor), and a
                  fixed held-out batch's loss must fall.
   train_dbn_sparse  the same DBN through Trainer(sparse_tables=True): 16
                  examination_nll, 32 sparse_adamw (two tables a step) and
                  48 adamw (the three dense tensors a step).
   Every train phase runs through the engine's CUDA graphs: the counted
   epoch's first chunk runs eagerly and is captured, the rest replay; the
   held-out evaluation runs twice (eager and captured, then one replay,
   equal to the bit). A replay runs no wrapper, so in each of these runs
   the wrappers' counts must be exact for the eager steps, and every
   launch, the wrappers' and the replayed graphs' kernel nodes (read from
   each graph with the CUDA driver API, by function name), exact for every
   step; those are the launches reported. Each phase also reports:
   chunk_timing (host enqueue and device run per step of the eager loop
   and of a replay, the graphs captured and capture_ms, a whole chunk's
   copies and replay under torch.cuda.set_sync_debug_mode("error"), the
   replay's graph kernels held to the chunk's launches, one "profile" line
   per kernel with its device time, and the epoch replayed under the
   staging thread), staging_thread_capture (a capture taken while the
   prefetcher's thread stages a batch, the run counted as above),
   graph_vs_eager (2 chunks of
   4 from one state: losses, parameters and moments, eager against eager
   and captured against eager), three rounds of the input path alone,
   inline and overlapped (with the loader's gather and the consumer's
   wait), and the warm step (the second epoch of a two-epoch run: replays
   only), taken in turned order, with each round's warm step less its
   overlapped input path; one optimizer update under sync debug
   "error", step_breakdown_ms and the peak memory (allocated and reserved)
   with capture.
5. train_dctr     the same for DCTR, 8 steps, through session_nll.
6. train_ubm      the paper-width UBM (214,748,672 hashed rows), 8 steps;
                  no kernel; its test pass runs ubm_marginal_clicks at
                  65,536 x 10 x 10, held to predict_clicks_loop.
7. cpu_vs_gpu     small DBN, DCTR, GCTR, RCTR, CM, UBM, two-tower PBM and
                  DCTR and a mixture with a shared tower: CPU (plain
                  versions) and GPU (kernels) agree on loss and every
                  gradient.
8. train_two_tower_pbm, train_two_tower_dctr   the paper's Listing-4 pair
                  (DeepCrossV2 attraction over 16 features) takes 8
                  AdamW(1e-2) steps at 65,536 x 10 on a PBM-behaviour log:
                  dcn_cross twice per forward (evaluation included),
                  session_nll once per DCTR step; nDCG@10 of each tower.
9. serve_deepfm   the published-width DeepFM (80,000,000-row tables) serves
                  512 and 262,144 rows and scores 1,000,000 candidates;
                  exactly one embedding_bag and one fm_interaction launch
                  per forward; the kernels' forward agrees with the plain
                  one. Then its forward at 65,536 rows and serve at 512
                  with and without the id passes bag_lookup ran before the
                  kernel took the clamp (clamp_fold).
10. train_deepfm  the same model takes 8 AdamW(1e-3) steps at 65,536 rows of
                  a synthetic Criteo-shaped log, one adamw launch per
                  parameter tensor a step; the held-out loss must fall.
11. serve_autoint, train_autoint   the same for AutoInt: three
                  flash_attention launches per forward.
12. cpu_vs_gpu_recsys   the reduced DeepFM and AutoInt: CPU (plain) and GPU
                  (kernels) agree on loss and every gradient.
13. The Trainer's run contract, after the earlier paths, on the
   two-tower PBM and the paper-width DBN (each phase prints its
   seconds; launches held exactly, the graphs' kernel nodes where graphs
   replay):
   train_sweep_two_tower  the pair's PBM as an R = 4 seed sweep (seeds
                  0-3), 8 steps: dcn_cross 8 a step; each replica against
                  the model built with its seed, run alone; the replicas'
                  losses differ.
   train_sweep_dbn  an R = 4 lr sweep (1.5e-3 .. 1.2e-2, injected lr), 16
                  steps in chunks of 4 through the engine: examination_nll
                  4 and adamw 20 a step; each replica against a standalone
                  run at its lr (losses, parameters, moments, at most 1e-5
                  apart, the gap printed); replica 2 frozen from the third
                  chunk, unchanged to the bit with no new capture; a chunk
                  under sync debug "error". Then the Trainer: the sweep's
                  warm epoch against four sequential runs' (replica-steps
                  per second) and its peak memory.
   guard_dbn      the non-finite guard over 16 batches, the sixth poisoned
                  by NonFiniteBatchInjector: only its step skipped, its
                  loss NaN; equal to the bit to a run without it; the
                  Trainer's record; the finite check's device ms a step.
                  (adamw's and sparse_adamw's predicate forms are held in
                  the kernel phase: True equal to the bit to no predicate,
                  False writes nothing, both timed.)
   resume_dbn     checkpoints every 8 steps (keep 1) in a temporary
                  directory; a SIGTERM KillSwitch at batch 9 preempts the
                  run, a fresh Trainer resumes it: parameters, moments and
                  history equal to the bit to an uninterrupted run; save
                  and restore seconds and bytes. Then the launcher's
                  SIGKILL drill at its default size (3 epochs):
                  --fault-kill-at-step 100 --max-restarts 1 exits 0 with
                  the uninterrupted run's records and test metrics.
   em             Figure 1 on the card: GCTR, RCTR, DCTR and SDBN by MLE,
                  PBM and UBM by 30 EM iterations, on 1,048,576 sessions,
                  each timed on the card alone, then held against the
                  CPU port's fit, and evaluated on the held-out batch
                  beside gradient-trained PBM and UBM (launches counted as
                  above).
14. The out-of-core data plane and its observability, after every earlier
   path, in temporary directories removed at the end:
   store          the 16 training batches written as a single-shard store
                  (codec auto) train the paper-width DBN through the
                  Trainer and a StreamingClickLogLoader: batches, per-step
                  losses, parameters, moments and launches equal to the bit
                  to the in-memory loader's run; 4,194,304 sessions
                  ingested in 4 shards of 2^20 by 4 spawned workers,
                  byte-identical to 1 worker (sessions/s of each, the
                  seconds a spawned worker takes to import torch, bytes on
                  disk and raw); one epoch of the DBN from that store (64
                  steps, crc-verified, read ahead); a shard's read taken
                  apart (each column's decode, verify and permuted gather,
                  as stored and rewritten raw); the input path in turned
                  rounds for the in-memory loader, the single-shard and the
                  4-shard store, each with its warm step; a mid-epoch
                  state_dict resume and, after corrupt_shard_file, the
                  skip policy's stream, each against the fault-free
                  stream, to the bit.
   telemetry      the paper-width DBN, dense and with sparse tables, 16
                  steps with telemetry=True under a Recorder with a
                  JsonlSink: parameters, moments, losses and launches equal
                  to the run without it, one capture and three replays, a
                  replay and its staging under sync debug "error", every
                  JSONL line valid, step 0's grad and parameter norms
                  within 1e-5 relative of the CPU port's; the norms' device
                  ms against their bound; the warm step with telemetry on
                  and off in turned rounds; a ProfileWindow over steps 0-8
                  (the first chunk's capture inside it): its trace parses
                  and the capture holds; the launcher with --store-dir
                  --ingest --metrics-out --trace-out --profile-steps 2:5 in
                  a subprocess, exit 0, its files valid. Then ROADMAP C.4:
                  an R = 2 sweep with replica 1 frozen and telemetry on
                  (dense with injected lrs; sparse, guarded), one step:
                  the frozen replica equal to the bit, its norms those of
                  the CPU port's step at its lr (1e-5), the active replica
                  equal to the bit to telemetry off; and the R = 4 sweep's
                  device ms per step and peak memory, telemetry off and on.
15. The serving engine (slice 11), after every earlier path:
   serve_engine   the paper-width DBN and UBM and the two-tower PBM (16
                  features) in one ModelRegistry, weights drawn from seeds,
                  buckets 1-512: one CUDA graph per (model, tier, bucket)
                  at warmup (sizes, capture ms), then a wall-clock Poisson
                  trace of 2,000 requests at 1,000 requests/s, 50 ms
                  deadlines, through ServeEngine, counted (dcn_cross 2 per
                  two-tower forward: eager warm-ups and replayed graph
                  nodes), with no capture under traffic; each graph's
                  dcn_cross nodes (2 in the tower's, 0 in the others);
                  each tier at every bucket against its eager call
                  (primary and the int8 graph equal to the bit, gather-
                  first int8 equal to dequantize-then-gather, int8 within
                  its scale/2 bound, prior constant); one dispatch host to
                  host at buckets 1 and 512 per tier (host and device ms,
                  the device's idle share, the replay alone), a launch
                  under sync debug "error", the whole-table dequantize
                  form as a yardstick; serve_bulk (262,144 x 10) for the
                  DBN and UBM against its bound; the chaos drill on the
                  card against the CPU port's (signature, counters,
                  log_ctr); the launcher's SIGTERM drill in a subprocess.

Every phase that drives a path sets every kernel's launch count to 0 just
before it and reads the counts just after; they must be exact (where
graphs replay, the wrappers' and the graphs' kernel nodes together). A
control
line holds the device times of the six kernels this slice left untouched
beside the last runs before it. Then the kernel summary line (eight
kernels: the six ports of TPU kernels and the optimizer's two), the card's
name and power limit as nvidia-smi prints them, and the final status
line. Any mismatch raises, and the script exits
non-zero; it exits non-zero without a result when no GPU is visible. It
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

B_MAIN, K_MAIN = 65536, 10
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores. Both kernels are float32 elementwise work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Operations per (B, K) element, counted from the kernel sources (compares,
# selects, adds, multiplies, divides and transcendentals each count one).
OPS_PER_ELEMENT = {"examination_nll": 44, "session_nll": 12}
BYTES_PER_ELEMENT = {"examination_nll": 6 * 4 + 1, "session_nll": 2 * 4 + 1}
RTOL, ATOL = 1e-5, 1e-6
# Device ms of the six kernels this slice leaves untouched, from the last
# runs before it (PERF.md's kernel table and the runs it cites; NVIDIA H100
# 80GB HBM3, 700.00 W).
CONTROL_DEVICE_MS = {"examination_nll": 0.01265, "session_nll": 0.00551,
                     "embedding_bag": 0.02810, "fm_interaction": 0.0439,
                     "flash_attention": 0.507, "dcn_cross": 0.0712}


def emit(phase: str, **data) -> None:
    print(json.dumps({"phase": phase, **data}), flush=True)


def check_close(name, got, want, rtol=RTOL, atol=ATOL):
    got, want = float(got), float(want)
    if not (math.isfinite(got) and math.isfinite(want)):
        raise AssertionError(f"{name}: non-finite loss {got} vs {want}")
    if abs(got - want) > atol + rtol * abs(want):
        raise AssertionError(f"{name}: kernel {got!r} vs plain {want!r}")
    return abs(got - want)


def time_ms(fn, iters=200, warmup=10) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=10) -> float:
    """Device time of one ``fn()`` with the host's per-call work taken out:
    ``calls`` calls captured in one CUDA graph, replayed ``replays`` times."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def kernel_counters():
    """Each kernel's wrapper, by kernel name: ``.launches`` is its count."""
    from repro_torch import kernels as k

    return {"examination_nll": k.examination_nll_cuda,
            "session_nll": k.session_nll_cuda,
            "embedding_bag": k.embedding_bag_cuda,
            "fm_interaction": k.fm_interaction_triton,
            "flash_attention": k.flash_attention_cuda,
            "dcn_cross": k.dcn_cross_cuda,
            "adamw": k.adamw_cuda,
            "sparse_adamw": k.sparse_adamw_cuda}


def reset_counts() -> None:
    for wrapper in kernel_counters().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in kernel_counters().items()}


def check_counts(what, expected) -> dict:
    """The counts since the last reset must be ``expected`` exactly (0 for
    any kernel it does not name)."""
    got = read_counts()
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return got


def bound(name, rows, cols):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate; inputs read once, a scalar written."""
    n = rows * cols
    t_bytes = (n * BYTES_PER_ELEMENT[name] + 4) / PEAK_BYTES_PER_S
    t_ops = n * OPS_PER_ELEMENT[name] / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def exam_inputs(gen, rows, cols, device):
    import torch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(rows, cols, generator=gen,
                                           device=device)

    x = torch.randn(rows, cols, generator=gen, device=device) * 4.0
    clicks = (torch.rand(rows, cols, generator=gen, device=device) < 0.3
              ).float()
    lengths = torch.randint(1, cols + 1, (rows, 1), generator=gen,
                            device=device)
    mask = torch.arange(cols, device=device)[None, :] < lengths
    p_reset = u(0.05, 0.95)
    return [x, clicks, mask, u(0.05, 0.95), u(0.0, 0.5), p_reset,
            1.0 - p_reset]


def session_inputs(gen, rows, cols, device):
    import torch

    x = torch.randn(rows, cols, generator=gen, device=device) * 4.0
    clicks = (torch.rand(rows, cols, generator=gen, device=device) < 0.3
              ).float()
    mask = torch.rand(rows, cols, generator=gen, device=device) < 0.8
    return [x, clicks, mask]


def edge_cases(name, make, gen, device):
    """Ragged B and K, |x| = 36, a fully masked batch and, for the chain
    loss, skip runs whose odds saturate; for session_nll, views with a
    storage offset."""
    import torch

    cases = {f"random_{rows}x{cols}": make(gen, rows, cols, device)
             for rows in (1, 255, 257) for cols in (1, 10, 33, 130)}
    for xv in (36.0, -36.0):
        args = make(gen, 257, 33, device)
        args[0] = torch.full_like(args[0], xv)
        cases[f"logit_{xv:+.0f}"] = args
    args = make(gen, 257, 33, device)
    args[2] = torch.zeros_like(args[2])
    cases["fully_masked"] = args
    if name == "examination_nll":
        # Long skip runs that cannot survive: the odds hit ODDS_CAP within
        # a position or two and must stay there.
        args = make(gen, 257, 130, device)
        args[1] = (torch.rand(257, 130, generator=gen, device=device) < 0.02
                   ).float()
        args[3] = torch.full_like(args[3], 1e-12)
        cases["saturating_skip_runs"] = args
        # Rows too long for 48 KB of staged spans: one row per block, the
        # block opts into more shared memory.
        cases["long_rows_5x2500"] = make(gen, 5, 2500, device)
    else:
        cases.update(offset_views(gen, device))
    return cases


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return kind, smi


def ptxas_entries(log):
    """ptxas -v's report per kernel entry: registers and spill bytes."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            entries.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return entries


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    builds = build.build_all()
    wall = time.perf_counter() - t0
    for name, info in builds.items():
        emit("build", kernel=name, seconds=info.seconds, wall_seconds=wall,
             library=os.path.relpath(info.path, ROOT),
             entries=ptxas_entries(info.log))


def phase_kernels(card):
    import torch

    from repro_torch.kernels import (examination_nll_cuda,
                                     examination_nll_plain, session_nll_cuda,
                                     session_nll_plain)

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    specs = [
        ("examination_nll", examination_nll_cuda, examination_nll_plain,
         None, exam_inputs, "cuda",
         "src/repro_torch/kernels/csrc/examination_nll.cu",
         "src/repro/kernels/examination_nll.py:48"),
        ("session_nll", session_nll_cuda, session_nll_plain,
         lambda x, c, m: torch.nn.functional.binary_cross_entropy_with_logits(
             x, c, weight=m.float(), reduction="sum")
         / m.float().sum().clamp_min(1.0),
         session_inputs, "cuda",
         "src/repro_torch/kernels/csrc/session_nll.cu",
         "src/repro/kernels/session_nll.py:24"),
    ]
    results = {}
    for (name, kernel, plain, library, make, route, source,
         replaces) in specs:
        args = make(gen, B_MAIN, K_MAIN, device)
        t0 = time.perf_counter()
        got = kernel(*args)
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        err = check_close(f"{name} main", got, plain(*args))
        edge_errs = {}
        for case, case_args in edge_cases(name, make, gen, device).items():
            want = plain(*case_args)
            edge_errs[case] = check_close(f"{name} {case}", kernel(*case_args),
                                          want)
            if case == "fully_masked" and float(want) != 0.0:
                raise AssertionError(f"{name}: fully masked loss {want}")
        torch.cuda.synchronize()
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        device_ms = {"kernel": graph_ms(lambda: kernel(*args)),
                     "plain": graph_ms(lambda: plain(*args))}
        library_ms = None
        if library is not None:
            check_close(f"{name} library", library(*args), plain(*args),
                        rtol=1e-4)
            library_ms = time_ms(lambda: library(*args))
            device_ms["library"] = graph_ms(lambda: library(*args))
        bound_ms, bound_by = bound(name, B_MAIN, K_MAIN)
        results[name] = {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": device_ms, "held": True}
        emit("kernel", name=name, shape=[B_MAIN, K_MAIN], card=card,
             kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             device_ms=device_ms, bound_ms=bound_ms, bound_by=bound_by,
             max_abs_err=err,
             first_call_s=first_call_s, edge_cases=len(edge_errs),
             max_edge_abs_err=max(edge_errs.values()))
        results[name].update(loss_forms(name, kernel, plain, args, make,
                                        gen, device, card))
    return results


def plan_sweep(name, kernel, args):
    """Device ms of the loss kernel's default launch plan beside its
    neighbours at the main shape."""
    if name == "examination_nll":
        from repro_torch.kernels.examination_nll import launch_plan

        plans = {}
        for rows_per_block in (None, 32, 64, 128, 256):
            plan = launch_plan(B_MAIN, K_MAIN, rows_per_block)
            plans[f"R{plan.rows_per_block}" + (
                "_default" if rows_per_block is None else "")] = plan
    else:
        from repro_torch.kernels.session_nll import launch_plan

        plans = {}
        for threads, vectors in ((None, None), (256, 1), (256, 2), (512, 2),
                                 (1024, 1), (128, 4)):
            plan = launch_plan(B_MAIN * K_MAIN, threads, vectors)
            plans[f"T{plan.threads}_V{plan.vectors}"
                  + ("_default" if threads is None else "")] = plan
    return {key: graph_ms(lambda: kernel(*args, plan=plan))
            for key, plan in plans.items()}


def loss_forms(name, kernel, plain, args, make, gen, device, card):
    """A one-launch loss kernel's design, held and timed: repeated calls
    give the same bits, two batches back to back each their own loss (the
    last block's ticket is reset), a CUDA-graph replay the eager call's
    bits, calls in flight at once on two streams and two graphs replayed at
    once each their own eager bits (concurrency_check), one kernel node in
    a captured call and one count per call; the launch plan beside
    its neighbours (device ms) and two yardsticks. session_nll also: views
    with a storage offset (read element by element) give the bits of their
    aligned copies, and the first design (Triton, five device kernels) is
    timed."""
    import torch

    first = kernel(*args)
    repeats = [kernel(*args) for _ in range(10)]
    if not all(bool(torch.equal(r, first)) for r in repeats):
        raise AssertionError(f"{name}: repeated calls differ "
                             f"{[float(r) for r in repeats]}")
    other = make(gen, B_MAIN, K_MAIN, device)
    pair = [kernel(*other), kernel(*args), kernel(*other)]
    check_close(f"{name} other batch", pair[0], plain(*other))
    if not (torch.equal(pair[1], first) and torch.equal(pair[2], pair[0])):
        raise AssertionError(f"{name}: back-to-back batches differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        captured = kernel(*args)
    graph.instantiate()
    from repro_torch.train.capture import graph_kernels

    nodes = graph_kernels(graph.raw_cuda_graph())
    if sum(nodes.values()) != 1 or port_kernels(nodes) != {name: 1}:
        raise AssertionError(f"{name}: a captured call holds the kernel "
                             f"nodes {dict(nodes)}, not one {name}")
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(captured, first):
            raise AssertionError(f"{name}: graph replay {float(captured)} "
                                 f"!= eager {float(first)}")
    del graph
    concurrency = concurrency_check(name, kernel, make, gen, device)
    if any(concurrency["stream_results_wrong"]) or any(
            concurrency["graph_results_wrong"]):
        raise AssertionError(f"{name}: calls in flight at once differ from "
                             f"their eager bits: {concurrency}")
    before = kernel.launches
    lines, total = profile_kernels(lambda: kernel(*args))
    counted = kernel.launches - before
    if counted != 23:  # 3 warm + 20
        raise AssertionError(f"{name}: {counted} counted launches for 23 "
                             "calls")
    sweep = plan_sweep(name, kernel, args)
    # Yardsticks of what holds it: one torch.sum over as many bytes as the
    # kernel reads (a single-launch read), and a launch that does nothing
    # but add 1 to one float (the replay's launch floor).
    nbytes = sum(t.numel() * t.element_size() for t in args)
    buf = torch.ones(nbytes // 4, device=device)
    tiny = torch.zeros(1, device=device)
    yardsticks = {"sum_same_bytes_device_ms": graph_ms(lambda: torch.sum(buf)),
                  "one_float_add_device_ms": graph_ms(lambda: tiny.add_(1.0)),
                  "bytes": nbytes}
    del buf, tiny
    forms = {"repeat_bits_equal": True, "graph_replay_bits_equal": True,
             "graph_kernel_nodes_per_call": sum(nodes.values()),
             "back_to_back_batches": [float(x) for x in pair],
             "concurrency": concurrency,
             "profile_kernels_per_call": total["launches_per_call"],
             "profile_device_us_per_call": total["device_us_per_call"],
             "plan_sweep_device_ms": sweep, "yardsticks": yardsticks}
    if name == "examination_nll":
        from repro_torch.kernels.examination_nll import launch_plan

        forms["plan"] = launch_plan(B_MAIN, K_MAIN)._asdict()
        forms["edge_plans"] = {
            case: launch_plan(*case_args[0].shape)._asdict()
            for case, case_args in edge_cases(name, make, gen,
                                              device).items()}
    else:
        forms.update(session_forms(args, gen, device))
    emit("kernel_forms", name=name, card=card, shape=[B_MAIN, K_MAIN],
         **forms)
    return forms


def session_forms(args, gen, device):
    """session_nll_cuda's plan, its offset views beside their aligned
    copies (to the bit), and its first design (Triton) at the main shape:
    device and call ms, five device kernels per call."""
    import torch

    from repro_torch.kernels import (session_nll_cuda, session_nll_plain,
                                     session_nll_triton)
    from repro_torch.kernels.session_nll import launch_plan

    offsets = {}
    for case, views in offset_views(gen, device).items():
        copies = [t.clone() for t in views]
        got, aligned = session_nll_cuda(*views), session_nll_cuda(*copies)
        if not torch.equal(got, aligned):
            raise AssertionError(f"session_nll {case}: {float(got)} != "
                                 f"aligned copy {float(aligned)}")
        offsets[case] = check_close(f"session_nll {case}", got,
                                    session_nll_plain(*views))
    err = check_close("session_nll triton", session_nll_triton(*args),
                      session_nll_plain(*args))
    _, total = profile_kernels(lambda: session_nll_triton(*args))
    return {"plan": launch_plan(B_MAIN * K_MAIN)._asdict(),
            "offset_views_bits_equal_aligned": offsets,
            "triton_design": {
                "device_ms": graph_ms(lambda: session_nll_triton(*args)),
                "ms": time_ms(lambda: session_nll_triton(*args)),
                "profile_kernels_per_call": total["launches_per_call"],
                "profile_device_us_per_call": total["device_us_per_call"],
                "max_abs_err": err}}


def offset_views(gen, device, rows=257, cols=33):
    """session_nll inputs that are contiguous (rows, cols) views starting
    ``off`` elements into their storage: none 16-byte aligned, or floats
    aligned and the mask not."""
    cases = {}
    for x_off, m_off in ((1, 1), (2, 2), (3, 3), (4, 1)):
        flat = session_inputs(gen, 1, rows * cols + 4, device)
        cases[f"offset_{x_off}_mask_{m_off}_{rows}x{cols}"] = [
            t.view(-1)[off:off + rows * cols].view(rows, cols)
            for t, off in zip(flat, (x_off, x_off, m_off))]
    return cases


#: Device cycles that gate_streams holds two streams back (~55 ms at the
#: H100's 1.8 GHz): long enough for the host to queue every call behind it.
GATE_CYCLES = 100_000_000


def gate_streams(streams):
    """Hold ``streams`` behind a device-side sleep on the current stream, so
    that what the host queues on them next runs at the same time."""
    import torch

    torch.cuda._sleep(GATE_CYCLES)
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())


def concurrency_check(name, kernel, make, gen, device, pairs=50,
                      replays=10, calls=10):
    """Calls of one loss kernel in flight at once must not share a
    last-block counter. (a) Two batches on two streams, ``pairs``
    interleaved pairs queued behind one gate with no synchronise between
    them; (b) two graphs of ``calls`` calls each, captured apart, replayed
    at once on two streams ``replays`` times. Every result is compared to
    the bit with its batch's eager call on the default stream; returns the
    counts of results that differ (the caller decides)."""
    import torch

    batches = [make(gen, B_MAIN, K_MAIN, device) for _ in range(2)]
    eager = [kernel(*args) for args in batches]
    current = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in batches]
    gate_streams(streams)
    outs = [[], []]
    for _ in range(pairs):
        for s, args, out in zip(streams, batches, outs):
            with torch.cuda.stream(s):
                out.append(kernel(*args))
    for s in streams:
        current.wait_stream(s)
    torch.cuda.synchronize()
    stream_wrong = [sum(not bool(torch.equal(r, want)) for r in out)
                    for out, want in zip(outs, eager)]
    worst = max(abs(float(r) - float(want))
                for out, want in zip(outs, eager) for r in out)

    graphs = []
    for args in batches:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = [kernel(*args) for _ in range(calls)]
        graphs.append((graph, captured))
    graph_wrong = [0, 0]
    for _ in range(replays):
        gate_streams(streams)
        for s, (graph, _) in zip(streams, graphs):
            with torch.cuda.stream(s):
                graph.replay()
        for s in streams:
            current.wait_stream(s)
        torch.cuda.synchronize()
        for i, ((_, captured), want) in enumerate(zip(graphs, eager)):
            graph_wrong[i] += sum(not bool(torch.equal(r, want))
                                  for r in captured)
            worst = max([worst] + [abs(float(r) - float(want))
                                   for r in captured])
    del graphs
    return {"stream_pairs": pairs, "stream_results_wrong": stream_wrong,
            "graph_replays": replays, "graph_calls": calls,
            "graph_results_wrong": graph_wrong, "max_abs_gap": worst,
            "eager": [float(x) for x in eager]}


def profile_kernels(fn, calls=20):
    """One line per device kernel that ``calls`` calls of ``fn()`` run,
    from torch.profiler (CUDA activity): launches and device microseconds
    per call, and the total. Warm calls; a synchronize closes the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.name if len(evt.name) <= 120 else evt.name[:117] + "..."
        n, us = per_kernel.get(name, (0, 0.0))
        per_kernel[name] = (n + 1, us + evt.time_range.elapsed_us())
    lines = [{"kernel": name, "launches_per_call": n / calls,
              "device_us_per_call": us / calls}
             for name, (n, us) in sorted(per_kernel.items(),
                                         key=lambda kv: -kv[1][1])]
    return lines, {"launches_per_call": sum(x["launches_per_call"]
                                            for x in lines),
                   "device_us_per_call": sum(x["device_us_per_call"]
                                             for x in lines)}


def port_kernels(named_counts) -> dict:
    """Counts by device kernel name (a mangled or demangled function name)
    as counts by the launch counters' names, for the port's kernels only
    (sparse_adamw before adamw: its name holds adamw's)."""
    names = ("sparse_adamw", "adamw", "examination_nll", "session_nll",
             "dcn_cross", "embedding_bag", "fm_interaction", "attention")
    out = {}
    for kernel, n in named_counts.items():
        for name in names:
            if name in kernel:
                key = "flash_attention" if name == "attention" else name
                out[key] = out.get(key, 0) + n
                break
    return out


def replayed_launches(fn):
    """``fn()``, and the port's kernels that its graph replays launched, by
    the launch counters' names: each replay's graph's kernel nodes, read
    from the graph itself (``capture.graph_kernels``), so the count is
    exact (a replay runs no wrapper)."""
    import torch

    from repro_torch.train import capture

    capture.replayed_kernels = Counter()
    try:
        out = fn()
        torch.cuda.synchronize()
        replayed = capture.replayed_kernels
    finally:
        capture.replayed_kernels = None
    return out, port_kernels(replayed), sum(replayed.values())


def measured_run(what, fn, total, eager):
    """``fn()`` with every count at 0. The wrappers' counts (the launches
    made from Python: the eager steps; a capture counts none and a replay
    runs no wrapper) must be ``eager`` exactly, and every launch, the
    wrappers' and those of the replayed graphs' kernel nodes
    (:func:`replayed_launches`), ``total`` exactly (0 for a kernel neither
    names). ``total`` and ``eager`` may be functions of ``fn``'s result,
    for a run whose steps are known only once it has run. Returns ``fn``'s
    result and ``{"launches": every launch, "wrapper_launches": the
    wrappers', "replayed_launches": the replays', "replayed_kernels": every
    kernel node the replays launched, the port's or not}``."""
    reset_counts()
    out, replayed, replayed_all = replayed_launches(fn)
    if callable(total):  # counts that depend on the run: read from it
        total, eager = total(out), eager(out)
    wrappers = check_counts(what, eager)
    launches = {name: n + replayed.get(name, 0)
                for name, n in wrappers.items()}
    want = {name: total.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} (replayed "
                             f"{replayed}) != {want}")
    return out, {"launches": launches, "wrapper_launches": wrappers,
                 "replayed_launches": replayed,
                 "replayed_kernels": replayed_all}


def phase_profile(card):
    """The profiler's breakdown, one line per device kernel, of one
    examination_nll_cuda and one session_nll_cuda call at 65,536 x 10 and
    of DeepFM's first-order term, bag_lookup over the real (80,000,000, 1)
    table with 65,536 bags of 39 Zipf ids, as the model calls it."""
    import torch

    from repro_torch.kernels import examination_nll_cuda, session_nll_cuda
    from repro_torch.models.recsys.embedding import TableConfig, bag_lookup

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    exam = exam_inputs(gen, B_MAIN, K_MAIN, device)
    sess = session_inputs(gen, B_MAIN, K_MAIN, device)
    log = CriteoLog(device, seed=1)
    cfg = TableConfig(TABLE_ROWS, 1)
    params = {"table": torch.randn(TABLE_ROWS, 1, generator=gen,
                                   device=device)}
    ids = log.field_ids(B_MAIN)
    del log
    out = {}
    for what, fn in (("examination_nll_cuda", lambda: examination_nll_cuda(
                          *exam)),
                     ("session_nll_cuda", lambda: session_nll_cuda(*sess)),
                     ("bag_lookup", lambda: bag_lookup(cfg, params, ids))):
        lines, total = profile_kernels(fn)
        for line in lines:
            emit("profile", call=what, card=card, **line)
        out[what] = {**total, "call_ms": time_ms(fn, iters=200),
                     "graph_device_ms": graph_ms(fn)}
        emit("profile_total", call=what, card=card, **out[what])
    del exam, sess, params, ids
    torch.cuda.empty_cache()
    return out


def _synthetic_log(n_sessions):
    from repro_torch.data import SyntheticConfig, generate_click_log

    cfg = SyntheticConfig(n_sessions=n_sessions,
                          n_queries=max(n_sessions // 100, 1),
                          docs_per_query=20, positions=K_MAIN, behavior="dbn",
                          seed=0)
    data, _ = generate_click_log(cfg)
    keys = ("positions", "query_doc_ids", "clicks", "mask")
    return {k: data[k] for k in keys}


def _device_batch(data, lo, hi):
    import torch

    return {k: torch.from_numpy(v[lo:hi]).cuda() for k, v in data.items()}


def _step_breakdown(engine, batch, reps=3):
    """Host-clock ms of forward, backward and optimizer update of one step
    (the engine's own ``apply_update``: the fused adamw kernel, and
    sparse_adamw for sparse tables), each closed by a synchronize (taken
    after the counted run)."""
    import torch

    model = engine.model
    params = engine.params
    state = engine.init_opt_state()
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.compute_loss(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = engine.apply_update(state, batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for p in params:
            p.grad = None
        parts["forward_ms"].append((t1 - t0) * 1e3)
        parts["backward_ms"].append((t2 - t1) * 1e3)
        parts["optimizer_ms"].append((t3 - t2) * 1e3)
    return {k: min(v) for k, v in parts.items()}


def _chunk_of(batch, n=4):
    return {k: v.expand(n, *v.shape).contiguous() for k, v in batch.items()}


def _host_and_device_ms(fn, reps):
    """(host ms to enqueue ``fn()``, ms until the device has run it), the
    best of ``reps``: equal numbers mean the host cannot run ahead."""
    import torch

    enqueue, run = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e3)
        run.append((t2 - t0) * 1e3)
    return min(enqueue), min(run)


def _profiled_kernels(lines):
    """Launches per call of the port's kernels in profile lines, by the
    launch counters' names."""
    return port_kernels({line["kernel"]: line["launches_per_call"]
                         for line in lines})


def chunk_timing(engine, batch, kind, card, per_chunk, loader, steps, n=4,
                 reps=3):
    """A 4-step chunk of ``batch`` through the eager loop and through
    ``engine.step`` (its first call: the warm-up and the capture; then one
    replay a call): host enqueue and device run per step for each (a
    replay also while its kernels are counted, and the one read of the
    graph's nodes), the
    graphs captured and the capture's ms; a whole chunk (its static copies
    and its replay) under ``torch.cuda.set_sync_debug_mode("error")``; the
    port's kernels a replay launches, from its graph's kernel nodes, held
    to ``per_chunk`` (a replay runs no wrapper, so the counters must not
    move), and the profiler's device time per kernel of a replay; then
    ``loader``'s epoch replayed under the staging thread
    (:func:`replay_under_staging`).
    """
    import torch

    state = engine.init_opt_state()
    chunk = _chunk_of(batch, n)
    eager = _host_and_device_ms(lambda: engine._loop(state, chunk), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step(state, chunk)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    replay = _host_and_device_ms(lambda: engine.step(state, chunk), reps)
    # what counting the replays' kernels costs: the graph's nodes read
    # once, then one Counter update a replay
    from repro_torch.train import capture

    t0 = time.perf_counter()
    nodes = [capture.CudaGraphs.kernels(e.graph)
             for e in engine.graphs._entries.values()]
    read_nodes_ms = (time.perf_counter() - t0) * 1e3
    capture.replayed_kernels = Counter()
    try:
        counting = _host_and_device_ms(lambda: engine.step(state, chunk),
                                       reps)
    finally:
        capture.replayed_kernels = None
    del nodes
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.step(state, chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    before = read_counts()
    _, per_replay, nodes = replayed_launches(
        lambda: engine.step(state, chunk))
    after = read_counts()
    counted = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if counted:
        raise AssertionError(f"{kind}: a replay counted {counted} in the "
                             "wrappers, which a replay does not run")
    if per_replay != per_chunk:
        raise AssertionError(f"{kind}: a replay's graph launched "
                             f"{per_replay} kernels, expected {per_chunk}")
    # the device time per kernel (the trace's counts are printed, not
    # held: a trace can drop records)
    lines, total = profile_kernels(lambda: engine.step(state, chunk),
                                   calls=3)
    for line in lines:
        emit("profile", call=f"replay_{kind}", card=card, **line)
    profiled = _profiled_kernels(lines)
    if not total["launches_per_call"]:
        raise AssertionError(f"{kind}: the profiler saw no device kernel "
                             "in a replay")
    graphs = engine.graphs
    staging = replay_under_staging(engine, state, loader, steps)
    return {**staging, "steps": n,
            "eager_enqueue_ms_per_step": eager[0] / n,
            "eager_run_ms_per_step": eager[1] / n,
            "replay_enqueue_ms_per_step": replay[0] / n,
            "replay_run_ms_per_step": replay[1] / n,
            "counted_replay_enqueue_ms_per_step": counting[0] / n,
            "counted_replay_run_ms_per_step": counting[1] / n,
            "graph_kernels_read_ms": read_nodes_ms,
            "first_chunk_ms": first_ms, "graphs": graphs.captures,
            "capture_ms": graphs.capture_seconds * 1e3,
            "no_host_sync_in_chunk": True,
            "wrapper_launches_per_replay": counted,
            "graph_launches_per_replay": per_replay,
            "graph_kernel_nodes_per_replay": nodes,
            "profile_kernels_per_replay": profiled,
            "profile_device_kernels_per_replay": total["launches_per_call"],
            "profile_device_ms_per_replay":
                total["device_us_per_call"] / 1e3}


def _tensor_gap(a, b):
    import torch

    if torch.equal(a, b):
        return 0.0, 0
    diff = (a.double() - b.double()).abs()
    return float(diff.max()), int((a != b).sum())


def graph_vs_eager(engine, data, n=4, chunks=2):
    """From one state, ``chunks`` chunks of ``n`` of ``data``'s batches
    three times: through the eager loop twice (their spread shows whether
    the loop repeats its bits: the table gradients come from
    ``index_put_(accumulate=True)``) and through ``engine.step`` (the first
    chunk is the eager warm-up, the second a replay). Losses, parameters
    and both moments are held to the bit against the first eager run, or,
    if two eager runs differ, within their spread."""
    import torch

    from repro_torch.configs.clax_baidu import TRAIN_BATCH
    from repro_torch.train.capture import tree_leaves

    state = engine.init_opt_state()
    batches = [_device_batch(data, i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
               for i in range(n * chunks)]
    stacked = [{k: torch.stack([b[k] for b in batches[c * n:(c + 1) * n]])
                for k in batches[0]} for c in range(chunks)]
    del batches
    params = [p.detach() for p in engine.params]
    moments = [t for t in tree_leaves(state) if t.dim() > 0]
    start = [t.clone() for t in params + tree_leaves(state)]

    def run(step):
        for t, s in zip(params + tree_leaves(state), start):
            t.copy_(s)
        losses = torch.cat([step(state, c)[1] for c in stacked])
        return {"losses": losses, "params": [p.clone() for p in params],
                "moments": [m.clone() for m in moments]}

    def gap(x, y):
        out = {}
        for what in ("losses", "params", "moments"):
            xs, ys = x[what], y[what]
            pairs = zip(xs, ys) if isinstance(xs, list) else [(xs, ys)]
            gaps = [_tensor_gap(a, b) for a, b in pairs]
            out[what] = {"max_abs": max(g[0] for g in gaps),
                         "elements_differing": sum(g[1] for g in gaps)}
        return out

    first = run(engine._loop)
    second = run(engine._loop)
    eager_spread = gap(first, second)
    graphed = run(engine.step)
    graph_gap = gap(first, graphed)
    if engine.graphs.replays < chunks - 1:
        raise AssertionError("graph_vs_eager: no chunk was replayed")
    repeatable = all(v["elements_differing"] == 0
                     for v in eager_spread.values())
    for what, g in graph_gap.items():
        limit = 0.0 if repeatable else eager_spread[what]["max_abs"]
        if g["max_abs"] > limit:
            raise AssertionError(
                f"graph_vs_eager: {what} {g} beyond the eager spread "
                f"{eager_spread[what]}")
    out = {"chunks": chunks, "steps_per_chunk": n,
           "eager_bits_repeat": repeatable, "eager_vs_eager": eager_spread,
           "graph_vs_eager": graph_gap,
           "bits_equal": all(v["elements_differing"] == 0
                             for v in graph_gap.values())}
    del first, second, graphed, start
    return out


class _GatedLoader:
    """A loader's batches, the third held back until ``gate`` is set (a
    capture has begun); ``resumed`` is set when the fourth is asked for,
    that is once the third has been stacked, copied and queued. Records
    the time each batch was handed out."""

    def __init__(self, inner, gate, resumed):
        self.inner, self.gate, self.resumed = inner, gate, resumed
        self.times = []

    def state_dict(self):
        return self.inner.state_dict()

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i == 2 and not self.gate.wait(timeout=120):
                raise RuntimeError("no capture began within 120 s")
            if i == 3:
                self.resumed.set()
            self.times.append(time.perf_counter())
            yield batch


def capture_with_staging_thread(engine, loader, per_step):
    """A capture taken while the prefetcher's staging thread stages a
    batch: the loader's third batch waits until the first chunk's capture
    has begun, and the capture waits, inside, until the thread has stacked
    that batch into a pinned buffer, copied it to the card, recorded its
    event and asked for the next (``capture_error_mode="thread_local"``).
    Every chunk after the first replays; the run is measured
    (:func:`measured_run`): the wrappers count the first step's launches,
    the replays' graphs every later step's. ``engine`` takes chunks of one
    batch."""
    import threading

    import torch

    from repro_torch.data import DevicePrefetcher
    from repro_torch.train.capture import ChunkGraphs

    gate, resumed = threading.Event(), threading.Event()
    gated = _GatedLoader(loader, gate, resumed)
    window = []
    engine.graphs = ChunkGraphs(engine._chunk_body)
    capture = engine.graphs.backend.capture

    def staged_then(fn):
        def inside():
            window.append(time.perf_counter())
            gate.set()
            if not resumed.wait(timeout=120):
                raise RuntimeError("the staging thread did not stage the "
                                   "third batch within 120 s")
            fn()
            window.append(time.perf_counter())
        return capture(inside)

    engine.graphs.backend.capture = staged_then
    state = engine.init_opt_state()
    steps = loader.batches_per_epoch

    def run():
        losses = []
        for chunk, _, _ in DevicePrefetcher(gated, size=4, device="cuda",
                                            chunk_batches=1):
            losses.append(engine.step(state, chunk)[1])
        return losses

    losses, counted = measured_run(
        "capture_with_staging_thread", run,
        {**{k: v * steps for k, v in per_step.items()},
         **_optimizer_launches(engine, steps)},
        {**per_step, **_optimizer_launches(engine, 1)})
    if len(losses) != steps:
        raise AssertionError(f"capture_with_staging_thread: {len(losses)} "
                             f"steps, expected {steps}")
    if not all(math.isfinite(x) for x in torch.cat(losses).tolist()):
        raise AssertionError("capture_with_staging_thread: non-finite loss")
    begun, ended = window
    staged = [t for t in gated.times if begun < t < ended]
    if len(staged) < 2:
        raise AssertionError(
            "capture_with_staging_thread: the third batch was not staged "
            f"inside the capture ({begun:.4f}-{ended:.4f}, batches "
            f"{gated.times[:5]})")
    return {"steps": steps, "graphs": engine.graphs.captures,
            "replays": engine.graphs.replays, **counted,
            "capture_ms": (ended - begun) * 1e3,
            "batches_handed_out_during_capture": len(staged)}


class _TimedLoader:
    """A loader's batches, each timed while it is made (the gather), on
    whichever thread pulls it."""

    def __init__(self, inner):
        self.inner, self.seconds = inner, 0.0

    def state_dict(self):
        return self.inner.state_dict()

    def __iter__(self):
        batches = iter(self.inner)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                return
            self.seconds += time.perf_counter() - t0
            yield batch


def input_path_ms(loader, steps, overlap):
    """Host ms per step of the input path alone: the epoch's chunks of 4
    through the loader and the prefetcher, nothing consuming them; and of
    that, the loader's gather (on the staging thread when overlapped) and
    the consumer's time blocked waiting for an item."""
    import torch

    from repro_torch.data import DevicePrefetcher

    timed = _TimedLoader(loader)
    waited = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    items = iter(DevicePrefetcher(timed, device="cuda", chunk_batches=4,
                                  overlap=overlap))
    while True:
        t1 = time.perf_counter()
        if next(items, None) is None:
            break
        waited += time.perf_counter() - t1
    torch.cuda.synchronize()
    return {"ms_per_step": (time.perf_counter() - t0) / steps * 1e3,
            "gather_ms_per_step": timed.seconds / steps * 1e3,
            "consumer_wait_ms_per_step": waited / steps * 1e3}


def _spread(ms):
    ms = sorted(ms)
    return {"min": ms[0], "median": ms[len(ms) // 2], "max": ms[-1]}


def warm_and_input_rounds(warm_epoch, loader, steps, rounds=3):
    """``rounds`` rounds of three readings taken moments apart, in turned
    order (inline, overlapped, warm in even rounds; warm, overlapped,
    inline in odd ones), so that a drift of the shared host falls on all
    three: the input path alone, inline and overlapped
    (:func:`input_path_ms`), and ``warm_epoch()``'s seconds (an epoch of
    replays only). Returns every reading, each one's least, median and
    greatest ms per step, and per round the warm step less the overlapped
    input path (positive where the warm step is at or above it)."""
    runs = {"inline": [], "overlap": []}
    warm = []
    for r in range(rounds):
        order = ("inline", "overlap", "warm")
        for what in (order if r % 2 == 0 else order[::-1]):
            if what == "warm":
                warm.append(warm_epoch() / steps * 1e3)
            else:
                runs[what].append(
                    input_path_ms(loader, steps, what == "overlap"))
    inputs = {mode: {**_spread([x["ms_per_step"] for x in readings]),
                     "runs": readings} for mode, readings in runs.items()}
    return ({**_spread(warm), "runs": warm}, inputs,
            [w - x["ms_per_step"] for w, x in zip(warm, runs["overlap"])])


def replay_under_staging(engine, state, loader, steps):
    """The epoch's chunks from the overlapped prefetcher, each through
    ``engine.step`` on ``state`` (its graph already captured): host ms to
    enqueue a replay while the staging thread works (its gathers and
    stacks hold the interpreter lock part of the time), and the epoch's ms
    per step."""
    import torch

    from repro_torch.data import DevicePrefetcher

    captures = engine.graphs.captures
    torch.cuda.synchronize()
    enqueue = []
    t0 = time.perf_counter()
    for chunk, _, _ in DevicePrefetcher(loader, device="cuda",
                                        chunk_batches=4):
        t1 = time.perf_counter()
        engine.step(state, chunk)
        enqueue.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    if engine.graphs.captures != captures:
        raise AssertionError("replay_under_staging: a chunk was captured")
    return {"replay_enqueue_ms_per_step_with_staging":
                sum(enqueue) / len(enqueue) / 4,
            "epoch_ms_per_step": (time.perf_counter() - t0) / steps * 1e3}


def _train_spec(kind):
    """(model, optimizer factory, sparse-table keyword arguments of the
    Trainer and engine, loss-kernel launches per step, dcn_cross launches
    per forward) of a training path: the paper-width ``dbn``, ``dctr`` and
    ``ubm``, ``dbn_sparse`` (the DBN with sparse lazy AdamW on its two
    tables), and the Listing-4 pair ``two_tower_pbm`` /
    ``two_tower_dctr``."""
    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model, make_two_tower

    if kind.startswith("two_tower_"):
        twin = kind[len("two_tower_"):]
        per_step = {"dcn_cross": 2}
        if twin == "dctr":
            per_step["session_nll"] = 1
        return (make_two_tower(twin, device="cuda"),
                lambda: optim.adamw(1e-2), {}, per_step, 2)
    base = kind.split("_")[0]
    per_step = {"dbn": {"examination_nll": 1}, "dctr": {"session_nll": 1},
                "ubm": {}}[base]
    sparse = (dict(sparse_tables=True,
                   sparse_table_kwargs=dict(lr=3e-3, weight_decay=1e-4))
              if kind.endswith("_sparse") else {})
    return (make_model(base, device="cuda"),
            lambda: optim.adamw(3e-3, weight_decay=1e-4), sparse, per_step,
            0)


def _optimizer_launches(engine, steps):
    """The optimizer kernels' launches in ``steps`` engine steps: one adamw
    per dense tensor (none for an empty one) and one sparse_adamw per
    sparse table."""
    out = {"adamw": steps * sum(1 for p in engine.dense_params
                                if p.numel())}
    if engine.sparse_parts:
        out["sparse_adamw"] = steps * len(engine.sparse_parts)
    return out


def no_sync_check(engine, batch):
    """One backward, then the engine's optimizer update under
    torch.cuda.set_sync_debug_mode("error"): any host sync in the update
    (the dedupe's sort, cumsum and scatter, the gathers, the kernels'
    wrappers) raises."""
    import torch

    state = engine.init_opt_state()
    loss = engine.model.compute_loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = engine.apply_update(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for p in engine.params:
        p.grad = None
    del state
    return True


def phase_train(kind, data, steps, card, extra=None):
    """``steps`` optimizer steps through the Trainer on ``data``'s first
    batches, the last batch held out. The counted epoch (its first chunk
    eager, then captured; the rest replays) and the held-out evaluation
    (two forwards per batch: the marginal and the conditional click
    predictions), run twice (the second replays the cached graph and must
    give the first one's bits), are each a :func:`measured_run`: the
    wrappers' counts exact for the eager steps and, with the replayed
    graphs' kernel nodes, exact for every step. ``extra(model, held_out)``
    adds path-specific checks and numbers to the phase's line."""
    import torch

    from repro_torch.configs.clax_baidu import TRAIN_BATCH
    from repro_torch.data import ClickLogLoader
    from repro_torch.train import TrainEngine, Trainer

    gc.collect()
    start_allocated = torch.cuda.memory_allocated()
    train = {k: v[:steps * TRAIN_BATCH] for k, v in data.items()}
    held_lo = len(data["clicks"]) - TRAIN_BATCH
    held_out = _device_batch(data, held_lo, held_lo + TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    model, make_optimizer, sparse, per_step, per_forward = _train_spec(kind)

    def make_engine(chunk_batches=1):
        return TrainEngine(model, make_optimizer(),
                           chunk_batches=chunk_batches, **sparse)

    with torch.no_grad():
        loss_before = float(model.compute_loss(held_out))

    def make_trainer(epochs):
        return Trainer(make_optimizer(), epochs=epochs, chunk_batches=4,
                       device="cuda", log_fn=lambda s: None, **sparse)

    trainer = make_trainer(1)
    loader = ClickLogLoader(train, batch_size=TRAIN_BATCH, seed=0)

    eager_steps = min(trainer.chunk_batches, steps)  # the first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history, counted = measured_run(
        f"train_{kind}", lambda: trainer.train(model, loader),
        {**{k: n * steps for k, n in per_step.items()},
         **_optimizer_launches(make_engine(), steps)},
        {**{k: n * eager_steps for k, n in per_step.items()},
         **_optimizer_launches(make_engine(), eager_steps)})
    seconds = time.perf_counter() - t0
    launches = counted["launches"]
    train_loss = history[-1]["train_loss"]
    if not math.isfinite(train_loss):
        raise AssertionError(f"{kind}: non-finite train loss {train_loss}")
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    with torch.no_grad():
        loss_after = float(model.compute_loss(held_out))
    if not loss_after < loss_before:
        raise AssertionError(f"{kind}: held-out loss {loss_before} -> "
                             f"{loss_after} did not fall")
    held_loader = ClickLogLoader({k: v[held_lo:] for k, v in data.items()},
                                 batch_size=TRAIN_BATCH, shuffle=False,
                                 drop_last=False)
    per_eval = {"dcn_cross": 2 * per_forward} if per_forward else {}
    metrics, eval_first = measured_run(
        f"evaluate_{kind}", lambda: trainer.evaluate(model, held_loader),
        per_eval, per_eval)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{kind}: non-finite held-out metrics {metrics}")
    replayed, eval_replayed = measured_run(
        f"evaluate_{kind}_replayed",
        lambda: trainer.evaluate(model, held_loader), per_eval, {})
    if replayed != metrics:
        raise AssertionError(f"{kind}: the replayed evaluation gave "
                             f"{replayed}, the eager one {metrics}")
    found = extra(model, held_out) if extra is not None else {}
    # The warm epoch: the second of a two-epoch run, whose engine captured
    # its graph in the first, so it is all replays.
    warm_ms, input_path, warm_over_input = warm_and_input_rounds(
        lambda: make_trainer(2).train(model, loader)[1]["seconds"], loader,
        steps)
    warm = warm_ms["median"] * steps / 1e3
    breakdown = _step_breakdown(make_engine(), held_out)
    per_chunk = {**{k: 4 * n for k, n in per_step.items()},
                 **_optimizer_launches(make_engine(), 4)}
    timing = chunk_timing(make_engine(chunk_batches=4), held_out, kind, card,
                          per_chunk, loader, steps)
    found["staging_thread_capture"] = capture_with_staging_thread(
        make_engine(), loader, per_step)
    found["no_host_sync_in_update"] = no_sync_check(make_engine(), held_out)
    found["graph_vs_eager"] = graph_vs_eager(make_engine(chunk_batches=4),
                                             data)
    n_params = model.n_params()
    del model, trainer, held_out
    gc.collect()
    torch.cuda.empty_cache()
    emit(f"train_{kind}", card=card, steps=steps, batch=TRAIN_BATCH,
         params=n_params, seconds=seconds,
         steps_per_s=steps / seconds,
         sessions_per_s=steps * TRAIN_BATCH / seconds,
         warm_seconds=warm, warm_steps_per_s=steps / warm,
         warm_step_ms=warm / steps * 1e3,
         warm_sessions_per_s=steps * TRAIN_BATCH / warm,
         warm_step_ms_rounds=warm_ms, input_ms_per_step=input_path,
         warm_minus_overlapped_input_ms=warm_over_input,
         max_memory_allocated=peak, max_memory_reserved=peak_reserved,
         launches=launches, wrapper_launches=counted["wrapper_launches"],
         eval_launches={"first": eval_first, "replayed": eval_replayed},
         train_loss=train_loss, held_out_loss_before=loss_before,
         held_out_loss_after=loss_after, held_out_metrics=metrics,
         eval_replay_bits_equal=True,
         step_breakdown_ms=breakdown, chunk_timing=timing,
         memory_left_allocated=torch.cuda.memory_allocated()
         - start_allocated, **found)
    return launches


def ubm_marginal_check(model, held_out):
    """UBM's test pass: ubm_marginal_clicks over the held-out 65,536 x 10 x
    10, finite, and within 1e-5 of the O(K^2) predict_clicks_loop on the
    first 512 sessions."""
    import torch

    with torch.no_grad():
        lu = model.predict_clicks(held_out)
        if not bool(torch.isfinite(lu).all()):
            raise AssertionError("ubm: non-finite marginal click log-probs")
        head = {k: v[:512] for k, v in held_out.items()}
        loop = model.predict_clicks_loop(head)
        if _over(lu[:512], loop, 1e-5) > 0:
            raise AssertionError(f"ubm: marginal vs loop differ by "
                                 f"{_max_err(lu[:512], loop)}")
        ms = time_ms(lambda: model.predict_clicks(held_out), iters=10,
                     warmup=2)
    return {"marginal_vs_loop_abs_err": _max_err(lu[:512], loop),
            "marginal_ms": ms}


def ndcg_check(true_attractiveness):
    """``ndcg(model, batch)``: nDCG@10 of the model's relevance scores on
    the held-out batch against its true attractiveness graded 0-4
    (``examples/two_tower.py``)."""
    import torch

    from repro_torch.core import ndcg_metric

    graded = torch.clamp((torch.from_numpy(true_attractiveness) * 5).long(),
                         0, 4).cuda()

    def ndcg(model, batch):
        with torch.no_grad():
            scores = model.predict_relevance(batch)
            return float(ndcg_metric(scores, graded, where=batch["mask"],
                                     top_n=10))

    return ndcg


def phase_train_two_tower(kind, data, truth, steps, card):
    """The Listing-4 PBM or its DCTR twin through phase_train, with nDCG@10
    of its tower against true attractiveness before and after."""
    import torch

    from repro_torch.configs.clax_baidu import make_two_tower

    held_lo = len(data["clicks"]) - len(truth)
    ndcg = ndcg_check(truth)
    held_out = _device_batch(data, held_lo, len(data["clicks"]))
    before = ndcg(make_two_tower(kind, device="cuda"), held_out)
    del held_out
    torch.cuda.empty_cache()
    return phase_train(f"two_tower_{kind}", data, steps, card,
                       extra=lambda model, batch: {
                           "ndcg10_before": before,
                           "ndcg10_after": ndcg(model, batch)})


def _two_tower_log(n_sessions):
    """A PBM-behaviour log with 16 query-document features, as
    ``examples/two_tower.py`` makes it; returns the model's columns and the
    held-out batch's true attractiveness."""
    from repro_torch.configs.clax_baidu import TOWER_FEATURES, TRAIN_BATCH
    from repro_torch.data import SyntheticConfig, generate_click_log

    cfg = SyntheticConfig(n_sessions=n_sessions, n_queries=200,
                          docs_per_query=15, positions=K_MAIN,
                          behavior="pbm", seed=1, n_features=TOWER_FEATURES,
                          exam_decay=0.6, ranker_noise=2.0)
    data, _ = generate_click_log(cfg)
    keys = ("positions", "query_doc_ids", "clicks", "mask",
            "query_doc_features")
    return ({k: data[k] for k in keys},
            data["true_attractiveness"][-TRAIN_BATCH:])


def _feature_batch(rows, features, seed):
    """A small numpy click batch with (rows, K, features) features."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, K_MAIN + 1, (rows, 1))
    return {"positions": np.tile(np.arange(1, K_MAIN + 1, dtype=np.int32),
                                 (rows, 1)),
            "query_doc_ids": rng.integers(0, 4000, (rows, K_MAIN)),
            "clicks": (rng.random((rows, K_MAIN)) < 0.3).astype(np.float32),
            "mask": np.arange(K_MAIN)[None, :] < lengths,
            "query_doc_features": rng.normal(
                size=(rows, K_MAIN, features)).astype(np.float32)}


def phase_cpu_vs_gpu(data):
    """The same weights on the CPU (plain versions) and the card (kernels):
    loss and every gradient agree to 1e-5, and the GPU loss launches
    exactly its path's kernels. Small hashed-table DBN, DCTR, CM and UBM,
    and GCTR and RCTR, on the DBN log; the reduced two-tower PBM and DCTR
    (8 features) and a mixture of PBM, DCTR and GCTR sharing one tower on a
    feature batch."""
    import numpy as np
    import torch

    from repro_torch.configs.clax_baidu import make_two_tower
    from repro_torch.convert import export_params, load_jax_params
    from repro_torch.core import (CascadeModel, Compression, DocumentCTR,
                                  DynamicBayesianNetwork,
                                  EmbeddingParameterConfig, GlobalCTR,
                                  MixtureModel, RankCTR, UserBrowsingModel)

    cfg = EmbeddingParameterConfig(
        parameters=4000, compression=Compression.HASH, compression_ratio=2.0,
        baseline_correction=True, init_logit=-2.0)
    kw = dict(positions=K_MAIN, attraction=cfg)

    def mixture(device):
        pbm = make_two_tower("pbm", features=8, device=device)
        dctr = DocumentCTR(positions=K_MAIN,
                           attraction=pbm.parts["attraction"], device=device)
        return MixtureModel([pbm, dctr, GlobalCTR(device=device)],
                            device=device)

    # name: (model factory, batch, launches of one GPU loss)
    table_rows = {k: v[:512] for k, v in data.items()}
    feature_rows = _feature_batch(512, 8, seed=5)
    paths = {
        "dbn": (lambda d: DynamicBayesianNetwork(device=d, satisfaction=cfg,
                                                 **kw),
                table_rows, {"examination_nll": 1}),
        "dctr": (lambda d: DocumentCTR(device=d, **kw), table_rows,
                 {"session_nll": 1}),
        "gctr": (lambda d: GlobalCTR(positions=K_MAIN, device=d), table_rows,
                 {"session_nll": 1}),
        "rctr": (lambda d: RankCTR(positions=K_MAIN, device=d), table_rows,
                 {"session_nll": 1}),
        "cm": (lambda d: CascadeModel(device=d, **kw), table_rows, {}),
        "ubm": (lambda d: UserBrowsingModel(device=d, **kw), table_rows, {}),
        "two_tower_pbm": (lambda d: make_two_tower("pbm", 8, d),
                          feature_rows, {"dcn_cross": 2}),
        "two_tower_dctr": (lambda d: make_two_tower("dctr", 8, d),
                           feature_rows, {"dcn_cross": 2, "session_nll": 1}),
        "mixture": (mixture, feature_rows, {"dcn_cross": 4}),
    }
    out = {}
    for name, (build, rows, expected) in paths.items():
        cpu = build("cpu")
        rng = np.random.default_rng(1)
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(torch.from_numpy(
                    rng.normal(scale=0.5, size=tuple(p.shape)).astype(
                        np.float32)))
        gpu = build("cuda")
        load_jax_params(gpu, export_params(cpu))
        losses = []
        for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
            reset_counts()
            loss = model.compute_loss(batch)
            loss.backward()
            check_counts(f"cpu_vs_gpu {name} {dev}",
                         expected if dev == "cuda" else {})
            losses.append(float(loss.detach()))
        check_close(f"cpu_vs_gpu {name} loss", losses[1], losses[0],
                    rtol=1e-5, atol=1e-5)
        worst = 0.0
        gpu_params = dict(gpu.named_parameters())
        for pname, pc in cpu.named_parameters():
            pg = gpu_params[pname]
            torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=1e-5,
                                       atol=1e-5, msg=lambda m: f"{name} "
                                       f"{pname}: {m}")
            worst = max(worst, float((pg.grad.cpu() - pc.grad).abs().max()))
        out[name] = {"loss_cpu": losses[0], "loss_gpu": losses[1],
                     "max_grad_abs_err": worst}
    emit("cpu_vs_gpu", **out)


# ---------------------------------------------------------------------------
# dcn_cross: the DCN-V2 cross layer of the two-tower click models
# ---------------------------------------------------------------------------

TOWER_ROWS = B_MAIN * K_MAIN      # the tower runs on every (session, item)


def dcn_bound(rows, dim, itemsize):
    """(bound_ms, bound_by): x0 and x read once, W and b read once, the
    float32 output written once; 2 D operations per output element for the
    product, 3 for the epilogue (+ b, * x0, + x)."""
    nbytes = (2 * rows * dim + dim * dim + dim) * itemsize + rows * dim * 4
    ops = rows * dim * (2 * dim + 3)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _dcn_inputs(gen, device, rows, dim, dtype=None, aliased=False,
                bound=None):
    """[x0, x, W, b] with the conformance harness's scales (W / sqrt(D)),
    cast to ``dtype``; x is x0 itself when ``aliased``; x0 and x uniform in
    [-bound, bound] when ``bound`` is given."""
    import torch

    def draw(*shape):
        if bound is None:
            return torch.randn(*shape, generator=gen, device=device)
        u = torch.rand(*shape, generator=gen, device=device)
        return (2.0 * u - 1.0) * bound

    x0 = draw(rows, dim)
    x = x0 if aliased else draw(rows, dim)
    w = torch.randn(dim, dim, generator=gen, device=device) / dim ** 0.5
    b = torch.randn(dim, generator=gen, device=device)
    if dtype is not None:
        x0, w, b = x0.to(dtype), w.to(dtype), b.to(dtype)
        x = x0 if aliased else x.to(dtype)
    return [x0, x, w, b]


def _dcn_cases(gen, device):
    """name: ([x0, x, W, b], tolerance): 1e-5 for float32 up to D = 130,
    1e-4 above, where a long dot's summation order differs; 2e-2 for
    bfloat16 (testing/conformance.py). ``_dcn_over`` applies it."""
    import torch

    def tol(dim, dtype=None):
        if dtype is torch.bfloat16:
            return 2e-2
        return 1e-5 if dim <= 130 else 1e-4

    cases = {}
    for rows, dim in ((8, 64), (256, 128), (300, 130), (5, 190), (64, 469),
                      (1, 1), (65536, 1024), (77, 24), (1000, 33)):
        cases[f"{rows}x{dim}"] = (_dcn_inputs(gen, device, rows, dim),
                                  tol(dim))
    for rows, dim in ((300, 130), (TOWER_ROWS, 16), (64, 469)):
        cases[f"bf16_{rows}x{dim}"] = (
            _dcn_inputs(gen, device, rows, dim, dtype=torch.bfloat16),
            tol(dim, torch.bfloat16))
    cases["abs36_4097x16"] = (_dcn_inputs(gen, device, 4097, 16, bound=36.0),
                              tol(16))
    args = _dcn_inputs(gen, device, 4097, 16, bound=36.0)
    args[1] = torch.where(args[1] >= 0, 36.0, -36.0)
    cases["x_at_36_4097x16"] = (args, tol(16))
    cases["aliased_main"] = (_dcn_inputs(gen, device, TOWER_ROWS, 16,
                                         aliased=True), tol(16))
    cases["aliased_300x130"] = (_dcn_inputs(gen, device, 300, 130,
                                            aliased=True), tol(130))
    cases["aliased_bf16_300x130"] = (
        _dcn_inputs(gen, device, 300, 130, dtype=torch.bfloat16,
                    aliased=True), tol(130, torch.bfloat16))
    return cases


def _dcn_over(got, x0, x, w, b, want, tol):
    """How far the worst element is past tol (1 + |x0| (|x| |W| + |b|) +
    |x|) (<= 0: held). The error of x0 (x W + b) + x scales with the size of
    its terms, not of its result: at |x| = 36 the terms reach ~1e3 and can
    cancel to a result near 0."""
    x0, x, w, b = (t.float() for t in (x0, x, w, b))
    size = x0.abs() * (x.abs() @ w.abs() + b.abs()) + x.abs()
    return float(((got - want).abs() - tol * (1.0 + size)).max())


def phase_dcn_kernel(card):
    """dcn_cross against its plain version at the two-tower's main shape
    (655,360 items x D = 16: the second cross layer, x != x0) and the edge
    cases; times of kernel and plain version at the main shape and at
    (65,536, 1024), beside their bounds. The composition
    addcmul(x, x0, addmm(b, x, W)) is timed as a yardstick: no single
    PyTorch call computes the layer."""
    import torch

    from repro_torch.kernels import dcn_cross_cuda, dcn_cross_plain

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    main = _dcn_inputs(gen, device, TOWER_ROWS, 16)
    cases = {"main": (main, 1e-5), **_dcn_cases(gen, device)}
    errs, over = {}, {}
    for case, (args, tol) in cases.items():
        got, want = dcn_cross_cuda(*args), dcn_cross_plain(*args)
        if (got.shape != want.shape or got.dtype != torch.float32
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"dcn_cross {case}: bad output")
        errs[case] = _max_err(got, want)
        over[case] = _dcn_over(got, *args, want, tol)
    torch.cuda.synchronize()
    emit("kernel_check", name="dcn_cross", abs_errs=errs)
    _hold("dcn_cross", over)

    def composition(x0, x, w, b):
        return torch.addcmul(x, x0, torch.addmm(b, x, w))

    wide = cases["65536x1024"][0]
    timing = {}
    for shape, args in (("main", main), ("65536x1024", wide)):
        iters = 100 if shape == "main" else 10
        timing[shape] = {
            "kernel_ms": time_ms(lambda: dcn_cross_cuda(*args), iters=iters),
            "plain_ms": time_ms(lambda: dcn_cross_plain(*args), iters=iters),
            "composition_ms": time_ms(lambda: composition(*args),
                                      iters=iters),
            "device_ms": {
                "kernel": graph_ms(lambda: dcn_cross_cuda(*args)),
                "plain": graph_ms(lambda: dcn_cross_plain(*args), calls=5),
                "composition": graph_ms(lambda: composition(*args))},
            "composition_abs_err": _max_err(composition(*args),
                                            dcn_cross_plain(*args)),
            "bound": dcn_bound(args[1].shape[0], args[1].shape[1], 4)}
    bound_ms, bound_by = timing["main"]["bound"]
    main_err = errs.pop("main")
    emit("kernel", name="dcn_cross", shape=[TOWER_ROWS, 16], card=card,
         kernel_ms=timing["main"]["kernel_ms"],
         plain_ms=timing["main"]["plain_ms"], library_ms=None,
         device_ms=timing["main"]["device_ms"], bound_ms=bound_ms,
         bound_by=bound_by, max_abs_err=main_err, edge_cases=len(errs),
         max_edge_abs_err=max(errs.values()), edge_abs_errs=errs,
         timing=timing)
    del main, wide, cases
    torch.cuda.empty_cache()
    return {"dcn_cross": {
        "name": "dcn_cross", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dcn_cross.cu",
        "replaces": "src/repro/kernels/dcn_cross.py:18",
        "max_abs_err": main_err, "ms": timing["main"]["kernel_ms"],
        "plain_ms": timing["main"]["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "device_ms": timing["main"]["device_ms"], "held": True}}


# ---------------------------------------------------------------------------
# the optimizer's kernels: dense AdamW in one pass, sparse lazy AdamW
# ---------------------------------------------------------------------------

DBN_ROWS = 214_748_672      # configs/clax_baidu.py: 2^31 ids hashed 10x
SPARSE_SLOTS = B_MAIN * K_MAIN
ADAMW_BYTES_PER_ELEMENT = {"float32": 28, "bfloat16": 20}
ADAMW_OPS_PER_ELEMENT = 16  # counted from csrc/adamw.cu, wd on
SECTOR = 32


def _adam_run(make_opt, params0, grads, steps, fused, start_count=0):
    """``steps`` updates of copies of ``params0``, the step count starting
    at ``start_count``: through optim.step (the kernel) or through update +
    apply_updates (the plain chain). Returns the parameters and the
    state."""
    from repro_torch import optim

    params = [p.clone() for p in params0]
    opt = make_opt()
    state = opt.init(params)
    state[0].count.fill_(start_count)
    for _ in range(steps):
        if fused:
            state = optim.step(opt, grads, state, params)
        else:
            updates, state = opt.update(grads, state, params)
            optim.apply_updates(params, updates)
            del updates
    return params, state


def _adam_compare(make_opt, params0, grads, steps=3, start_count=0):
    """Kernel against plain chain from the same inputs: max abs error of the
    parameters and the moments, whether each is equal to the bit, and how
    far past rtol = atol = 1e-6 they are (one or two ulps of values of
    order 1)."""
    import torch

    out = {}
    runs = []
    for fused in (True, False):
        params, state = _adam_run(make_opt, params0, grads, steps, fused,
                                  start_count)
        runs.append((params, state[0].mu, state[0].nu))
        out["count"] = int(state[0].count)
    (pk, mk, vk), (pp, mp, vp) = runs
    out["params_abs_err"] = max(_max_err(a, b) for a, b in zip(pk, pp))
    out["moments_abs_err"] = max(_max_err(a.float(), b.float())
                                 for a, b in zip(mk + vk, mp + vp))
    out["params_bit_equal"] = all(torch.equal(a, b) for a, b in zip(pk, pp))
    out["moments_bit_equal"] = all(torch.equal(a, b)
                                   for a, b in zip(mk + vk, mp + vp))
    out["over"] = max([_over(a, b, 1e-6, 1e-6) for a, b in zip(pk, pp)]
                      + [_over(a.float(), b.float(), 1e-6, 1e-6)
                         for a, b in zip(mk + vk, mp + vp)])
    return out


def _adam_pred_forms(make_opt, params0, grads):
    """The fused pass with a step predicate (the non-finite guard's, a
    sweep's active replica) from the same inputs as without one: two steps
    with pred = True equal two steps without a predicate to the bit
    (parameters, both moments, the count), and a step with pred = False
    after one without leaves everything as that one step left it."""
    import torch

    from repro_torch import optim
    from repro_torch.train.capture import tree_leaves

    device = params0[0].device
    yes = torch.ones((), dtype=torch.bool, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)

    def run(preds):
        params = [p.clone() for p in params0]
        opt = make_opt()
        state = opt.init(params)
        for pred in preds:
            state = optim.step(opt, grads, state, params, pred)
        return params + tree_leaves(state)

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys, strict=True))

    out = {"pred_true_bit_equal": same(run([None, None]), run([yes, yes]))}
    torch.cuda.empty_cache()
    out["pred_false_unchanged"] = same(run([None]), run([None, no]))
    torch.cuda.empty_cache()
    return out


def _adam_norm_forms(make_opt, params0, grads):
    """The fused pass's norm mode (the telemetry's ``param_norm``) from the
    same inputs, for ``apply`` and ``pred`` each True and False: it writes
    what the predicate form writes under ``pred & apply``, to the bit, and
    its sum of squares is the plain chain's over the parameters the step
    would write under ``apply`` alone (the updated ones where it holds,
    else as they stand), within 1e-5."""
    import torch

    from repro_torch import optim
    from repro_torch.train.capture import tree_leaves

    device = params0[0].device

    def fresh():
        params = [p.clone() for p in params0]
        opt = make_opt()
        return params, opt, opt.init(params)

    def sumsq(tensors):
        return float(sum(torch.sum(t.double() ** 2) for t in tensors))

    params, opt, state = fresh()
    updates, _ = opt.update(grads, state, params)
    optim.apply_updates(params, updates)
    plain = {True: sumsq(params), False: sumsq(params0)}
    del params, opt, state, updates
    torch.cuda.empty_cache()
    out = {}
    for apply in (True, False):
        for pred in (True, False):
            a, p = (torch.full((), x, dtype=torch.bool, device=device)
                    for x in (apply, pred))
            params, opt, state = fresh()
            state, got = optim.step(opt, grads, state, params, p, norm=True,
                                    apply=a)
            got = float(got)
            leaves = params + tree_leaves(state)
            del params, state
            ref, ropt, rstate = fresh()
            rstate = optim.step(ropt, grads, rstate, ref, p & a)
            bits = all(torch.equal(x, y) for x, y in zip(
                leaves, ref + tree_leaves(rstate), strict=True))
            rel = abs(got - plain[apply]) / plain[apply]
            out[f"apply_{apply}_pred_{pred}"] = {
                "writes_bit_equal_pred_form": bits, "sumsq_rel_err": rel}
            del leaves, ref, rstate
            torch.cuda.empty_cache()
            if not bits or rel > 1e-5:
                raise AssertionError(f"adamw norm mode, apply {apply}, pred "
                                     f"{pred}: {out}")
    return out


def _decay_sensitivity(run):
    """How many times past the hold's tolerance (rtol = atol = 1e-6) the
    plain form without weight decay lands from the plain form with it,
    ``run(wd)`` giving the parameters after a decay edge case's steps: a
    kernel that dropped the decay term would be that far off."""
    with_decay, without = run(0.1), run(0.0)
    return float(((without - with_decay).abs()
                  / (1e-6 + 1e-6 * with_decay.abs())).max())


def _check_sensitive(name, times):
    if not times > 100.0:
        raise AssertionError(f"{name}: the decay edge case is only {times} "
                             f"tolerances from its no-decay form")


def adamw_bound(n, moments="float32"):
    t_bytes = n * ADAMW_BYTES_PER_ELEMENT[moments] / PEAK_BYTES_PER_S
    t_ops = n * ADAMW_OPS_PER_ELEMENT / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sparse_adamw_bound(live_rows, slots):
    """For a (R, 1) float32 table and moments: each distinct 32-byte sector
    that this run's touched rows fall in (eight rows a sector), read and
    written, in each of p, m and v; every slot's 8-byte id, and each live
    slot's 4-byte gradient (the kernel reads no gradient of a sentinel
    slot), read in order."""
    import torch

    sectors = torch.unique(live_rows // (SECTOR // 4)).numel()
    t_bytes = (sectors * 6 * SECTOR + slots * 8
               + live_rows.numel() * 4) / PEAK_BYTES_PER_S
    t_ops = live_rows.numel() * ADAMW_OPS_PER_ELEMENT / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_optimizer_kernels(card, data):
    """adamw over the paper-width DBN's two 214,748,672-row tables, against
    the plain chain (three steps from the same inputs) and timed beside
    torch.optim.AdamW(fused=True) on the same tensors (which applies the
    decay first, p *= 1 - lr wd: another order, so it is timed, not held);
    its edge cases. sparse_adamw over one table at the 655,360 slots of
    ``data``'s first batch (the train_dbn_sparse path's ids), with sentinel
    padding, against its plain version, rows it did not touch equal to the
    bit, row 0 untouched and row R-1 touched; timed beside
    torch.optim.SparseAdam (no weight decay: another function, timed at
    wd = 0). Each kernel has an edge case where the decay term moves the
    parameters far past the tolerance, checked to be so."""
    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.core.parameterization import hash_ids
    from repro_torch.kernels import sparse_adamw_cuda, sparse_adamw_plain
    from repro_torch.optim.sparse import (init_sparse_table_state,
                                          unique_rows_with_sentinel)

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    results = {}

    def adamw_3e3():
        return optim.adamw(3e-3, weight_decay=1e-4)

    # --- adamw: the DBN's two tables, (R, 1) float32 -----------------------
    params = [torch.randn(DBN_ROWS, 1, generator=gen, device=device) * 0.5
              for _ in range(2)]
    grads = [torch.randn(DBN_ROWS, 1, generator=gen, device=device) * 1e-3
             for _ in range(2)]
    main = _adam_compare(adamw_3e3, params, grads, steps=2)
    torch.cuda.synchronize()
    opt = adamw_3e3()
    work = [p.clone() for p in params]
    state = opt.init(work)
    ms = time_ms(lambda: optim.step(opt, grads, state, work), iters=20,
                 warmup=2)
    device_ms = {"kernel": graph_ms(lambda: optim.step(opt, grads, state,
                                                       work),
                                    calls=5, replays=4)}

    def plain_step():
        updates, _ = opt.update(grads, state, work)
        optim.apply_updates(work, updates)

    plain_ms = time_ms(plain_step, iters=5, warmup=1)
    del work, state
    torch.cuda.empty_cache()
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.AdamW(lib_params, lr=3e-3, weight_decay=1e-4,
                            fused=True)
    library_ms = time_ms(lib.step, iters=20, warmup=2)
    del lib, lib_params
    torch.cuda.empty_cache()
    bound_ms, bound_by = adamw_bound(2 * DBN_ROWS)
    # The predicate forms at the main shape: held to the bit, and timed
    # (pred = True does the same work; pred = False reads one byte).
    predicate = _adam_pred_forms(adamw_3e3, params, grads)
    work = [p.clone() for p in params]
    state = opt.init(work)
    for name, value in (("kernel_pred_true", True),
                        ("kernel_pred_false", False)):
        pred = torch.full((), value, dtype=torch.bool, device=device)
        device_ms[name] = graph_ms(
            lambda: optim.step(opt, grads, state, work, pred), calls=5,
            replays=4)
    del work, state
    torch.cuda.empty_cache()
    if not all(predicate.values()):
        raise AssertionError(f"adamw predicate forms: {predicate}")
    norm_forms = _adam_norm_forms(adamw_3e3, params, grads)

    edges = {}
    small = {"n1": (1,), "n7": (7,), "n1000003": (1_000_003,),
             "10x10": (10, 10), "scalar": ()}
    for case, shape in small.items():
        p = [torch.randn(shape, generator=gen, device=device)]
        g = [torch.randn(shape, generator=gen, device=device) * 3]
        edges[case] = _adam_compare(adamw_3e3, p, g)
    p = [torch.randn(4099, generator=gen, device=device)]
    g = [torch.randn(4099, generator=gen, device=device)]
    edges["bf16_moments"] = _adam_compare(
        lambda: optim.adamw(3e-3, weight_decay=1e-4,
                            moment_dtype=torch.bfloat16), p, g)
    edges["injected_lr"] = _adam_compare(
        lambda: optim.adamw(3e-3, weight_decay=1e-4, inject_lr=True), p, g)
    edges["adam_no_decay"] = _adam_compare(lambda: optim.adam(3e-3), p, g)
    edges["count_1"] = _adam_compare(adamw_3e3, p, g, steps=1)
    edges["count_10000"] = _adam_compare(adamw_3e3, p, g, steps=1,
                                         start_count=9_999)
    # a view one float past an aligned start: the element-by-element path
    base = torch.randn(4100, generator=gen, device=device)
    edges["unaligned_view"] = _adam_compare(adamw_3e3, [base[1:]],
                                            [g[0][:4099]])
    # The main case's decay moves p by lr wd |p| = 3e-7 |p| a step, inside
    # the tolerance: here it moves it by 5e-3 |p|, so a kernel that dropped
    # the term would fail. `decay_sensitivity` says by how many tolerances.
    edges["decay_dominant"] = _adam_compare(
        lambda: optim.adamw(0.05, weight_decay=0.1), p, g, steps=5)
    decay_sensitivity = {"adamw": _decay_sensitivity(
        lambda wd: _adam_run(lambda: optim.adamw(0.05, weight_decay=wd),
                             p, g, 5, False)[0][0])}
    # The chain on the CPU, whose division is a true division: the kernel
    # keeps its arithmetic, so the bits should agree.
    p = [torch.randn(1_000_003, generator=gen, device=device)]
    g = [torch.randn(1_000_003, generator=gen, device=device) * 3]
    kp, ks = _adam_run(adamw_3e3, p, g, 3, True)
    cp, cs = _adam_run(adamw_3e3, [x.cpu() for x in p], [x.cpu() for x in g],
                       3, False)
    vs_cpu_chain = {
        "params_abs_err": _max_err(kp[0].cpu(), cp[0]),
        "params_bit_equal": bool(torch.equal(kp[0].cpu(), cp[0])),
        "moments_bit_equal": bool(torch.equal(ks[0].mu[0].cpu(), cs[0].mu[0])
                                  and torch.equal(ks[0].nu[0].cpu(),
                                                  cs[0].nu[0]))}
    over = {"main": main.pop("over"),
            "vs_cpu_chain": _over(kp[0].cpu(), cp[0], 1e-6, 1e-6),
            **{case: e.pop("over") for case, e in edges.items()}}
    if edges["count_10000"]["count"] != 10_000:
        raise AssertionError(f"adamw count {edges['count_10000']['count']}")
    _check_sensitive("adamw", decay_sensitivity["adamw"])
    emit("kernel", name="adamw", shape=[2, DBN_ROWS, 1], card=card,
         kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         library="torch.optim.AdamW(fused=True): decays p first, another "
                 "order; timed, not held",
         device_ms=device_ms, bound_ms=bound_ms, bound_by=bound_by,
         max_abs_err=main["params_abs_err"], main=main,
         vs_cpu_chain=vs_cpu_chain, edge_cases=edges, predicate=predicate,
         norm_forms=norm_forms,
         decay_sensitivity=decay_sensitivity["adamw"])
    _hold("adamw", over)
    results["adamw"] = {
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "src/repro/optim/optimizers.py:93 (no pallas_call: the "
                    "loop XLA fuses from scale_by_adam, add_decayed_weights "
                    "and scale)",
        "max_abs_err": main["params_abs_err"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "device_ms": device_ms,
        "predicate": predicate, "held": True}
    del params, grads
    torch.cuda.empty_cache()

    # --- sparse_adamw: one DBN table, a batch's 655,360 slots --------------
    # The ids the train_dbn_sparse path sends: the first batch of its
    # synthetic log, hashed into the table as row_ids does, so the touched
    # rows lie scattered over it.
    ids = hash_ids(torch.from_numpy(
        data["query_doc_ids"][:B_MAIN].reshape(-1)).to(device), DBN_ROWS)
    ids = torch.where(ids == 0, 1, ids)  # row 0 stays untouched
    ids[0] = DBN_ROWS - 1                # row R-1 is touched
    rows = unique_rows_with_sentinel(ids, DBN_ROWS)
    live = int((rows < DBN_ROWS).sum())
    # Unhashed Zipf ranks, the hot rows side by side at the table's start:
    # an edge case of the same size.
    rng = np.random.default_rng(5)
    draws = rng.zipf(1.2, SPARSE_SLOTS) % (DBN_ROWS - 2) + 1  # never row 0
    draws[rng.integers(0, SPARSE_SLOTS)] = DBN_ROWS - 1
    zipf_rows = unique_rows_with_sentinel(
        torch.from_numpy(draws.astype(np.int64)).to(device), DBN_ROWS)
    zipf_live = int((zipf_rows < DBN_ROWS).sum())
    before = torch.randn(DBN_ROWS, 1, generator=gen, device=device) * 0.5
    row_grads = torch.randn(SPARSE_SLOTS, 1, generator=gen, device=device)
    kw = dict(lr=3e-3, weight_decay=1e-4)

    def run(kernel, base, rows_, grads_, steps, kw_, mdt=torch.float32,
            preds=None):
        t = base.clone()
        st = init_sparse_table_state(t, mdt)
        for i in range(steps):
            pred = None if preds is None else preds[i]
            st.count.add_(1 if pred is None else pred)
            kernel(t, st.mu, st.nu, rows_, grads_, st.count, pred=pred,
                   **kw_)
        return t, st

    (tk, sk), (tp, sp) = [run(kernel, before, rows, row_grads, 2, kw)
                          for kernel in (sparse_adamw_cuda,
                                         sparse_adamw_plain)]
    torch.cuda.synchronize()
    touched = torch.zeros(DBN_ROWS, dtype=torch.bool, device=device)
    touched[ids] = True
    checks = {
        "untouched_rows_bit_equal": bool(torch.equal(tk[~touched],
                                                     before[~touched])),
        "untouched_moments_zero": bool((sk.mu[~touched] == 0).all()
                                       and (sk.nu[~touched] == 0).all()),
        "row_0_untouched": bool(torch.equal(tk[0], before[0])),
        "row_last_touched": bool(not torch.equal(tk[-1], before[-1])),
        "moments_bit_equal": bool(torch.equal(sk.mu, sp.mu)
                                  and torch.equal(sk.nu, sp.nu)),
        "params_bit_equal": bool(torch.equal(tk, tp))}
    err = _max_err(tk, tp)
    s_over = {"main": max(_over(tk, tp, 1e-6, 1e-6),
                          _over(sk.mu, sp.mu, 1e-6, 1e-6),
                          _over(sk.nu, sp.nu, 1e-6, 1e-6))}
    del tk, sk, tp, sp
    torch.cuda.empty_cache()
    # the predicate forms, as for adamw: True is the kernel without one to
    # the bit, False writes nothing
    yes = torch.ones((), dtype=torch.bool, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            (a[0], a[1].count, a[1].mu, a[1].nu),
            (b[0], b[1].count, b[1].mu, b[1].nu)))

    s_predicate = {"pred_true_bit_equal": same(
        run(sparse_adamw_cuda, before, rows, row_grads, 2, kw),
        run(sparse_adamw_cuda, before, rows, row_grads, 2, kw,
            preds=[yes, yes]))}
    torch.cuda.empty_cache()
    s_predicate["pred_false_unchanged"] = same(
        run(sparse_adamw_cuda, before, rows, row_grads, 1, kw),
        run(sparse_adamw_cuda, before, rows, row_grads, 2, kw,
            preds=[None, no]))
    torch.cuda.empty_cache()
    if not all(s_predicate.values()):
        raise AssertionError(f"sparse_adamw predicate forms: {s_predicate}")
    # the norm mode (the telemetry's param_norm), apply and pred each True
    # and False: the kernel writes what the predicate form writes under
    # pred & apply, to the bit, and the touched rows' sum of squares it
    # implies (theirs before plus its p'^2 - p^2) is the plain form's,
    # within 1e-5
    touched_before = float(torch.sum(before[rows[:live]].double() ** 2))

    def norm_run(kernel, apply, pred):
        t = before.clone()
        st = init_sparse_table_state(t)
        count = st.count + apply
        st.count.add_(pred & apply)
        delta = kernel(t, st.mu, st.nu, rows, row_grads, count,
                       pred=pred & apply, norm=True, apply=apply, **kw)
        return (t, st), touched_before + float(delta)

    s_norm_forms = {}
    for apply in (yes, no):
        for pred in (yes, no):
            (kernel_out, got) = norm_run(sparse_adamw_cuda, apply, pred)
            bits = same(kernel_out, run(sparse_adamw_cuda, before, rows,
                                        row_grads, 1, kw,
                                        preds=[pred & apply]))
            del kernel_out
            torch.cuda.empty_cache()
            _, want = norm_run(sparse_adamw_plain, apply, pred)
            torch.cuda.empty_cache()
            rel = abs(got - want) / want
            s_norm_forms[f"apply_{bool(apply)}_pred_{bool(pred)}"] = {
                "writes_bit_equal_pred_form": bits,
                "touched_sumsq_rel_err": rel}
            if not bits or rel > 1e-5:
                raise AssertionError(f"sparse_adamw norm mode: "
                                     f"{s_norm_forms}")
    (tk, sk), (tp, sp) = [run(kernel, before, zipf_rows, row_grads, 2, kw)
                          for kernel in (sparse_adamw_cuda,
                                         sparse_adamw_plain)]
    s_over["zipf_ranks"] = max(_over(tk, tp, 1e-6, 1e-6),
                               _over(sk.mu, sp.mu, 1e-6, 1e-6),
                               _over(sk.nu, sp.nu, 1e-6, 1e-6))
    checks["zipf_ranks_abs_err"] = _max_err(tk, tp)
    del tk, sk, tp, sp
    torch.cuda.empty_cache()
    # edges: d = 3 rows, bfloat16 moments, a slot of every id in [0, 64),
    # and lr wd |p| = 5e-3 a step (the main case's 3e-7 |p| is inside the
    # tolerance), where a kernel without the decay term would fail
    decay_kw = dict(lr=0.05, weight_decay=0.1)
    for case, (n_rows, d, mdt, n_ids, steps, case_kw) in {
            "d3": (1000, 3, torch.float32, 700, 3, kw),
            "bf16_moments": (1000, 1, torch.bfloat16, 700, 3, kw),
            "every_row": (64, 2, torch.float32, 64, 3, kw),
            "decay_dominant": (1000, 3, torch.float32, 700, 5,
                               decay_kw)}.items():
        e_ids = torch.randint(0, n_rows, (n_ids,), generator=gen,
                              device=device)
        if case == "every_row":
            e_ids = torch.randperm(n_rows, generator=gen, device=device)
        e_rows = unique_rows_with_sentinel(e_ids, n_rows)
        e_g = torch.randn(n_ids, d, generator=gen, device=device)
        base = torch.randn(n_rows, d, generator=gen, device=device)
        outs = [run(kernel, base, e_rows, e_g, steps, case_kw, mdt)
                for kernel in (sparse_adamw_cuda, sparse_adamw_plain)]
        s_over[case] = max(_over(outs[0][0], outs[1][0], 1e-6, 1e-6),
                           _over(outs[0][1].mu.float(),
                                 outs[1][1].mu.float(), 1e-6, 1e-6))
        checks[f"{case}_abs_err"] = _max_err(outs[0][0], outs[1][0])
        if case == "d3":
            # the plain form on the CPU, whose division is a true division
            t, st = run(sparse_adamw_plain, base.cpu(), e_rows.cpu(),
                        e_g.cpu(), steps, kw)
            checks["d3_vs_cpu_plain_bit_equal"] = bool(
                torch.equal(outs[0][0].cpu(), t)
                and torch.equal(outs[0][1].mu.cpu(), st.mu)
                and torch.equal(outs[0][1].nu.cpu(), st.nu))
        if case == "decay_dominant":
            decay_sensitivity["sparse_adamw"] = _decay_sensitivity(
                lambda wd: run(sparse_adamw_plain, base, e_rows, e_g, steps,
                               dict(lr=0.05, weight_decay=wd))[0])
    _check_sensitive("sparse_adamw", decay_sensitivity["sparse_adamw"])
    t = before.clone()
    st = init_sparse_table_state(t)

    def sparse_kernel(rows_=rows, pred=None):
        sparse_adamw_cuda(t, st.mu, st.nu, rows_, row_grads, st.count,
                          pred=pred, **kw)

    s_ms = time_ms(sparse_kernel, iters=100)
    s_device = {"kernel": graph_ms(sparse_kernel),
                "kernel_pred_true": graph_ms(lambda: sparse_kernel(pred=yes)),
                "kernel_pred_false": graph_ms(
                    lambda: sparse_kernel(pred=no)),
                "dedupe": graph_ms(lambda: unique_rows_with_sentinel(
                    ids, DBN_ROWS)),
                "zipf_ranks_kernel": graph_ms(
                    lambda: sparse_kernel(zipf_rows))}
    s_plain_ms = time_ms(lambda: sparse_adamw_plain(
        t, st.mu, st.nu, rows, row_grads, st.count, **kw), iters=5,
        warmup=1)
    dedupe_ms = time_ms(lambda: unique_rows_with_sentinel(ids, DBN_ROWS),
                        iters=50)
    del t, st
    torch.cuda.empty_cache()
    lib_param = torch.nn.Parameter(before)
    live_rows = rows[:live]
    lib_param.grad = torch.sparse_coo_tensor(
        live_rows[None], row_grads[:live], (DBN_ROWS, 1)).coalesce()
    lib = torch.optim.SparseAdam([lib_param], lr=3e-3)
    s_library_ms = time_ms(lib.step, iters=20, warmup=2)
    del lib, lib_param
    s_bound_ms, s_bound_by = sparse_adamw_bound(live_rows, SPARSE_SLOTS)
    zipf_bound_ms, _ = sparse_adamw_bound(zipf_rows[:zipf_live],
                                          SPARSE_SLOTS)
    emit("kernel", name="sparse_adamw", shape=[DBN_ROWS, 1, SPARSE_SLOTS],
         live_rows=live, card=card, kernel_ms=s_ms, plain_ms=s_plain_ms,
         library_ms=s_library_ms,
         library="torch.optim.SparseAdam on the live rows' COO gradient "
                 "(no weight decay: timed, not held)",
         dedupe_ms=dedupe_ms, device_ms=s_device, bound_ms=s_bound_ms,
         bound_by=s_bound_by, max_abs_err=err, checks=checks,
         zipf_ranks={"live_rows": zipf_live, "bound_ms": zipf_bound_ms},
         predicate=s_predicate, norm_forms=s_norm_forms,
         decay_sensitivity=decay_sensitivity["sparse_adamw"])
    _hold("sparse_adamw", s_over)
    # Held: untouched rows and the moments; the parameters are held at the
    # tolerance above (the plain form on the card can differ in the last
    # bit), and the CPU comparison is reported.
    for name, ok in checks.items():
        if ok is False and name not in ("params_bit_equal",
                                        "d3_vs_cpu_plain_bit_equal"):
            raise AssertionError(f"sparse_adamw: {name} failed")
    results["sparse_adamw"] = {
        "name": "sparse_adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_adamw.cu",
        "replaces": "src/repro/optim/sparse.py:105 (no pallas_call: the "
                    "gathers and drop-mode scatters XLA fuses from "
                    "sparse_adamw_update)",
        "max_abs_err": err, "ms": s_ms, "plain_ms": s_plain_ms,
        "bound_ms": s_bound_ms, "bound_by": s_bound_by,
        "library_ms": s_library_ms, "device_ms": s_device,
        "predicate": s_predicate, "held": True}
    del before, touched, ids, rows, zipf_rows, row_grads
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# recsys: the three kernels of DeepFM and AutoInt
# ---------------------------------------------------------------------------

TABLE_ROWS = 80_000_000     # configs/deepfm.py, configs/autoint.py
N_FIELDS = 39
FM_D = 10                   # DeepFM's embed_dim
ATTN = (65536, 2, 2, 39, 39, 16)  # AutoInt: (B, Hq, Hkv, Sq, Skv, Dh)


class CriteoLog:
    """A synthetic Criteo-shaped click log made on the card from a seed:
    39 fields with disjoint id ranges of 80,000,000 / 39 rows each inside
    the unified table, Zipf-skewed ids within each field (rank r drawn with
    density ~ 1/r, so a field's top ids are most of its traffic), and
    labels from a planted logistic model (a random weight per id, summed
    over the fields, base rate ~25%), so there is something to learn. Ids
    are int32, as the JAX package hands them over (the table has fewer
    than 2^31 rows)."""

    def __init__(self, device, seed=0, rows=TABLE_ROWS, fields=N_FIELDS):
        import torch

        self.fields, self.span = fields, rows // fields
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device = device
        self.offsets = torch.arange(fields, device=device) * self.span
        self.planted = torch.randn(rows, generator=self.gen,
                                   device=device) * 0.7

    def field_ids(self, n):
        import torch

        u = torch.rand(n, self.fields, generator=self.gen, device=self.device)
        rank = torch.floor(torch.pow(float(self.span), u)).long() - 1
        return (rank.clamp_(0, self.span - 1) + self.offsets).int()

    def batch(self, n):
        import torch

        ids = self.field_ids(n)
        logit = self.planted[ids].sum(1) / math.sqrt(self.fields) - 1.2
        labels = (torch.rand(n, generator=self.gen, device=self.device)
                  < torch.sigmoid(logit)).float()
        return {"field_ids": ids, "labels": labels}

    def candidates(self, n, query_fields=13):
        """One query's first ``query_fields`` fields beside ``n`` candidate
        rows' other fields: the candidate-expanded field matrix."""
        ids = self.field_ids(n)
        ids[:, :query_fields] = ids[0, :query_fields]
        return {"field_ids": ids}


def bag_bound(table, ids, weights):
    """(bound_ms, bound_by) of one bag call on these inputs: ids (and
    weights) read once, each 32-byte table sector that a live id touches
    read once, the output written once; a multiply-add per gathered float.
    Ids are counted at 4 bytes while the table has fewer than 2^31 rows
    (the function needs no more; the TPU kernel reads int32), whatever
    width the caller hands over. For rows of at most
    32 bytes (D <= 8; DeepFM's first-order D = 1), each touching one or
    two sectors; the table starts on a sector boundary (torch allocations
    do)."""
    import torch

    rows, dim = table.shape
    if dim * 4 > 32:
        raise ValueError(f"bag_bound counts rows of <= 32 bytes, got D={dim}")
    live = torch.clamp(ids[ids >= 0].long(), max=rows - 1)
    sectors = int(torch.unique(torch.cat([
        live * dim * 4 // 32, ((live + 1) * dim * 4 - 1) // 32])).numel())
    id_bytes = 4 if rows < 2 ** 31 else 8
    nbytes = (ids.numel() * id_bytes + sectors * 32
              + ids.shape[0] * dim * 4
              + (0 if weights is None else weights.numel() * 4))
    ops = 2 * ids.numel() * dim
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fm_bound(v):
    B, F, D = v.shape
    t_bytes = (B * F * D * 4 + B * 4) / PEAK_BYTES_PER_S
    t_ops = 4 * B * F * D / PEAK_FP32_PER_S  # add, square, add; subtract
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_bound(q, k, v):
    """Non-causal: q, k, v read once, o written once, in their own type;
    per (query, key) pair 2 Dh operations for the score, 2 Dh for the
    weighted sum, one exp, all float32."""
    B, Hq, Sq, Dh = q.shape
    pairs = Sq * k.shape[2]
    t_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()
                                  ) / PEAK_BYTES_PER_S
    t_ops = B * Hq * pairs * (4 * Dh + 1) / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, want):
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max())


def _over(got, want, atol, rtol=1e-5):
    """How far the worst element is past atol + rtol |want| (<= 0: held)."""
    if got.numel() == 0:
        return 0.0
    excess = (got.float() - want.float()).abs() - (atol + rtol * want.abs())
    return float(excess.max())


def _bag_cases(gen, device):
    """Edge cases of embedding_bag: [table, ids, weights] by name."""
    import torch

    def make(B, L, N, D, weighted=True, pad=0.1):
        table = torch.randn(N, D, generator=gen, device=device)
        ids = torch.randint(0, N, (B, L), generator=gen, device=device)
        ids[torch.rand(B, L, generator=gen, device=device) < pad] = -1
        w = (torch.rand(B, L, generator=gen, device=device) * 0.8 + 0.2
             if weighted else None)
        return [table, ids, w]

    cases = {f"B{B}_L{L}_D{D}": make(B, L, 1000, D)
             for B, L, D in ((7, 3, 64), (8, 1, 128), (5, 4, 130),
                             (1, 39, 1), (257, 39, 1), (1000, 39, 3),
                             (257, 130, 1), (255, 130, 16), (33, 130, 64),
                             (1000, 39, 16), (300, 39, 17))}
    cases["L1_unweighted"] = make(4097, 1, 5000, 1, weighted=False)
    args = make(300, 39, 1000, 16)
    args[1][:] = -1
    cases["all_padding"] = args
    args = make(65536, 39, 1000, 1, weighted=False, pad=0.0)
    args[1][:] = 7  # every bag on one hot row
    cases["hot_row"] = args
    # Ids past the table read its last row (bag_lookup's clip).
    for D, weighted in ((1, False), (16, True), (64, True)):
        args = make(257, 39, 1000, D, weighted=weighted)
        args[1] = torch.where(args[1] >= 0, args[1] * 3, -1)
        cases[f"ids_past_rows_D{D}"] = args
    # Every case again with int32 ids.
    for case, args in list(cases.items()):
        cases[f"{case}_int32"] = [args[0], args[1].int(), args[2]]
    # A ragged tail and a tile whose spans start off 16 bytes.
    args = make(1001, 39, 1000, 1)
    cases["offset_view_int32"] = [args[0], args[1].int()[1:], args[2][1:]]
    return cases


def _fm_cases(gen, device):
    import torch

    cases = {f"{B}x{F}x{D}": torch.randn(B, F, D, generator=gen,
                                         device=device)
             for B, F, D in ((1, 39, 10), (127, 39, 10), (129, 39, 10),
                             (64, 1, 10), (64, 39, 1), (33, 39, 130),
                             (8, 5, 64), (130, 4, 130))}
    # Large |v| around a common offset: the two sums nearly cancel.
    cases["cancellation"] = 1e3 + 10.0 * torch.randn(
        257, 39, 10, generator=gen, device=device)
    return cases


def _attn_inputs(gen, device, B, Hq, Hkv, Sq, Skv, Dh):
    import torch

    q = torch.randn(B, Hq, Sq, Dh, generator=gen, device=device) / Dh ** 0.5
    k = torch.randn(B, Hkv, Skv, Dh, generator=gen, device=device)
    v = torch.randn(B, Hkv, Skv, Dh, generator=gen, device=device)
    return [q, k, v]


def _autoint_layout(args):
    """The same values as transpose(1, 2) views of contiguous (B, S, H, Dh)
    tensors: the layout AutoInt's projections hand the kernel."""
    return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in args]


def _flash_cases(gen, device):
    """([q, k, v], causal) by name, from (B, Hq, Hkv, Sq, Skv, Dh, causal)."""
    shapes = {"conf_2x4x2x16x16x32": (2, 4, 2, 16, 16, 32, False),
              "conf_1x2x2x128x128x64": (1, 2, 2, 128, 128, 64, False),
              "conf_1x2x1x130x130x64": (1, 2, 1, 130, 130, 64, False),
              "gqa_4to1": (3, 8, 2, 39, 39, 16, False),
              "causal_decode_1x130": (2, 4, 2, 1, 130, 64, True),
              "causal_16x40": (2, 4, 2, 16, 40, 32, True),
              "causal_square_200": (1, 2, 2, 200, 200, 32, True),
              "dh64": (4, 2, 2, 39, 39, 64, False),
              "dh128": (2, 2, 2, 100, 100, 128, False),
              "dh4_reduced_autoint": (16, 2, 2, 8, 8, 4, False),
              "ragged_b_autoint": (129, 2, 2, 39, 39, 16, False),
              "causal_rows_dh16": (7, 4, 2, 20, 39, 16, True),
              "gqa_3to1_dh8": (33, 3, 1, 10, 12, 8, False)}
    return {name: (_attn_inputs(gen, device, *shape[:6]), shape[6])
            for name, shape in shapes.items()}


def _hold(name, over):
    """Raise, after every case was measured, if any case is past its
    tolerance."""
    bad = {case: x for case, x in over.items() if not x <= 0.0}
    if bad:
        raise AssertionError(f"{name}: kernel vs plain past tolerance by "
                             f"{bad}")


def phase_recsys_kernels(card):
    """embedding_bag, fm_interaction and flash_attention against their plain
    versions on the card. Tolerances, with their reasons:

    * embedding_bag: rtol 1e-5, atol 1e-5. The same products, summed in
      slot order with fma in the kernel and by torch.sum in the plain one.
    * fm_interaction: rtol 1e-5, atol 1e-5 * sum_{f,d} v^2 of the row. The
      result is a difference of two sums of that size, so rounding in
      either sum shows at that scale whatever the order.
    * flash_attention: rtol 1e-5, atol 1e-5 for float32 (the conformance
      contract): online softmax rescales per 8 keys (rows variant) or 16
      (tiles) where the plain one takes one max, and exp2 is within 2 ulp;
      rtol 2e-2, atol 2e-2 for bfloat16 inputs (the conformance bfloat16
      contract), the output rounded to bfloat16 by both forms.
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (embedding_bag_cuda, embedding_bag_plain,
                                     flash_attention_cuda,
                                     flash_attention_plain,
                                     fm_interaction_plain,
                                     fm_interaction_triton)
    from repro_torch.kernels.embedding_bag import plan_for as bag_plan_for
    from repro_torch.kernels.flash_attention import plan_for

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    results = {}

    def record(name, route, source, replaces, shape, kernel, plain, library,
               args, errs, bnd):
        t0 = time.perf_counter()
        ms = time_ms(lambda: kernel(*args), iters=100)
        plain_ms = time_ms(lambda: plain(*args), iters=20)
        device_ms = {"kernel": graph_ms(lambda: kernel(*args)),
                     "plain": graph_ms(lambda: plain(*args), calls=5)}
        library_ms = None
        if library is not None:
            library_ms = time_ms(lambda: library(*args), iters=100)
            device_ms["library"] = graph_ms(lambda: library(*args))
        bound_ms, bound_by = bnd
        main_err = errs.pop("main")
        results[name] = {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": device_ms, "held": True}
        emit("kernel", name=name, shape=shape, card=card, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, device_ms=device_ms,
             bound_ms=bound_ms, bound_by=bound_by, max_abs_err=main_err,
             edge_cases=len(errs), max_edge_abs_err=max(errs.values()),
             edge_abs_errs=errs, timing_s=time.perf_counter() - t0)

    # embedding_bag: DeepFM's first-order bag over the real (80M, 1) table,
    # unweighted, with the int32 ids DeepFM hands over; and the same ids as
    # int64.
    log = CriteoLog(device, seed=1)
    table = torch.randn(TABLE_ROWS, 1, generator=gen, device=device)
    main = [table, log.field_ids(B_MAIN), None]
    main64 = [table, main[1].long(), None]
    cases = {"main": main, "main_int64": main64, **_bag_cases(gen, device)}
    errs, over, variants = {}, {}, {}
    for case, args in cases.items():
        got, want = embedding_bag_cuda(*args), embedding_bag_plain(*args)
        if got.shape != want.shape or got.dtype != torch.float32:
            raise AssertionError(f"embedding_bag {case}: {got.shape}")
        errs[case], over[case] = _max_err(got, want), _over(got, want, 1e-5)
        variants[case] = bag_plan_for(*args).variant
        if case.startswith("all_padding") and bool(torch.any(got != 0)):
            raise AssertionError("embedding_bag: all-padding bags not 0")
    torch.cuda.synchronize()
    emit("kernel_check", name="embedding_bag", abs_errs=errs,
         variants=variants)
    _hold("embedding_bag", over)

    def bag_library(t, ids, w):
        live = (ids >= 0).float() if w is None else torch.where(
            ids >= 0, w, 0.0)
        return F.embedding_bag(ids.clamp_min(0), t, mode="sum",
                               per_sample_weights=live)

    if _over(bag_library(*main), embedding_bag_plain(*main), 1e-4) > 0:
        raise AssertionError("embedding_bag: library yardstick disagrees")
    record("embedding_bag", "cuda",
           "src/repro_torch/kernels/csrc/embedding_bag.cu",
           "src/repro/kernels/embedding_bag.py:33",
           [TABLE_ROWS, 1, B_MAIN, N_FIELDS], embedding_bag_cuda,
           embedding_bag_plain, bag_library, main, errs, bag_bound(*main))
    entry = results["embedding_bag"]
    entry["plan"] = bag_plan_for(*main)._asdict()
    entry["int64"] = {
        "ms": time_ms(lambda: embedding_bag_cuda(*main64), iters=100),
        "device_ms": graph_ms(lambda: embedding_bag_cuda(*main64)),
        "plan": bag_plan_for(*main64)._asdict(),
        "max_abs_err": errs["main_int64"]}
    # launch_plan's tile of T bags beside its neighbours and the wide
    # variant, device ms at the main shape with both id widths.
    sweep = {}
    for form, args in (("int32", main), ("int64", main64)):
        for T in (None, "wide", 8, 16, 28, 56, 112):
            over = ({"variant": "wide"} if T == "wide" else
                    {} if T is None else {"tile_bags": T})
            try:
                plan = bag_plan_for(*args, **over)
            except ValueError:  # not a whole tile, or too large
                continue
            key = (f"{form}_{plan.variant}_T{plan.tile_bags}"
                   + ("_default" if T is None else ""))
            sweep[key] = graph_ms(
                lambda: embedding_bag_cuda(*args, plan=plan), calls=10,
                replays=5)
    entry["plan_sweep_device_ms"] = sweep
    # What holds it: the same call on ids that touch no more sectors than
    # fit L2 (every id modulo 262,144 rows, 1 MB) and on uniform ids over
    # the whole table, each beside its own bound.
    data_forms = {}
    for form, ids in (("l2_resident", main[1] % 262_144),
                      ("uniform", torch.randint(
                          0, TABLE_ROWS, main[1].shape, generator=gen,
                          device=device, dtype=torch.int32))):
        args = [table, ids, None]
        data_forms[form] = {
            "device_ms": graph_ms(lambda: embedding_bag_cuda(*args)),
            "bound_ms": bag_bound(*args)[0]}
    entry["data_forms"] = data_forms
    emit("kernel_forms", name="embedding_bag", card=card,
         shape=[TABLE_ROWS, 1, B_MAIN, N_FIELDS],
         **{k: entry[k] for k in ("plan", "int64", "plan_sweep_device_ms",
                                  "data_forms")})
    del table, main, main64, cases, log

    # fm_interaction at DeepFM's (B, F, D).
    v = torch.randn(B_MAIN, N_FIELDS, FM_D, generator=gen, device=device)
    cases = {"main": v, **_fm_cases(gen, device)}
    errs, over = {}, {}
    for case, x in cases.items():
        got, want = fm_interaction_triton(x), fm_interaction_plain(x)
        if got.shape != (x.shape[0],):
            raise AssertionError(f"fm_interaction {case}: {got.shape}")
        scale = torch.sum(x.float() ** 2, dim=(1, 2))
        errs[case], over[case] = _max_err(got, want), _over(got, want,
                                                            1e-5 * scale)
        if x.shape[1] == 1 and bool(torch.any(got != 0)):
            raise AssertionError("fm_interaction: F = 1 is not 0")
    torch.cuda.synchronize()
    emit("kernel_check", name="fm_interaction", abs_errs=errs)
    _hold("fm_interaction", over)
    record("fm_interaction", "triton",
           "src/repro_torch/kernels/fm_interaction.py",
           "src/repro/kernels/fm_interaction.py:21",
           [B_MAIN, N_FIELDS, FM_D], fm_interaction_triton,
           fm_interaction_plain, None, [v], errs, fm_bound(v))
    del v, cases

    # flash_attention at AutoInt's attention shape: float32 and bfloat16,
    # contiguous and in AutoInt's (B, S, H, Dh)-backed layout, and the edge
    # shapes in both types; each case names the variant launch_plan gave.
    main = _attn_inputs(gen, device, *ATTN)
    cases = {"main": (main, False),
             "main_autoint_layout": (_autoint_layout(main), False),
             **_flash_cases(gen, device)}
    cases.update({f"bf16_{case}": ([t.bfloat16() for t in args], causal)
                  for case, (args, causal) in list(cases.items())})
    errs, over, variants = {}, {}, {}
    for case, (args, causal) in cases.items():
        tol = 2e-2 if args[0].dtype == torch.bfloat16 else 1e-5
        got = flash_attention_cuda(*args, causal=causal)
        want = flash_attention_plain(*args, causal=causal)
        if (got.shape != want.shape or got.dtype != args[0].dtype
                or got.stride() != want.stride()
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_attention {case}: bad output")
        errs[case] = _max_err(got, want)
        over[case] = _over(got, want, tol, rtol=tol)
        variants[case] = plan_for(*args, causal).variant
    torch.cuda.synchronize()
    emit("kernel_check", name="flash_attention", abs_errs=errs,
         variants=variants)
    _hold("flash_attention", over)

    def attn_library(q, k, v):
        # Heads are independent here (Hq == Hkv), so (B, H) is refolded to
        # (4, B H / 4): PyTorch's fp32 kernel puts batch and heads on grid
        # axes that hold at most 65,535 blocks.
        B, H, S, D = q.shape
        fold = [t.reshape(4, B * H // 4, S, D) for t in (q, k, v)]
        return F.scaled_dot_product_attention(*fold).reshape(B, H, S, D)

    library_err = _max_err(attn_library(*main), flash_attention_plain(*main))
    record("flash_attention", "cuda",
           "src/repro_torch/kernels/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:30", list(ATTN),
           flash_attention_cuda, flash_attention_plain, attn_library, main,
           errs, flash_bound(*main))
    entry = results["flash_attention"]
    entry["library_max_abs_err"] = library_err
    entry["plan"] = plan_for(*main)._asdict()
    # The main shape in bfloat16 and in AutoInt's layout, and the first
    # design (the tiles variant) at the main shape, timed in this run.
    for form, case in (("bf16", "bf16_main"),
                       ("autoint_layout", "main_autoint_layout")):
        args = cases[case][0]
        bound_ms, bound_by = flash_bound(*args)
        entry[form] = {
            "ms": time_ms(lambda: flash_attention_cuda(*args), iters=100),
            "device_ms": graph_ms(lambda: flash_attention_cuda(*args)),
            "plain_device_ms": graph_ms(
                lambda: flash_attention_plain(*args), calls=5),
            "library_device_ms": graph_ms(lambda: attn_library(*args)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": plan_for(*args)._asdict(), "max_abs_err": errs[case]}
    tiles = plan_for(*main, variant="tiles")
    entry["tiles_variant_device_ms"] = graph_ms(
        lambda: flash_attention_cuda(*main, plan=tiles))
    # launch_plan's choice of P batch rows per group and ring stages
    # beside its neighbours, device ms at the main shape in both types.
    sweep = {}
    for form, args in (("fp32", main), ("bf16", cases["bf16_main"][0])):
        for P, S in ((None, None), (2, 2), (3, 1), (3, 3), (4, 2), (6, 2)):
            try:
                plan = plan_for(*args, per_group=P, stages=S)
            except ValueError:  # does not fit one block
                continue
            key = (f"{form}_P{plan.per_group}_S{plan.stages}"
                   + ("_default" if P is None else ""))
            sweep[key] = graph_ms(
                lambda: flash_attention_cuda(*args, plan=plan), calls=10,
                replays=5)
    entry["plan_sweep_device_ms"] = sweep
    emit("kernel_forms", name="flash_attention", card=card,
         shape=list(ATTN), **{k: entry[k] for k in (
             "plan", "bf16", "autoint_layout", "tiles_variant_device_ms",
             "plan_sweep_device_ms")})
    del main, cases
    torch.cuda.empty_cache()
    return results


def per_forward(model):
    """Kernel launches in one forward: DeepFM one embedding_bag and one
    fm_interaction, AutoInt one flash_attention per attention layer."""
    if hasattr(model.cfg, "n_attn_layers"):
        return {"flash_attention": model.cfg.n_attn_layers}
    return {"embedding_bag": 1, "fm_interaction": 1}


def _config(arch):
    if arch == "deepfm":
        from repro_torch.configs import deepfm as mod
    else:
        from repro_torch.configs import autoint as mod
    return mod


def _plain_forward(arch, model, batch):
    """The model's forward with each kernel's plain version in its place,
    on the same card: the reference the kernels' forward is held to."""
    import torch

    from repro_torch.kernels import (embedding_bag_plain,
                                     flash_attention_plain,
                                     fm_interaction_plain)
    from repro_torch.models.recsys import table_lookup

    cfg, ids = model.cfg, batch["field_ids"]
    if arch == "deepfm":
        v = table_lookup(cfg.table, model.embedding, ids)
        first = embedding_bag_plain(model.first_order["table"], ids)[:, 0]
        deep = model.mlp(v.reshape(v.shape[0], -1))[:, 0]
        return model.bias + first + fm_interaction_plain(v) + deep
    h = table_lookup(cfg.table, model.embedding, ids)
    B, F_, _ = h.shape
    for l in range(cfg.n_attn_layers):
        lp = getattr(model, f"attn_{l}")
        q, k, v = ((h @ lp[w]).reshape(B, F_, cfg.n_heads, -1).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        attn = flash_attention_plain(q, k, v).transpose(1, 2).reshape(
            B, F_, -1)
        h = torch.relu(attn + h @ lp["w_res"])
    return (h.reshape(B, -1) @ model.head["w"])[:, 0] + model.head["b"][0]


def _check_rows(arch, shape, model, batch, scores, serve):
    """Hold the scores of the first and last 512 rows of a call (where the
    kernels' offsets are smallest and largest) to the plain forward of
    those rows alone, rtol and atol 1e-5; rows are independent, so no full
    plain pass is needed. Returns the largest error."""
    import torch

    from repro_torch.stable import log_sigmoid

    rows = scores.shape[0]
    sel = torch.unique(torch.cat([
        torch.arange(min(512, rows)), torch.arange(max(0, rows - 512), rows)
    ])).to(scores.device)
    want = _plain_forward(arch, model, {"field_ids": batch["field_ids"][sel]})
    if serve:
        want = log_sigmoid(want)
    got = scores[sel]
    if _over(got, want, 1e-5) > 0:
        raise AssertionError(f"{arch} {shape}: kernels' scores vs plain "
                             f"forward differ by {_max_err(got, want)}")
    return _max_err(got, want)


def phase_serve(arch, model, log, card):
    """serve at serve_p99 and serve_bulk, retrieval_score over 1M
    candidates, under no_grad; ms per call and rows/s from CUDA events.
    Each shape's first call is held to the plain forward on its first and
    last 512 rows."""
    import torch

    from repro_torch.configs.recsys_common import SHAPES

    calls = 0
    out, ref_err = {}, {}
    with torch.no_grad():
        reset_counts()
        for shape, iters in (("serve_p99", 50), ("serve_bulk", 10),
                             ("retrieval_cand", 3)):
            info = SHAPES[shape]
            if info["kind"] == "retrieval":
                rows = info["n_candidates"]
                batch, fn = log.candidates(rows), model.retrieval_score
            else:
                rows = info["batch"]
                batch, fn = log.batch(rows), model.serve
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            scores = fn(batch)
            torch.cuda.synchronize()
            first_call_ms = (time.perf_counter() - t0) * 1e3
            if scores.shape != (rows,) or not bool(
                    torch.isfinite(scores).all()):
                raise AssertionError(f"{arch} {shape}: bad scores")
            if info["kind"] == "serve" and bool(torch.any(scores > 0)):
                raise AssertionError(f"{arch} {shape}: log-prob above 0")
            ref_err[shape] = _check_rows(arch, shape, model, batch, scores,
                                         info["kind"] == "serve")
            del scores
            ms = time_ms(lambda: fn(batch), iters=iters, warmup=1)
            calls += 1 + 1 + iters
            out[shape] = {"rows": rows, "ms_per_call": ms,
                          "rows_per_s": rows / ms * 1e3,
                          "first_call_ms": first_call_ms,
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated()}
        launches = check_counts(f"serve_{arch}", {
            k: n * calls for k, n in per_forward(model).items()})
    emit(f"serve_{arch}", card=card, params=model.n_params(), calls=calls,
         launches=launches, shapes=out, forward_vs_plain_abs_err=ref_err)
    return launches


def _recsys_breakdown(model, optimizer, state, batch, reps=3):
    """Host-clock ms of forward, backward and AdamW update (optim.step: the
    fused adamw kernel) of one step, each closed by a synchronize (taken
    after the counted run)."""
    import torch

    from repro_torch import optim

    params = list(model.parameters())
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = optim.step(optimizer, grads, state, params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del grads
        parts["forward_ms"].append((t1 - t0) * 1e3)
        parts["backward_ms"].append((t2 - t1) * 1e3)
        parts["optimizer_ms"].append((t3 - t2) * 1e3)
    return {k: min(v) for k, v in parts.items()}


def phase_train_recsys(arch, model, log, card, steps=8):
    """``steps`` AdamW(1e-3) steps at train_batch through make_train_step;
    the held-out batch's loss must fall."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.recsys_common import SHAPES

    rows = SHAPES["train_batch"]["batch"]
    batches = [log.batch(rows) for _ in range(steps)]
    held_out = log.batch(rows)
    optimizer = optim.adamw(1e-3)
    step = model.make_train_step(optimizer)
    state = step.init()
    with torch.no_grad():
        loss_before = float(model.loss(held_out))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, loss = step(state, batches[0])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    losses = [loss]
    for batch in batches[1:]:
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check_counts(f"train_{arch}", {
        **{k: n * steps for k, n in per_forward(model).items()},
        "adamw": steps * sum(1 for p in model.parameters() if p.numel())})
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: non-finite train loss {losses}")
    with torch.no_grad():
        loss_after = float(model.loss(held_out))
    if not loss_after < loss_before:
        raise AssertionError(f"{arch}: held-out loss {loss_before} -> "
                             f"{loss_after} did not fall")
    warm_s = (seconds - cold_s) / (steps - 1)
    breakdown = _recsys_breakdown(model, optimizer, state, held_out)
    emit(f"train_{arch}", card=card, steps=steps, batch=rows,
         params=model.n_params(), seconds=seconds,
         steps_per_s=steps / seconds, rows_per_s=steps * rows / seconds,
         cold_step_ms=cold_s * 1e3, warm_step_ms=warm_s * 1e3,
         warm_steps_per_s=1.0 / warm_s, warm_rows_per_s=rows / warm_s,
         max_memory_allocated=peak, launches=launches, train_losses=losses,
         held_out_loss_before=loss_before, held_out_loss_after=loss_after,
         step_breakdown_ms=breakdown)
    return launches


def clamp_fold_timing(model, log, card):
    """DeepFM's forward at 65,536 rows and serve at 512 rows (no_grad, ms
    per call from CUDA events) with bag_lookup as it is, handing the ids to
    the kernel untouched, and with the clip-and-select passes that it ran
    before the kernel took the clamp put back in front of the same kernel;
    in turns (before, after, after, before), the best of each."""
    import torch

    from repro_torch.models.recsys import deepfm, embedding

    folded = deepfm.bag_lookup
    rows = model.cfg.first_order_table.stored_rows

    def unfolded(cfg, params, ids, *args, **kwargs):
        ids = torch.where(ids >= 0, torch.clamp(ids, 0, rows - 1), -1)
        return embedding.bag_lookup(cfg, params, ids, *args, **kwargs)

    batches = {"forward_65536": (log.batch(B_MAIN), model.forward, 50),
               "serve_512": (log.batch(512), model.serve, 200)}
    out = {}
    with torch.no_grad():
        for what, (batch, fn, iters) in batches.items():
            times = {"before": [], "after": []}
            for form in ("before", "after", "after", "before"):
                deepfm.bag_lookup = unfolded if form == "before" else folded
                try:
                    times[form].append(time_ms(lambda: fn(batch),
                                               iters=iters, warmup=3))
                finally:
                    deepfm.bag_lookup = folded
            out[what] = {form: min(v) for form, v in times.items()}
    emit("clamp_fold", card=card, **out)
    return out


def phase_recsys(arch, card):
    """Serve, then train, the published-width model; freed afterwards."""
    import torch

    log = CriteoLog(torch.device("cuda"), seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _config(arch).make_model(device="cuda", seed=0)
    torch.cuda.synchronize()
    emit(f"build_{arch}", params=model.n_params(),
         seconds=time.perf_counter() - t0,
         memory_allocated=torch.cuda.memory_allocated())
    phase_serve(arch, model, log, card)
    if arch == "deepfm":
        clamp_fold_timing(model, log, card)
    launches = phase_train_recsys(arch, model, log, card)
    del model, log
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_recsys_cpu_vs_gpu():
    """The reduced DeepFM and AutoInt with the same weights through
    ``convert``: CPU (plain versions) and GPU (kernels) agree on the loss
    and every gradient to 1e-5."""
    import numpy as np
    import torch

    from repro_torch.convert import export_params, load_jax_params

    out = {}
    for arch in ("deepfm", "autoint"):
        mod = _config(arch)
        cfg = mod.reduced()
        cpu = mod.make_model(device="cpu", seed=1, cfg=cfg)
        rng = np.random.default_rng(3)
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(torch.from_numpy(rng.normal(
                    scale=0.3, size=tuple(p.shape)).astype(np.float32)))
        gpu = mod.make_model(device="cuda", seed=2, cfg=cfg)
        load_jax_params(gpu, export_params(cpu))
        batch = {"field_ids": rng.integers(0, cfg.table_rows,
                                           (512, cfg.n_sparse)),
                 "labels": (rng.random(512) < 0.3).astype(np.float32)}
        losses, grads = [], []
        reset_counts()
        for model, dev in ((cpu, torch.device("cpu")),
                           (gpu, torch.device("cuda"))):
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            loss = model.loss(b)
            grads.append(torch.autograd.grad(loss, list(model.parameters())))
            losses.append(float(loss.detach()))
        check_counts(f"cpu_vs_gpu {arch}", per_forward(gpu))
        check_close(f"cpu_vs_gpu {arch} loss", losses[1], losses[0],
                    rtol=1e-5, atol=1e-5)
        worst = 0.0
        for (name, _), g_cpu, g_gpu in zip(cpu.named_parameters(), *grads):
            torch.testing.assert_close(g_gpu.cpu(), g_cpu, rtol=1e-5,
                                       atol=1e-5,
                                       msg=lambda m: f"{arch} {name}: {m}")
            worst = max(worst, _max_err(g_gpu.cpu(), g_cpu))
        out[arch] = {"loss_cpu": losses[0], "loss_gpu": losses[1],
                     "max_grad_abs_err": worst}
    emit("cpu_vs_gpu_recsys", **out)


# ---------------------------------------------------------------------------
# The Trainer's run contract: replica sweeps, the non-finite guard,
# checkpoints with bit-exact resume, preemption and restarts, and the EM/MLE
# baselines of Figure 1
# ---------------------------------------------------------------------------

SWEEP_LRS = [1.5e-3, 3e-3, 6e-3, 1.2e-2]
GAP_LIMIT = 1e-5   # a replica against its standalone run (JAX's promise)


def _quiet(*_):
    pass


def _stacked_chunks(batches, n=4):
    """Host batches stacked ``n`` at a time into device chunks."""
    import numpy as np
    import torch

    return [{k: torch.from_numpy(np.stack([b[k] for b in batches[i:i + n]]))
             .cuda() for k in batches[0]}
            for i in range(0, len(batches), n)]


def _train_batches(data, steps, poison=()):
    """The first ``steps`` training batches of ``data`` (the train phases'
    loader), with ``NonFiniteBatchInjector`` poisoning those in
    ``poison``."""
    from repro_torch.configs.clax_baidu import TRAIN_BATCH
    from repro_torch.data import ClickLogLoader
    from repro_torch.testing import NonFiniteBatchInjector

    loader = ClickLogLoader({k: v[:steps * TRAIN_BATCH]
                             for k, v in data.items()},
                            batch_size=TRAIN_BATCH, seed=0)
    return list(iter(NonFiniteBatchInjector(loader, at_steps=poison)))


def _train_loader(data, steps):
    from repro_torch.configs.clax_baidu import TRAIN_BATCH
    from repro_torch.data import ClickLogLoader

    return ClickLogLoader({k: v[:steps * TRAIN_BATCH]
                           for k, v in data.items()},
                          batch_size=TRAIN_BATCH, seed=0)


def _gap(pairs):
    """The largest abs gap over (a, b) tensor pairs, and how many elements
    differ."""
    gaps = [_tensor_gap(a, b) for a, b in pairs]
    return {"max_abs": max(g[0] for g in gaps),
            "elements_differing": sum(g[1] for g in gaps)}


def _replica_vs_standalone(engine, state, losses, r, model, single, outs):
    """Replica r of a sweep against a standalone engine's run: losses,
    parameters, both moments and the step count."""
    import torch

    from repro_torch.train.capture import tree_leaves

    sweep = tree_leaves(state)
    alone = tree_leaves(single)
    n = len(outs) * outs[0].shape[0]
    return {"losses": _gap([(losses[:n, r], torch.cat(outs))]),
            "params": _gap([(leaf[r], p.detach()) for leaf, p in zip(
                engine.replica_params, model.parameters())]),
            "moments": _gap([(a[r], b) for a, b in zip(sweep, alone)
                             if b.dim() > 0]),
            "count": [int(a[r]) for a, b in zip(sweep, alone)
                      if b.dim() == 0 and b.dtype == torch.int32]}


def _standalone(model, optimizer, chunks):
    from repro_torch.train import TrainEngine

    engine = TrainEngine(model, optimizer, chunk_batches=4)
    state = engine.init_opt_state()
    outs = []
    for chunk in chunks:
        state, out = engine.step(state, chunk)
        outs.append(out)
    return state, outs


def _hold_gaps(what, gaps):
    worst = max(g[k]["max_abs"] for g in gaps.values()
                for k in ("losses", "params", "moments"))
    if not worst <= GAP_LIMIT:
        raise AssertionError(f"{what}: a replica is {worst} from its "
                             f"standalone run: {gaps}")
    return worst


def phase_train_sweep_dbn(data, card, steps=16):
    """The paper-width DBN as an R = 4 learning-rate sweep (adamw with an
    injected lr, wd 1e-4; lrs 1.5e-3 .. 1.2e-2) through the engine, 16 steps
    in chunks of 4: the first two chunks counted (examination_nll 4 a
    step, adamw 4 x 5), replica 2 frozen from the third chunk (its
    parameters, moments and count unchanged to the bit, no new capture),
    the fourth under sync debug "error"; every replica against a
    standalone engine at its lr (replica 2 over the 8 steps before its
    freeze). Then the Trainer: the sweep's warm epoch against four
    sequential runs' (replica-steps per second, bench_sweep's measure),
    and the sweep's peak memory."""
    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import TRAIN_BATCH, make_model
    from repro_torch.train import TrainEngine, Trainer

    t_phase = time.perf_counter()
    R, frozen = 4, 2
    gc.collect()
    torch.cuda.empty_cache()
    chunks = _stacked_chunks(_train_batches(data, steps))
    engine = TrainEngine(make_model("dbn", device="cuda"),
                         optim.adamw(0.99, weight_decay=1e-4,
                                     inject_lr=True),
                         chunk_batches=4, replicas=R)
    engine.init_replica_params(list(range(R)))
    state = engine.set_replica_lrs(engine.init_opt_state(), SWEEP_LRS)
    n_tensors = len(engine.params)
    per_step = {"examination_nll": R, "adamw": R * n_tensors}
    outs = []

    def two_chunks():
        for chunk in chunks[:2]:
            outs.append(engine.step(state, chunk)[1])
        return outs

    _, counted = measured_run(
        "train_sweep_dbn", two_chunks,
        {k: n * 8 for k, n in per_step.items()},
        {k: n * 4 for k, n in per_step.items()})
    from repro_torch.train.capture import tree_leaves
    before = [t[frozen].clone() for t in engine.replica_params
              + tree_leaves(state)]
    captures = engine.graphs.captures
    mask = np.ones(R, bool)
    mask[frozen] = False
    outs.append(engine.step(state, chunks[2], active=mask)[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs.append(engine.step(state, chunks[3], active=mask)[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    frozen_equal = all(torch.equal(b, t[frozen]) for b, t in zip(
        before, engine.replica_params + tree_leaves(state)))
    if not frozen_equal:
        raise AssertionError("train_sweep_dbn: the frozen replica moved")
    if engine.graphs.captures != captures:
        raise AssertionError("train_sweep_dbn: freezing a replica captured "
                             "anew")
    del before
    losses = torch.cat(outs)
    gaps = {}
    for r, lr in enumerate(SWEEP_LRS):
        n_chunks = 2 if r == frozen else len(chunks)
        model = make_model("dbn", device="cuda")
        single, single_outs = _standalone(
            model, optim.adamw(lr, weight_decay=1e-4), chunks[:n_chunks])
        gaps[r] = _replica_vs_standalone(engine, state, losses, r, model,
                                         single, single_outs)
        del model, single, single_outs
        torch.cuda.empty_cache()
    worst = _hold_gaps("train_sweep_dbn", gaps)
    counts = [int(c) for c in state[0].count]
    if counts != [steps, steps, 8, steps]:
        raise AssertionError(f"train_sweep_dbn: step counts {counts}")
    engine_losses = losses.tolist()
    del engine, state, outs, losses, chunks
    gc.collect()
    torch.cuda.empty_cache()

    # the Trainer: the sweep's warm epoch against four sequential runs'
    loader = _train_loader(data, steps)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    sweep = Trainer(optim.adamw(0.99, weight_decay=1e-4, inject_lr=True),
                    epochs=2, chunk_batches=4, replicas=R,
                    replica_lrs=SWEEP_LRS, device="cuda", log_fn=_quiet)
    history = sweep.train(make_model("dbn", device="cuda"), loader)
    peak = torch.cuda.max_memory_allocated() - start
    peak_reserved = torch.cuda.max_memory_reserved()
    if not all(math.isfinite(x) for x in history[-1]["train_loss"]):
        raise AssertionError(f"train_sweep_dbn: {history[-1]}")
    del sweep
    gc.collect()
    torch.cuda.empty_cache()
    sequential = []
    for lr in SWEEP_LRS:
        t = Trainer(optim.adamw(lr, weight_decay=1e-4), epochs=2,
                    chunk_batches=4, device="cuda", log_fn=_quiet)
        sequential.append(t.train(make_model("dbn", device="cuda"),
                                  loader))
        del t
        gc.collect()
        torch.cuda.empty_cache()
    warm = {"sweep_s": history[1]["seconds"],
            "sequential_s": sum(h[1]["seconds"] for h in sequential)}
    cold = {"sweep_s": history[0]["seconds"],
            "sequential_s": sum(h[0]["seconds"] for h in sequential)}
    rates = {k: {"replica_steps_per_s": {
                     "sweep": R * steps / v["sweep_s"],
                     "sequential": R * steps / v["sequential_s"]},
                 "speedup": v["sequential_s"] / v["sweep_s"], **v}
             for k, v in (("warm_epoch", warm), ("cold_epoch", cold))}
    emit("train_sweep_dbn", card=card, replicas=R, lrs=SWEEP_LRS,
         steps=steps, batch=TRAIN_BATCH, launches=counted["launches"],
         wrapper_launches=counted["wrapper_launches"],
         launches_per_step=per_step, replica_vs_standalone=gaps,
         max_gap=worst, bits_equal=worst == 0.0, frozen_replica=frozen,
         frozen_bits_equal=frozen_equal, captures=captures,
         no_host_sync_in_chunk=True, step_counts=counts,
         engine_losses_last_step=engine_losses[-1],
         trainer_train_loss=history[-1]["train_loss"], **rates,
         max_memory_allocated=peak, max_memory_reserved=peak_reserved,
         seconds=time.perf_counter() - t_phase)
    return counted["launches"]


def phase_train_sweep_two_tower(data, card, steps=8):
    """The Listing-4 two-tower PBM as an R = 4 seed sweep (seeds 0-3,
    adamw(1e-2)), 8 steps through the engine, counted (dcn_cross 2 x 4 a
    step, adamw 4 x 11): each replica against the model built with its
    seed, run alone; the four replicas' losses differ."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_two_tower
    from repro_torch.train import TrainEngine

    t_phase = time.perf_counter()
    R = 4
    gc.collect()
    torch.cuda.empty_cache()
    chunks = _stacked_chunks(_train_batches(data, steps))
    engine = TrainEngine(make_two_tower("pbm", device="cuda"),
                         optim.adamw(1e-2), chunk_batches=4, replicas=R)
    engine.init_replica_params(list(range(R)))
    state = engine.init_opt_state()
    per_step = {"dcn_cross": 2 * R, "adamw": R * len(engine.params)}

    def run():
        return [engine.step(state, chunk)[1] for chunk in chunks]

    outs, counted = measured_run(
        "train_sweep_two_tower", run,
        {k: n * steps for k, n in per_step.items()},
        {k: n * 4 for k, n in per_step.items()})
    losses = torch.cat(outs)
    first = losses[0].tolist()
    if len(set(first)) != R:
        raise AssertionError(f"train_sweep_two_tower: replica losses "
                             f"{first} do not all differ")
    gaps = {}
    for r in range(R):
        model = make_two_tower("pbm", device="cuda", seed=r)
        single, single_outs = _standalone(model, optim.adamw(1e-2), chunks)
        gaps[r] = _replica_vs_standalone(engine, state, losses, r, model,
                                         single, single_outs)
    worst = _hold_gaps("train_sweep_two_tower", gaps)
    emit("train_sweep_two_tower", card=card, replicas=R, seeds=list(range(R)),
         steps=steps, launches=counted["launches"],
         wrapper_launches=counted["wrapper_launches"],
         launches_per_step=per_step, first_step_losses=first,
         last_step_losses=losses[-1].tolist(), replica_vs_standalone=gaps,
         max_gap=worst, bits_equal=worst == 0.0,
         seconds=time.perf_counter() - t_phase)
    del engine, state, chunks
    gc.collect()
    torch.cuda.empty_cache()
    return counted["launches"]


def phase_guard_dbn(data, card, steps=16, poisoned=5):
    """The paper-width DBN with the non-finite guard over 16 batches, the
    sixth poisoned with NaN clicks by NonFiniteBatchInjector, through the
    engine (counted): its loss NaN and only its step skipped; parameters,
    moments and count equal to the bit those of an unguarded run over the
    same batches without it. Then the Trainer on the same poisoned loader
    (one skipped step, the engine run's parameters to the bit), and the
    finite check's device ms a step at the DBN's gradients."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model
    from repro_torch.testing import NonFiniteBatchInjector
    from repro_torch.train import TrainEngine, Trainer
    from repro_torch.train.capture import tree_leaves
    from repro_torch.train.engine import all_finite

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    batches = _train_batches(data, steps, poison=[poisoned])

    def adamw():
        return optim.adamw(3e-3, weight_decay=1e-4)

    model = make_model("dbn", device="cuda")
    engine = TrainEngine(model, adamw(), chunk_batches=4,
                         nonfinite_guard=True)
    state = engine.init_opt_state()
    chunks = _stacked_chunks(batches)
    per_step = {"examination_nll": 1, "adamw": len(engine.params)}
    outs, counted = measured_run(
        "guard_dbn", lambda: [engine.step(state, c)[1] for c in chunks],
        {k: n * steps for k, n in per_step.items()},
        {k: n * 4 for k, n in per_step.items()})
    losses = torch.cat([o["loss"] for o in outs])
    skipped = torch.cat([o["skipped"] for o in outs]).tolist()
    if skipped != [i == poisoned for i in range(steps)]:
        raise AssertionError(f"guard_dbn: skipped {skipped}")
    if not (math.isnan(losses[poisoned].item()) and bool(torch.isfinite(
            torch.cat([losses[:poisoned], losses[poisoned + 1:]])).all())):
        raise AssertionError(f"guard_dbn: losses {losses.tolist()}")
    del chunks
    clean = make_model("dbn", device="cuda")
    ref_state, _ = _standalone(clean, adamw(), _stacked_chunks(
        batches[:poisoned] + batches[poisoned + 1:]))
    versus_clean = {
        "params": _gap(list(zip(model.parameters(), clean.parameters()))),
        "state": _gap(list(zip(tree_leaves(state), tree_leaves(ref_state))))}
    if any(g["elements_differing"] for g in versus_clean.values()):
        raise AssertionError(f"guard_dbn: the guarded run differs from the "
                             f"run without the poisoned batch: {versus_clean}")
    del clean, ref_state, engine
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(adamw(), epochs=1, chunk_batches=4,
                      nonfinite_guard=True, device="cuda", log_fn=_quiet)
    via = make_model("dbn", device="cuda")
    history = trainer.train(via, NonFiniteBatchInjector(
        _train_loader(data, steps), at_steps=[poisoned]))
    if history[0]["skipped_steps"] != 1 or not math.isfinite(
            history[0]["train_loss"]):
        raise AssertionError(f"guard_dbn: the Trainer's record {history}")
    trainer_gap = _gap(list(zip(via.parameters(), model.parameters())))
    if trainer_gap["elements_differing"]:
        raise AssertionError(f"guard_dbn: Trainer vs engine {trainer_gap}")
    del trainer, via
    gc.collect()
    torch.cuda.empty_cache()
    # the finite check alone, at the DBN's gradients (two 214,748,672-row
    # tables and three small tensors)
    batch = {k: v[0] for k, v in _stacked_chunks(batches[:1], 1)[0].items()}
    model.compute_loss(batch).backward()
    grads = [p.grad for p in model.parameters()]
    loss = torch.zeros((), device="cuda")
    finite_ms = graph_ms(lambda: all_finite(loss, grads), calls=5,
                         replays=4)
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    emit("guard_dbn", card=card, steps=steps, poisoned_step=poisoned,
         launches=counted["launches"],
         wrapper_launches=counted["wrapper_launches"],
         poisoned_loss=str(losses[poisoned].item()), skipped=skipped,
         versus_run_without_it=versus_clean, bits_equal=True,
         trainer_skipped_steps=history[0]["skipped_steps"],
         trainer_train_loss=history[0]["train_loss"],
         trainer_vs_engine=trainer_gap,
         finite_check_device_ms_per_step=finite_ms,
         finite_check_bytes=grad_bytes,
         finite_check_bound_ms=grad_bytes / PEAK_BYTES_PER_S * 1e3,
         seconds=time.perf_counter() - t_phase)
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()
    return counted["launches"]


class _TimedCheckpoints:
    """Times every save and restore of a Trainer's CheckpointManager, with
    the bytes each save wrote."""

    def __init__(self, manager):
        self.manager = manager
        self.saves, self.restores = [], []
        save, restore = manager.save, manager.restore

        def timed_save(step, tree, aux=None):
            t0 = time.perf_counter()
            out = save(step, tree, aux=aux)
            self.saves.append({
                "step": step, "seconds": time.perf_counter() - t0,
                "bytes": sum(os.path.getsize(os.path.join(out, f))
                             for f in os.listdir(out))})
            return out

        def timed_restore(*args, **kwargs):
            t0 = time.perf_counter()
            out = restore(*args, **kwargs)
            self.restores.append({"step": out[2],
                                  "seconds": time.perf_counter() - t0})
            return out

        manager.save, manager.restore = timed_save, timed_restore


def _sigkill_drill():
    """``python -m repro_torch.launch.train`` at its default size (UBM,
    200,000 sessions, batch 2,048, 78 steps an epoch), 3 epochs, on the
    card: with ``--ckpt-dir``, ``--fault-kill-at-step 100`` (SIGKILL in
    epoch 2, after epoch 1's checkpoint) and ``--max-restarts 1`` it must
    exit 0 after one relaunch, with the uninterrupted run's epoch records
    and test metrics."""
    import shutil
    import subprocess
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--epochs",
            "3"]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_drill_")

    def records(argv):
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"drill {argv[3:]} exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        epochs = [re.sub(r"'seconds': [^,]*, ", "", line) for line in lines
                  if line.startswith("[trainer] {")]
        tests = [line for line in lines if line.startswith("[train] test")]
        return proc.stdout, epochs, tests, time.perf_counter() - t0

    try:
        out, epochs, tests, drill_s = records(base + [
            "--ckpt-dir", ckpt, "--fault-kill-at-step", "100",
            "--max-restarts", "1"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _, want_epochs, want_tests, clean_s = records(base)
    relaunched = ("relaunching" in out
                  and "completed after 1 restart" in out
                  and "resumed at epoch=1" in out)
    same = epochs[-len(want_epochs) + 1:] == want_epochs[1:] \
        and tests == want_tests and len(tests) == 1
    if not (relaunched and same):
        raise AssertionError(f"drill: relaunched {relaunched}, records "
                             f"{epochs} / {tests} against {want_epochs} / "
                             f"{want_tests}")
    return {"exit": 0, "relaunched": relaunched, "test": tests[0],
            "equal_to_uninterrupted": same, "drill_seconds": drill_s,
            "uninterrupted_seconds": clean_s}


def phase_resume_dbn(data, card, steps=16):
    """The paper-width DBN, one epoch of 16 steps, with checkpoints every 8
    steps (keep 1) in a temporary directory: a SIGTERM KillSwitch at batch
    9 under handle_preemption ends the run with a checkpoint; a fresh
    Trainer resumes from it and must end on an uninterrupted run's
    parameters, moments and history to the bit. Both runs counted, their
    launches held to the steps each ran. Save and restore seconds and
    bytes. Then the launcher's SIGKILL drill."""
    import shutil
    import signal
    import tempfile

    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model
    from repro_torch.testing import KillSwitch
    from repro_torch.train import Trainer
    from repro_torch.train.capture import tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    def trainer(ckpt=None):
        return Trainer(optim.adamw(3e-3, weight_decay=1e-4), epochs=1,
                       chunk_batches=4, checkpoint_dir=ckpt,
                       checkpoint_every_steps=8 if ckpt else None,
                       keep_checkpoints=1, handle_preemption=True,
                       device="cuda", log_fn=_quiet)

    def strip(history):
        return [{k: v for k, v in r.items() if k != "seconds"}
                for r in history]

    full_model = make_model("dbn", device="cuda")
    full = trainer()
    h_full = full.train(full_model, _train_loader(data, steps))
    n_tensors = len(list(full_model.parameters()))

    def launches(n_steps):
        return {"examination_nll": n_steps, "adamw": n_tensors * n_steps}

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free_gb = shutil.disk_usage(ckpt).free / 1e9
    try:
        killed = trainer(ckpt)
        timed_k = _TimedCheckpoints(killed.ckpt)
        loader = KillSwitch(_train_loader(data, steps), after_batches=9,
                            sig=signal.SIGTERM)
        before = signal.getsignal(signal.SIGTERM)
        h_killed, killed_counts = measured_run(
            "resume_dbn_preempted",
            lambda: killed.train(make_model("dbn", device="cuda"), loader),
            lambda _: launches(killed._final_state.global_step),
            lambda _: launches(4))
        stopped_at = killed._final_state.global_step
        if not (loader.fired and h_killed == [] and 0 < stopped_at < steps
                and signal.getsignal(signal.SIGTERM) is before):
            raise AssertionError(f"resume_dbn: the preemption did not stop "
                                 f"the run mid-epoch (step {stopped_at})")
        del killed
        gc.collect()
        torch.cuda.empty_cache()
        resumed = trainer(ckpt)
        timed_r = _TimedCheckpoints(resumed.ckpt)
        model = make_model("dbn", device="cuda")
        h_resumed, resumed_counts = measured_run(
            "resume_dbn_resumed",
            lambda: resumed.train(model, _train_loader(data, steps),
                                  resume=True),
            launches(steps - stopped_at), launches(min(4, steps - stopped_at)))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    versus = {
        "params": _gap(list(zip(model.parameters(),
                                full_model.parameters()))),
        "state": _gap(list(zip(tree_leaves(resumed._final_state.opt_state),
                               tree_leaves(full._final_state.opt_state))))}
    history_equal = strip(h_resumed) == strip(h_full)
    if not history_equal or any(g["elements_differing"]
                                for g in versus.values()):
        raise AssertionError(f"resume_dbn: the resumed run differs from "
                             f"the uninterrupted one: {versus}, history "
                             f"{h_resumed} against {h_full}")
    del resumed, full, model, full_model
    gc.collect()
    torch.cuda.empty_cache()
    drill = _sigkill_drill()
    saves = timed_k.saves + timed_r.saves
    emit("resume_dbn", card=card, steps=steps, preempted_at_step=stopped_at,
         launches={"preempted": killed_counts["launches"],
                   "resumed": resumed_counts["launches"]},
         wrapper_launches={"preempted": killed_counts["wrapper_launches"],
                           "resumed": resumed_counts["wrapper_launches"]},
         versus_uninterrupted=versus, history_equal=history_equal,
         bits_equal=True, saves=saves,
         restores=timed_k.restores + timed_r.restores,
         save_gb=[x["bytes"] / 1e9 for x in saves],
         save_gb_per_s=[x["bytes"] / 1e9 / x["seconds"] for x in saves],
         disk_free_gb=free_gb, history=strip(h_full), sigkill_drill=drill,
         seconds=time.perf_counter() - t_phase)


def phase_em(data, card, steps=16, grad_epochs=4):
    """Figure 1 on the card over the smoke's DBN log: GCTR, RCTR, DCTR
    (Beta prior at the GCTR rate, weight 1) and SDBN by MLE counting, PBM
    and UBM by 30 EM iterations from 1/9, on the 16 training batches
    (1,048,576 sessions), each timed on the card with nothing else
    running, then held against the CPU port's fit of the same log, taken
    on threads afterwards (MLE at 1e-6, EM at 1e-3: index_add_ sums in
    another order on the card), with the card's spread between two runs of
    each fit;
    each fit injected into its model and evaluated on the
    held-out batch (perplexity, conditional perplexity) on the card and,
    from the CPU's fit, on the CPU (the two equal, NaN where the reference
    gives NaN: a fitted probability of 1 has an infinite logit), beside a
    PBM and a UBM of the same width trained by gradient (Figure 1's
    AdamW(0.05), batch 4,096, 4 epochs: adamw only, each run a
    :func:`measured_run`)."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import TRAIN_BATCH
    from repro_torch.convert import load_jax_params
    from repro_torch.core import MODEL_REGISTRY
    from repro_torch.core import em
    from repro_torch.data import ClickLogLoader, SyntheticConfig
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    n = len(data["clicks"])
    n_docs = SyntheticConfig(n_sessions=n, n_queries=max(n // 100, 1),
                             docs_per_query=20, positions=K_MAIN,
                             behavior="dbn", seed=0).n_query_doc_pairs
    train = {k: v[:steps * TRAIN_BATCH] for k, v in data.items()}
    held = ClickLogLoader({k: v[steps * TRAIN_BATCH:]
                           for k, v in data.items()},
                          batch_size=TRAIN_BATCH, shuffle=False,
                          drop_last=False)
    card_batch = {k: torch.from_numpy(v).cuda() for k, v in train.items()}
    fits = {
        "gctr": lambda b: (em.fit_gctr(b),),
        "rctr": lambda b: (em.fit_rctr(b, K_MAIN),),
        "dctr": lambda b: (em.fit_dctr(b, n_docs,
                                       prior=float(em.fit_gctr(b)),
                                       prior_weight=1.0),),
        "sdbn": lambda b: em.fit_sdbn_mle(b, n_docs),
        "pbm": lambda b: em.fit_pbm_em(b, K_MAIN, n_docs, n_iters=30,
                                       init=1 / 9),
        "ubm": lambda b: em.fit_ubm_em(b, K_MAIN, n_docs, n_iters=30,
                                       init=1 / 9)}
    inject = {"gctr": em.gctr_params_from_mle,
              "rctr": em.rctr_params_from_mle,
              "dctr": em.dctr_params_from_mle,
              "sdbn": em.sdbn_params_from_mle,
              "pbm": em.pbm_params_from_em, "ubm": em.ubm_params_from_em}
    # The MLE fits sum 0/1 values below 2^24: exact in any order. EM sums
    # float32 posteriors, up to 1,048,576 a position, in another order on
    # the card (atomics, another order each run) than on the CPU (in
    # order): the first four chip runs of this phase measured up to 1.1e-4
    # between the two, and up to 1.1e-4 between two runs on the card.
    tolerance = {"gctr": 1e-6, "rctr": 1e-6, "dctr": 1e-6, "sdbn": 1e-6,
                 "pbm": 1e-3, "ubm": 1e-3}
    evaluators = {device: Trainer(optim.adamw(0.05), chunk_batches=1,
                                  device=device, log_fn=_quiet)
                  for device in ("cuda", "cpu")}
    evaluator = evaluators["cuda"]
    rows = {}

    def timed_cpu_fit(fit):
        t0 = time.perf_counter()
        return fit(train), time.perf_counter() - t0

    card_fits = {}
    reset_counts()
    for kind, fit in fits.items():
        first = fit(card_batch)  # warm: the first call pays the set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fit(card_batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # the card's own spread between two runs (atomics' order)
        spread = max(float((a - b).abs().max()) for a, b in zip(first, got))
        card_fits[kind] = got, seconds, spread
        del first
    check_counts("em_fits", {})
    del card_batch
    # the CPU port's fits, on threads of their own once the card's are
    # timed (torch's CPU ops release the interpreter lock)
    with ThreadPoolExecutor(max_workers=len(fits)) as cpu_pool:
        cpu_fits = {kind: cpu_pool.submit(timed_cpu_fit, fit)
                    for kind, fit in fits.items()}
    for kind in fits:
        got, seconds, spread = card_fits.pop(kind)
        want, cpu_seconds = cpu_fits[kind].result()
        gap = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        if not gap <= tolerance[kind]:
            raise AssertionError(f"em: {kind} on the card is {gap} from the "
                                 f"CPU port's fit (tolerance "
                                 f"{tolerance[kind]})")
        metrics = {}
        for device, fitted in (("cuda", got), ("cpu", want)):
            model = MODEL_REGISTRY[kind](query_doc_pairs=n_docs,
                                         positions=K_MAIN, device=device)
            load_jax_params(model, inject[kind](*fitted))
            metrics[device] = evaluators[device].evaluate(model, held)
        # the card's evaluation of its fit against the CPU port's of its
        # own: equal NaN-ness (an SDBN fit with a probability of 1 has an
        # infinite logit in JAX too), finite values within 1e-4
        for k, v in metrics["cuda"].items():
            w = metrics["cpu"][k]
            if math.isnan(v) != math.isnan(w) or (
                    math.isfinite(w) and not abs(v - w) <= 1e-4 * abs(w)):
                raise AssertionError(f"em: {kind}'s {k} {v} on the card, "
                                     f"{w} on the CPU")
        rows[kind] = {"method": "mle" if tolerance[kind] < 1e-5 else "em",
                      "seconds": seconds, "cpu_seconds": cpu_seconds,
                      "vs_cpu_max_abs": gap, "card_spread": spread,
                      "tolerance": tolerance[kind],
                      "test_ppl": metrics["cuda"]["ppl"],
                      "test_cond_ppl": metrics["cuda"]["cond_ppl"],
                      "cpu_test_ppl": metrics["cpu"]["ppl"]}
        # JSON has no NaN: a non-finite metric is printed as its name
        rows[kind].update({k: v if math.isfinite(v) else str(v)
                           for k, v in rows[kind].items()
                           if isinstance(v, float)})
    for kind in ("pbm", "ubm"):
        model = MODEL_REGISTRY[kind](query_doc_pairs=n_docs,
                                     positions=K_MAIN, init_prob=1 / 9,
                                     device="cuda")
        trainer = Trainer(optim.adamw(0.05, weight_decay=0.0),
                          epochs=grad_epochs, patience=grad_epochs,
                          chunk_batches=8, device="cuda", log_fn=_quiet)
        loader = ClickLogLoader(train, batch_size=4096, seed=0)
        n_steps = grad_epochs * loader.batches_per_epoch
        n_tensors = len(list(model.parameters()))
        history, counted = measured_run(
            f"em_grad_{kind}", lambda: trainer.train(model, loader),
            {"adamw": n_tensors * n_steps}, {"adamw": n_tensors * 8})
        metrics = evaluator.evaluate(model, held)
        rows[f"{kind}_grad"] = {
            "method": "grad", "epochs": grad_epochs, "steps": n_steps,
            "seconds": sum(r["seconds"] for r in history),
            "launches": counted["launches"],
            "wrapper_launches": counted["wrapper_launches"],
            "test_ppl": metrics["ppl"], "test_cond_ppl": metrics["cond_ppl"]}
        del model, trainer
    # every fit the CPU port evaluates finite, and every gradient run,
    # has a finite perplexity above 1
    if not all(isinstance(r["test_ppl"], float) and r["test_ppl"] > 1.0
               for r in rows.values()
               if not isinstance(r.get("cpu_test_ppl", 0.0), str)):
        raise AssertionError(f"em: {rows}")
    gc.collect()
    torch.cuda.empty_cache()
    emit("em", card=card, sessions=steps * TRAIN_BATCH,
         held_out_sessions=n - steps * TRAIN_BATCH, n_docs=n_docs,
         fits=rows, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# the out-of-core data plane and its observability (slice 10)
# ---------------------------------------------------------------------------

STORE_SESSIONS = 4 * 1048576  # the multi-shard store: 4 shards of 2^20
STORE_SHARD_ROWS = 1048576


def _batch_digest(batch) -> str:
    """One hash over a host batch's keys, shapes, dtypes and bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(batch):
        v = np.ascontiguousarray(batch[k])
        h.update(f"{k}{v.shape}{v.dtype.str}".encode())
        h.update(v.view(np.uint8).reshape(-1).data)
    return h.hexdigest()


def _digests(loader, stop=None):
    """The digests of ``loader``'s batches (one epoch, or the first
    ``stop``)."""
    out = []
    for batch in loader:
        out.append(_batch_digest(batch))
        if stop is not None and len(out) == stop:
            break
    return out


def _store_files(directory):
    """{relative path: bytes} of a store's shard files, and its manifest
    with ``metadata.ingest_workers`` dropped."""
    files = {}
    for dirpath, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, directory)
            if name == "manifest.json":
                continue
            with open(path, "rb") as f:
                files[rel] = f.read()
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["metadata"].pop("ingest_workers", None)
    return files, manifest


def _spawn_import_seconds():
    """Seconds a fresh interpreter takes to import ``repro_torch.data`` (the
    module a spawned ingest worker unpickles its job from), torch
    included, measured inside the child."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import time; t = time.perf_counter(); import repro_torch.data; "
            "print(time.perf_counter() - t)")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    return float(out.stdout.strip().splitlines()[-1])


def _dbn_trainer(**kw):
    from repro_torch import optim
    from repro_torch.train import Trainer

    return Trainer(optim.adamw(3e-3, weight_decay=1e-4), epochs=1,
                   chunk_batches=4, device="cuda", log_fn=_quiet, **kw)


def _keep_engines(trainer):
    """Make ``trainer`` keep every engine it builds (``trainer.engines``),
    to read their graphs' captures and replays."""
    trainer.engines = []
    make = trainer._make_engine

    def keeping(model):
        engine = make(model)
        trainer.engines.append(engine)
        return engine

    trainer._make_engine = keeping
    return trainer


SPARSE_TABLES = dict(sparse_tables=True,
                     sparse_table_kwargs=dict(lr=3e-3, weight_decay=1e-4))


def _run_dbn(what, loader, steps, sink=None, **kw):
    """A fresh paper-width DBN trained by a one-epoch Trainer (``kw``) over
    ``loader`` (``steps`` steps, chunks of 4), counted as a
    :func:`measured_run`, its events into ``sink`` (a MemorySink by
    default). Returns (model, trainer, history, counts, sink)."""
    from repro_torch import obs
    from repro_torch.configs.clax_baidu import make_model
    from repro_torch.train import TrainEngine

    model = make_model("dbn", device="cuda")
    sink = obs.MemorySink() if sink is None else sink
    trainer = _keep_engines(_dbn_trainer(recorder=obs.Recorder([sink]),
                                         **kw))
    per_step = dict(examination_nll=1, **_optimizer_launches(TrainEngine(
        model, trainer.optimizer, sparse_tables=trainer.sparse_tables,
        sparse_table_kwargs=trainer.sparse_table_kwargs), 1))
    eager = min(4, steps)
    history, counts = measured_run(
        what, lambda: trainer.train(model, loader),
        {k: n * steps for k, n in per_step.items()},
        {k: n * eager for k, n in per_step.items()})
    return model, trainer, history, counts, sink


def _versus(a_model, a_trainer, b_model, b_trainer):
    from repro_torch.train.capture import tree_leaves

    return {"params": _gap(list(zip(a_model.parameters(),
                                    b_model.parameters()))),
            "moments": _gap(list(zip(
                tree_leaves(a_trainer._final_state.opt_state),
                tree_leaves(b_trainer._final_state.opt_state))))}


def _shard_read_ms(store, root):
    """Where a streaming loader's read of one 2^20-row shard goes, host ms
    on the read-ahead thread's work done here inline: each column's open
    (the decode of its codec) and crc32 verify, and the permuted gather of
    the whole-shard window, for shard 0 as stored (codec ``auto``) and
    for the same rows rewritten with codec ``raw`` (memory-mapped
    columns, no decode)."""
    import numpy as np

    from repro_torch.data import write_session_store

    keys = ("clicks", "mask", "positions", "query_doc_ids")
    perm = np.random.default_rng((0, 0, 1)).permutation(store.shard_rows(0))
    raw = write_session_store(store.open_shard(0, columns=keys),
                              os.path.join(root, "raw_shard"),
                              shard_rows=store.shard_rows(0), codec="raw")
    out = {}
    for name, st in (("auto", store), ("raw", raw)):
        cols, part = {}, {}
        for k in keys:
            t0 = time.perf_counter()
            cols[k] = st.open_shard(0, columns=(k,))[k]
            t1 = time.perf_counter()
            st.verify(0, columns=(k,))
            t2 = time.perf_counter()
            np.asarray(cols[k][perm])
            t3 = time.perf_counter()
            part[k] = {"codec": st.shard_codec(0, k),
                       "stored_bytes": st.shard_stored_nbytes(0, k),
                       "open_ms": (t1 - t0) * 1e3,
                       "verify_ms": (t2 - t1) * 1e3,
                       "gather_ms": (t3 - t2) * 1e3}
        out[name] = {"columns": part, "total_ms": sum(
            sum(v for key, v in c.items() if key.endswith("_ms"))
            for c in part.values())}
    return out


def phase_store(data, card, steps=16):
    """The out-of-core data plane on the card's host, in a temporary
    directory: the smoke's 16 training batches written as a single-shard
    store train the paper-width DBN through the Trainer and a
    StreamingClickLogLoader equal to the bit to the in-memory loader's run
    (batches, losses, parameters, moments, launches); 4,194,304 sessions
    ingested in 4 shards by 4 spawned workers, byte-identical to 1; one
    epoch of the DBN from that store, read ahead and crc-verified; a
    mid-epoch resume and a quarantined corrupt shard against the
    fault-free stream, to the bit; ingest rate, bytes, and the streaming
    input path in turned rounds beside the in-memory loader's."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.clax_baidu import TRAIN_BATCH
    from repro_torch.data import (ClickLogLoader, SessionStore,
                                  StreamingClickLogLoader, SyntheticConfig,
                                  ingest_synthetic, write_session_store)
    from repro_torch.testing import corrupt_shard_file

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    out = {}
    try:
        # 1-3: the single-shard store against the in-memory loader
        train = {k: v[:steps * TRAIN_BATCH] for k, v in data.items()}
        t0 = time.perf_counter()
        single = write_session_store(train, os.path.join(root, "single"),
                                     shard_rows=len(train["clicks"]),
                                     codec="auto")
        out["single_shard_write_s"] = time.perf_counter() - t0

        def memory_loader():
            return ClickLogLoader(train, batch_size=TRAIN_BATCH, seed=0)

        def single_loader():
            return StreamingClickLogLoader(single, batch_size=TRAIN_BATCH,
                                           seed=0)

        batches_equal = _digests(memory_loader()) == _digests(
            single_loader())
        ref = _run_dbn("store_in_memory_dbn", memory_loader(), steps)
        fed = _run_dbn("store_single_shard_dbn", single_loader(), steps)
        versus = _versus(ref[0], ref[1], fed[0], fed[1])
        losses = [run[4].series("train_step") for run in (ref, fed)]
        losses_equal = losses[0] == losses[1] and len(losses[1]) == steps
        if not (batches_equal and losses_equal and ref[3] == fed[3]
                and not any(g["elements_differing"]
                            for g in versus.values())):
            raise AssertionError(
                f"store: the single-shard store's run differs from the "
                f"in-memory one: batches {batches_equal}, losses "
                f"{losses_equal}, {versus}, launches {fed[3]} vs {ref[3]}")
        out["single_shard"] = {
            "batches_bits_equal": batches_equal,
            "losses_bits_equal": losses_equal,
            "versus_in_memory": versus, "launches": fed[3]["launches"],
            "in_memory_launches": ref[3]["launches"],
            "wrapper_launches": fed[3]["wrapper_launches"],
            "stored_bytes": single.stored_nbytes(),
            "raw_bytes": single.rows * sum(
                c.row_nbytes for c in single.columns.values())}
        emit("store_part", single_shard=out["single_shard"])
        del ref, fed
        gc.collect()
        torch.cuda.empty_cache()

        # 4: parallel ingest, byte-identical to one worker
        cfg = SyntheticConfig(n_sessions=STORE_SESSIONS,
                              n_queries=STORE_SESSIONS // 100,
                              docs_per_query=20, positions=K_MAIN,
                              behavior="dbn", seed=0)
        chunk = STORE_SESSIONS // 16
        ingest = {}
        for workers in (4, 1):
            where = os.path.join(root, f"ingest_{workers}")
            t0 = time.perf_counter()
            ingest_synthetic(cfg, where, chunk_sessions=chunk,
                             shard_rows=STORE_SHARD_ROWS, codec="auto",
                             workers=workers)
            seconds = time.perf_counter() - t0
            ingest[workers] = {"seconds": seconds,
                               "sessions_per_s": STORE_SESSIONS / seconds}
        many, one = (_store_files(os.path.join(root, f"ingest_{w}"))
                     for w in (4, 1))
        identical = many == one
        if not identical:
            raise AssertionError("store: the 4-worker ingest differs from "
                                 "the 1-worker one")
        del many, one
        shutil.rmtree(os.path.join(root, "ingest_1"))
        path = os.path.join(root, "ingest_4")
        store = SessionStore(path)
        raw = store.rows * sum(c.row_nbytes for c in store.columns.values())
        out["ingest"] = {
            "sessions": STORE_SESSIONS, "shard_rows": STORE_SHARD_ROWS,
            "chunk_sessions": chunk, "codec": "auto",
            "workers_4": ingest[4], "workers_1": ingest[1],
            "byte_identical_4_vs_1": identical,
            "spawn_import_seconds": _spawn_import_seconds(),
            "codecs": store.shards[0]["codecs"],
            "stored_bytes": store.stored_nbytes(), "raw_bytes": raw,
            "raw_over_stored": raw / store.stored_nbytes()}
        emit("store_part", ingest=out["ingest"])

        # 5: one epoch of the DBN from the multi-shard store
        def multi_loader(**kw):
            return StreamingClickLogLoader(path, batch_size=TRAIN_BATCH,
                                           seed=0, verify_checksums=True,
                                           **kw)

        epoch_steps = multi_loader().batches_per_epoch
        model, trainer, history, counts, sink = _run_dbn(
            "store_multi_shard_dbn", multi_loader(), epoch_steps)
        losses = sink.series("train_step")
        if not (len(losses) == epoch_steps
                and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"store: the multi-shard epoch gave "
                                 f"{len(losses)} losses of {epoch_steps}")
        out["multi_shard_epoch"] = {
            "steps": epoch_steps, "seconds": history[-1]["seconds"],
            "ms_per_step": history[-1]["seconds"] / epoch_steps * 1e3,
            "train_loss": history[-1]["train_loss"],
            "launches": counts["launches"],
            "wrapper_launches": counts["wrapper_launches"]}
        emit("store_part", multi_shard_epoch=out["multi_shard_epoch"])
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
        out["shard_read_ms"] = _shard_read_ms(store, root)
        emit("store_part", shard_read_ms=out["shard_read_ms"])

        # the input path in turned rounds: the in-memory loader, the
        # single-shard store over the same rows, the multi-shard store
        # (crc-verified, read ahead), each with its warm step
        def warm(loader_fn):
            def run():
                from repro_torch.configs.clax_baidu import make_model

                model = make_model("dbn", device="cuda")
                trainer = _dbn_trainer()
                trainer.epochs = 2
                return trainer.train(model, loader_fn())[1]["seconds"]
            return run

        rounds = {}
        for name, loader_fn, n in (
                ("in_memory", memory_loader, steps),
                ("single_shard_store", single_loader, steps),
                ("multi_shard_store", multi_loader, epoch_steps)):
            warm_ms, input_path, warm_over = warm_and_input_rounds(
                warm(loader_fn), loader_fn(), n)
            rounds[name] = {"steps": n, "warm_step_ms": warm_ms,
                            "input_ms_per_step": input_path,
                            "warm_minus_overlapped_input_ms": warm_over}
            gc.collect()
            torch.cuda.empty_cache()
        out["rounds"] = rounds
        emit("store_part", rounds=rounds)

        # 6: a mid-epoch resume against the uninterrupted stream
        whole = _digests(multi_loader())
        head_loader = multi_loader()
        cut = epoch_steps * 3 // 8  # inside the second shard
        head = _digests(head_loader, stop=cut)
        tail_loader = multi_loader()
        tail_loader.load_state_dict(head_loader.state_dict())
        tail = _digests(tail_loader)
        resume_equal = head + tail == whole
        if not resume_equal:
            raise AssertionError("store: the resumed stream differs from "
                                 "the uninterrupted one")

        # 7: a corrupt shard quarantined: the fault-free stream less its
        # rows (the expected stream read before the corruption)
        bad = 2
        expected_loader = multi_loader()
        expected_loader.load_state_dict(
            {"epoch": 0, "step": 0, "quarantined": [bad]})
        expected = _digests(expected_loader)
        corrupt_shard_file(path, shard=bad, column="clicks", seed=0)
        skipped = []
        for _ in range(2):
            loader = multi_loader(corrupt_policy="skip", log_fn=_quiet)
            skipped.append(_digests(loader))
            if loader.quarantined != {bad}:
                raise AssertionError(f"store: quarantined "
                                     f"{loader.quarantined}, not {bad}")
        quarantine_ok = skipped[0] == skipped[1] == expected and len(
            expected) == epoch_steps - STORE_SHARD_ROWS // TRAIN_BATCH
        if not quarantine_ok:
            raise AssertionError("store: the quarantined stream is not the "
                                 "fault-free one less the corrupt shard")
        out["resume"] = {"cut_at_step": cut, "bits_equal": resume_equal}
        out["quarantine"] = {"shard": bad, "batches": len(expected),
                             "deterministic": skipped[0] == skipped[1],
                             "equal_to_fault_free_less_shard": True}

    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("store", card=card, steps=steps, batch=TRAIN_BATCH, **out,
         bits_equal=True, seconds=time.perf_counter() - t_phase)


def _telemetry_cpu_norms(kind, batch_np):
    """grad_norm and param_norm of one telemetry step of a fresh CPU
    paper-width model (the plain versions) on ``batch_np``."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model
    from repro_torch.train import TrainEngine

    torch.set_num_threads(os.cpu_count() or 1)
    model = make_model("dbn", device="cpu")
    sparse = SPARSE_TABLES if kind == "sparse" else {}
    engine = TrainEngine(model, optim.adamw(3e-3, weight_decay=1e-4),
                         telemetry=True, **sparse)
    state = engine.init_opt_state()
    chunk = {k: torch.from_numpy(v)[None] for k, v in batch_np.items()}
    _, out = engine.step(state, chunk)
    return float(out["grad_norm"][0]), float(out["param_norm"][0])


def _frozen_replica(kind, first, cpu):
    """ROADMAP C.4 on the card: an R = 2 sweep of the paper-width DBN with
    telemetry on takes one step of ``first`` with replica 1 frozen (dense:
    lrs 1.5e-3 and 3e-3, injected; sparse: lr 3e-3, guarded). Replica 1's
    parameters, moments and count stay equal to the bit, and its grad and
    parameter norms are those of the update it would make: the CPU port's
    single step at its lr (``cpu``), within 1e-5. Replica 0's parameters
    and state equal to the bit the same sweep's with telemetry off, and its
    param_norm that of the parameters it wrote, within 1e-5."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model
    from repro_torch.train import TrainEngine
    from repro_torch.train.capture import tree_leaves

    chunk = {k: torch.from_numpy(v)[None].cuda() for k, v in first.items()}
    runs = {}
    for telemetry in (False, True):
        if kind == "dense":
            kw = {}
            opt = optim.adamw(0.99, weight_decay=1e-4, inject_lr=True)
        else:
            kw = dict(SPARSE_TABLES, nonfinite_guard=True)
            opt = optim.adamw(3e-3, weight_decay=1e-4)
        engine = TrainEngine(make_model("dbn", device="cuda"), opt,
                             replicas=2, telemetry=telemetry, **kw)
        engine.init_replica_params([0, 1])
        state = engine.init_opt_state()
        if kind == "dense":
            engine.set_replica_lrs(state, [1.5e-3, 3e-3])
        frozen = [t[1].clone() for t in engine.replica_params
                  + tree_leaves(state)]
        _, out = engine.step(state, chunk, active=[True, False])
        torch.cuda.synchronize()
        leaves = engine.replica_params + tree_leaves(state)
        if not all(torch.equal(b, t[1]) for b, t in zip(frozen, leaves)):
            raise AssertionError(f"frozen_replica_{kind}: replica 1 moved")
        # the active replica's param_norm: that of the parameters it wrote
        written = float(torch.sqrt(sum(torch.sum(t[0].double() ** 2)
                                       for t in engine.replica_params)))
        runs[telemetry] = ([t[0].clone() for t in leaves], out, written)
        del engine, state, frozen, leaves
        gc.collect()
        torch.cuda.empty_cache()
    if not all(torch.equal(a, b) for a, b in zip(runs[False][0],
                                                  runs[True][0])):
        raise AssertionError(f"frozen_replica_{kind}: replica 0 differs "
                             "from the run without telemetry")
    _, out, written = runs[True]
    got = {k: float(out[k][0, 1]) for k in ("grad_norm", "param_norm")}
    rel = {k: abs(got[k] - c) / abs(c)
           for k, c in zip(("grad_norm", "param_norm"), cpu)}
    active = float(out["param_norm"][0, 0])
    rel["active_param_norm_vs_written"] = abs(active - written) / written
    if max(rel.values()) > 1e-5:
        raise AssertionError(f"frozen_replica_{kind}: norms against the CPU "
                             f"port's and the written parameters': {rel}")
    return {"frozen_bits_equal": True, "active_bits_equal_to_off": True,
            "frozen_norms": got,
            "cpu_norms": dict(zip(("grad_norm", "param_norm"), cpu)),
            "rel_err_vs_cpu": rel, "active_param_norm": active,
            "active_written_param_norm": written}


def _frozen_sweep_cost(data, R=4, frozen=2):
    """What telemetry costs the R = 4 DBN sweep (lrs SWEEP_LRS, replica 2
    frozen; ROADMAP C.4's would-be norms): device ms per step of a replayed 4-step chunk and the peak
    memory, telemetry off and on, and on with every replica active (what
    the frozen replica's would-be update costs)."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model
    from repro_torch.train import TrainEngine

    chunks = _stacked_chunks(_train_batches(data, 8))
    frozen_mask = np.ones(R, bool)
    frozen_mask[frozen] = False
    out = {}
    for telemetry, mask in ((False, frozen_mask), (True, frozen_mask),
                            (True, np.ones(R, bool))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engine = TrainEngine(make_model("dbn", device="cuda"),
                             optim.adamw(0.99, weight_decay=1e-4,
                                         inject_lr=True),
                             chunk_batches=4, replicas=R,
                             telemetry=telemetry)
        engine.init_replica_params(list(range(R)))
        state = engine.set_replica_lrs(engine.init_opt_state(), SWEEP_LRS)
        engine.step(state, chunks[0], active=mask)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        engine.step(state, chunks[1], active=mask)
        end.record()
        end.synchronize()
        out["off" if not telemetry else "on" if not mask.all()
            else "on_all_active"] = {
            "device_ms_per_step": start.elapsed_time(end) / 4,
            "max_memory_allocated": torch.cuda.max_memory_allocated() - base,
            "captures": engine.graphs.captures}
        del engine, state
    return out


def phase_telemetry(data, card, steps=16):
    """On-device telemetry and the profiler window on the paper-width DBN:
    dense and with sparse tables, 16 steps with ``telemetry=True`` under a
    Recorder with a JsonlSink, equal to the bit to the run without it,
    still one capture and one replay per later chunk, a chunk's replay and
    staging under sync debug "error", every JSONL line valid, the first
    step's norms against the CPU port's; the norms' device ms against
    their bound and the warm step with telemetry on and off; a
    ProfileWindow over the first capture; the launcher end to end on a
    store with every observability flag."""
    import shutil
    import tempfile

    import torch

    from repro_torch import obs, optim
    from repro_torch.configs.clax_baidu import TRAIN_BATCH, make_model
    from repro_torch.obs.telemetry import stage
    from repro_torch.train import TrainEngine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    out = {}
    try:
        first = {k: v[:TRAIN_BATCH] for k, v in next(iter(
            _train_loader(data, steps))).items()}
        for kind in ("dense", "sparse"):
            sparse = SPARSE_TABLES if kind == "sparse" else {}
            plain = _run_dbn(f"telemetry_off_{kind}",
                             _train_loader(data, steps), steps, **sparse)
            jsonl = os.path.join(root, f"telemetry_{kind}.jsonl")
            model, trainer, _, counts, sink = _run_dbn(
                f"telemetry_on_{kind}", _train_loader(data, steps), steps,
                sink=obs.JsonlSink(jsonl), telemetry=True, **sparse)
            sink.close()
            graphs = trainer.engines[0].graphs
            one_replay = (graphs.captures == 1
                          and graphs.replays == steps // 4 - 1)
            versus = _versus(plain[0], plain[1], model, trainer)
            if any(g["elements_differing"] for g in versus.values()):
                raise AssertionError(f"telemetry_{kind}: parameters differ "
                                     f"from the run without it: {versus}")
            if not one_replay or counts["launches"] != plain[3]["launches"]:
                raise AssertionError(
                    f"telemetry_{kind}: {graphs.captures} captures and "
                    f"{graphs.replays} replays for {steps // 4} chunks, "
                    f"launches {counts['launches']}")
            events = obs.read_jsonl(jsonl, validate=True)
            metrics = [e for e in events if e["kind"] == "metric"]
            if [e["step"] for e in metrics] != list(range(steps)) or any(
                    not {"grad_norm", "param_norm"} <= set(e["data"])
                    for e in metrics):
                raise AssertionError(f"telemetry_{kind}: metric events "
                                     f"{[e['step'] for e in metrics]}")
            if [e["value"] for e in metrics] != plain[4].series(
                    "train_step"):
                raise AssertionError(f"telemetry_{kind}: losses differ "
                                     "from the run without telemetry")
            del plain
            gc.collect()
            # no host sync in a chunk: a replay and its staging
            chunk = _chunk_of(_device_batch(data, 0, TRAIN_BATCH), 4)
            probe = TrainEngine(model, optim.adamw(3e-3, weight_decay=1e-4),
                                chunk_batches=4, telemetry=True, **sparse)
            state = probe.init_opt_state()
            probe.step(state, chunk)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                _, payload = probe.step(state, chunk)
                staged = stage(payload)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            staged[1].synchronize()
            # the device time of the norms outside the update's pass (the
            # gradients'; with sparse tables each table's sum of squares
            # before its update), and their bound
            grads = [torch.randn_like(p) for p in probe.params]
            tables = [probe.params[at] for at in probe._table_at.values()]

            def norms():
                with torch.no_grad():
                    return (optim.global_norm(grads),
                            [torch.linalg.vector_norm(t) for t in tables])

            norm_ms = graph_ms(norms)
            n_bytes = sum(t.numel() * t.element_size()
                          for t in grads + tables)
            n_ops = 2 * sum(t.numel() for t in grads + tables)
            t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
            t_ops = n_ops / PEAK_FP32_PER_S * 1e3
            del grads, probe, state, payload, staged, chunk
            gc.collect()
            torch.cuda.empty_cache()
            gpu_first = metrics[0]["data"]
            cpu = _telemetry_cpu_norms(kind, first)
            rel = {k: abs(gpu_first[k] - c) / abs(c)
                   for k, c in zip(("grad_norm", "param_norm"), cpu)}
            if max(rel.values()) > 1e-5:
                raise AssertionError(f"telemetry_{kind}: norms against the "
                                     f"CPU port's: {rel}")
            frozen = _frozen_replica(kind, first, cpu)
            out[kind] = {
                "params_bits_equal_to_off": True, "versus_off": versus,
                "captures": graphs.captures, "replays": graphs.replays,
                "one_replay_per_chunk": one_replay,
                "launches": counts["launches"],
                "no_host_sync_in_chunk": True,
                "jsonl_lines": len(events), "jsonl_valid": True,
                "event_kinds": sorted({e["kind"] for e in events}),
                "first_step": gpu_first,
                "cpu_first_step": dict(zip(("grad_norm", "param_norm"),
                                           cpu)),
                "norms_rel_err_vs_cpu": rel, "frozen_replica": frozen,
                "norms_device_ms": norm_ms,
                "norms_bound_ms": max(t_bytes, t_ops),
                "norms_bound_by": ("bytes" if t_bytes >= t_ops
                                   else "operations")}
            del model, trainer, graphs
            gc.collect()
            torch.cuda.empty_cache()

        # the warm step with telemetry on and off, in turned rounds
        def warm(telemetry):
            model = make_model("dbn", device="cuda")
            trainer = _dbn_trainer(telemetry=telemetry,
                                   recorder=obs.Recorder([obs.MemorySink()]))
            trainer.epochs = 2
            seconds = trainer.train(model, _train_loader(data, steps))[1][
                "seconds"]
            return seconds / steps * 1e3

        warm_ms = {"on": [], "off": []}
        for r in range(3):
            for telemetry in ((True, False) if r % 2 == 0
                              else (False, True)):
                warm_ms["on" if telemetry else "off"].append(warm(telemetry))
                gc.collect()
                torch.cuda.empty_cache()
        out["warm_step_ms"] = {k: {**_spread(v), "runs": v}
                               for k, v in warm_ms.items()}

        # a profiler window over the first chunk's capture
        prof_dir = os.path.join(root, "profile")
        model = make_model("dbn", device="cuda")
        trainer = _keep_engines(_dbn_trainer(profile_steps="0:8",
                                             profile_dir=prof_dir))
        n = len(list(model.parameters()))
        _, prof_counts = measured_run(
            "telemetry_profile_window",
            lambda: trainer.train(model, _train_loader(data, steps)),
            {"examination_nll": steps, "adamw": n * steps},
            {"examination_nll": 4, "adamw": n * 4})
        graphs = trainer.engines[0].graphs
        traces = os.listdir(prof_dir)
        with open(os.path.join(prof_dir, traces[0])) as f:
            trace = json.load(f)
        device_events = sum(1 for e in trace.get("traceEvents", [])
                            if e.get("cat") == "kernel")
        if not (len(traces) == 1 and graphs.captures == 1
                and graphs.replays == steps // 4 - 1):
            raise AssertionError(f"telemetry: profile window wrote {traces}"
                                 f", {graphs.captures} captures")
        out["profile_window"] = {
            "steps": "0:8", "trace_files": traces,
            "trace_events": len(trace.get("traceEvents", [])),
            "trace_device_kernels": device_events,
            "capture_succeeded": True, "captures": graphs.captures,
            "replays": graphs.replays, "launches": prof_counts["launches"]}
        del model, trainer, graphs, trace
        gc.collect()
        torch.cuda.empty_cache()
        out["launcher"] = _launcher_observability(root)
        out["frozen_sweep_cost"] = _frozen_sweep_cost(data)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("telemetry", card=card, steps=steps, batch=TRAIN_BATCH, **out,
         seconds=time.perf_counter() - t_phase)


def _launcher_observability(root):
    """``python -m repro_torch.launch.train --store-dir <tmp> --ingest
    --metrics-out --trace-out --profile-steps 2:5`` on the card (UBM,
    200,000 sessions, one epoch): exit 0, every JSONL line valid, the
    Chrome trace and the profiler's trace parse."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    metrics = os.path.join(root, "launcher.jsonl")
    trace = os.path.join(root, "launcher_trace.json")
    prof = os.path.join(root, "launcher_profile")
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--store-dir",
            os.path.join(root, "launcher_store"), "--ingest", "--epochs", "1",
            "--ingest-workers", "2", "--verify-store", "--metrics-out",
            metrics, "--trace-out", trace, "--profile-steps", "2:5",
            "--profile-dir", prof]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launcher exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    from repro_torch import obs

    events = obs.read_jsonl(metrics, validate=True)
    with open(trace) as f:
        spans = json.load(f)["traceEvents"]
    profiles = os.listdir(prof)
    with open(os.path.join(prof, profiles[0])) as f:
        json.load(f)
    names = Counter(f"{e['kind']}/{e['name']}" for e in events)
    for want in ("metric/train_step", "span/shard_read", "span/epoch",
                 "span/eval", "epoch/epoch_record", "process/process",
                 "event/profile_start", "event/profile_stop"):
        if not names.get(want):
            raise AssertionError(f"launcher: no {want} event in {names}")
    tests = [line for line in proc.stdout.splitlines()
             if line.startswith("[train] test")]
    return {"exit": 0, "seconds": seconds, "jsonl_lines": len(events),
            "jsonl_valid": True, "events": dict(names),
            "trace_spans": len(spans), "profile_traces": profiles,
            "test": tests[-1] if tests else None}



# -- serving (slice 11) --------------------------------------------------------

SERVE_BUCKETS = (1, 4, 16, 64, 256, 512)
SERVE_PAIRS = 1 << 31           # configs/clax_baidu.py: 2^31 ids, hashed 10x
TOWER = "pbm_tower"
DRILL_PAIRS = 500


def _randomized(model, seed):
    """``model`` with every parameter drawn N(0, 0.5) from a seeded
    generator on its device (the tables start at constants, which int8
    would hold exactly)."""
    import torch

    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.5, generator=gen)
    return model


def _serve_requests(name, n, rng, n_pairs=SERVE_PAIRS, features=None):
    from repro_torch.serve import make_request

    reqs = [make_request(i, name, K_MAIN, rng, n_pairs) for i in range(n)]
    if features:
        for r in reqs:
            r.features = rng.normal(size=(K_MAIN, features)).astype(
                np.float32)
    return reqs


def _serve_registry():
    """The three paper-width entries, every (tier, bucket) captured: the
    DBN and UBM of configs/clax_baidu.py and the Listing-4 two-tower PBM
    (16 features), their weights drawn from seeds 1-3."""
    from repro_torch.configs.clax_baidu import (TOWER_FEATURES, make_model,
                                                make_two_tower)
    from repro_torch.serve import ModelRegistry

    reg = ModelRegistry(buckets=SERVE_BUCKETS)
    reg.add("dbn", _randomized(make_model("dbn", device="cuda"), 1), None,
            n_pairs=SERVE_PAIRS)
    reg.add("ubm", _randomized(make_model("ubm", device="cuda"), 2), None,
            n_pairs=SERVE_PAIRS)
    reg.add(TOWER, _randomized(make_two_tower("pbm", device="cuda"), 3),
            None, n_pairs=SERVE_PAIRS, feature_dim=TOWER_FEATURES)
    return reg


def _widened_forward(entry, tensors):
    """The dequantize-then-gather form of the int8 tier: every quantized
    leaf widened whole, then ``predict_clicks``."""
    import torch

    from repro_torch.distrib import QuantizedTensor, dequantize_int8
    from repro_torch.train.engine import call_with

    names = [n for n, qt in entry.qparams.items()
             if isinstance(qt, QuantizedTensor)]
    with torch.no_grad():
        return call_with(entry.model, names,
                         [dequantize_int8(*entry.qparams[n]) for n in names],
                         "predict_clicks", tensors)


def _int8_bound(entry):
    """max |dP(click)| the int8 tier may show: each quantized factor's
    logit moves at most scale/2, its probability at most a quarter of that,
    and a click probability is multilinear in at most 2K such factors."""
    from repro_torch.distrib import QuantizedTensor

    scales = [float(qt.scale) for qt in entry.qparams.values()
              if isinstance(qt, QuantizedTensor)]
    return 2 * K_MAIN * max(scales, default=0.0) / 2 / 4, scales


@contextlib.contextmanager
def _plain_dcn():
    """The port's ``dcn_cross`` op routed to its plain version on the card
    while the block runs; yields the list of each call's inputs (copies),
    the shapes the serving path gives the kernel."""
    from repro_torch.kernels import dcn_cross_plain, ops

    calls = []

    def plain(*args):
        calls.append(tuple(a.clone() for a in args))
        return dcn_cross_plain(*args)

    kernel, ops.dcn_cross_cuda = ops.dcn_cross_cuda, plain
    try:
        yield calls
    finally:
        ops.dcn_cross_cuda = kernel


def _tier_checks(reg, rng):
    """Each tier of each entry against its plain eager call at every
    bucket: primary equal to the bit to eager predict_clicks, the int8
    graph to the eager int8 call, gather-first to dequantize-then-gather,
    int8 within its bound of primary, prior constant; each quantized
    table's gathered rows within scale/2. The two-tower's graphs against
    its eager tiers with dcn_cross on its plain version, log_ctr within
    1e-5 (1 + |log_ctr|), and dcn_cross against dcn_cross_plain on the
    inputs the path gives it (bucket x 10 rows, D = 16), within
    phase_dcn_kernel's 1e-5."""
    import torch

    from repro_torch.core.parameterization import EmbeddingParameter
    from repro_torch.kernels import dcn_cross_cuda, dcn_cross_plain
    from repro_torch.serve import pad_batch

    out = {}
    for name, entry in reg.entries.items():
        bound, scales = _int8_bound(entry)
        worst = {"int8_dp": 0.0, "lookup_err_over_half_scale": 0.0}
        plain_route = {"log_ctr_abs_err": 0.0, "dcn_abs_err": 0.0,
                       "dcn_rows": []}
        for bucket in SERVE_BUCKETS:
            batch = pad_batch(_serve_requests(
                name, bucket, rng, features=entry.feature_dim), bucket,
                entry)
            tensors = {k: torch.from_numpy(v).cuda() for k, v in
                       batch.items()}
            primary = entry.run("primary", batch)
            int8 = entry.run("int8", batch)
            with torch.no_grad():
                eager = entry._fns["primary"](tensors).cpu().numpy()
                eager8 = entry._fns["int8"](tensors).cpu().numpy()
            widened = _widened_forward(entry, tensors).cpu().numpy()
            for what, a, b in (("primary", primary, eager),
                               ("int8_graph", int8, eager8),
                               ("gather_first", eager8, widened)):
                if not np.array_equal(a, b):
                    raise AssertionError(f"serve {name}/{bucket}: {what} "
                                         f"differs by {np.abs(a - b).max()}")
            if name == TOWER:
                with _plain_dcn() as calls, torch.no_grad():
                    plain = {t: entry._fns[t](tensors).cpu().numpy()
                             for t in ("primary", "int8")}
                for tier, got in (("primary", primary), ("int8", int8)):
                    err = np.abs(got - plain[tier])
                    if not (err <= 1e-5 * (1.0 + np.abs(plain[tier]))).all():
                        raise AssertionError(
                            f"serve {name}/{bucket}: the {tier} graph "
                            f"against dcn_cross_plain: {err.max()}")
                    plain_route["log_ctr_abs_err"] = max(
                        plain_route["log_ctr_abs_err"], float(err.max()))
                if len(calls) != 4 or any(a[0].shape[0] != bucket * K_MAIN
                                          for a in calls):
                    raise AssertionError(f"serve {name}/{bucket}: dcn_cross "
                                         f"calls {[a[0].shape for a in calls]}")
                for args in calls:
                    got, want = dcn_cross_cuda(*args), dcn_cross_plain(*args)
                    if _dcn_over(got, *args, want, 1e-5) > 0:
                        raise AssertionError(f"serve {name}/{bucket}: "
                                             "dcn_cross against its plain "
                                             "version")
                    plain_route["dcn_abs_err"] = max(
                        plain_route["dcn_abs_err"], _max_err(got, want))
                plain_route["dcn_rows"].append(bucket * K_MAIN)
            dp = float(np.abs(np.exp(primary) - np.exp(int8)).max())
            if not np.isfinite(primary).all() or dp > bound + 1e-6:
                raise AssertionError(f"serve {name}/{bucket}: int8 dP {dp} "
                                     f"over its bound {bound}")
            prior = entry.run("prior", batch)
            if not (prior == np.float32(entry.prior_log_ctr)).all():
                raise AssertionError(f"serve {name}: prior not constant")
            worst["int8_dp"] = max(worst["int8_dp"], dp)
            for mname, module in entry.model.named_modules():
                if isinstance(module, EmbeddingParameter):
                    rows = module.row_ids(tensors)
                    q, scale = entry.qparams[f"{mname}.table"]
                    err = float((q[rows].float() * scale
                                 - module.table.detach()[rows]).abs().max())
                    worst["lookup_err_over_half_scale"] = max(
                        worst["lookup_err_over_half_scale"],
                        err / (float(scale) / 2))
        if worst["lookup_err_over_half_scale"] > 1.0 + 1e-5:
            raise AssertionError(f"serve {name}: a lookup off by more than "
                                 f"scale/2: {worst}")
        out[name] = {"primary_bits_equal_eager": True,
                     "int8_graph_bits_equal_eager": True,
                     "gather_first_bits_equal_widened": True,
                     "prior_constant": True, "int8_scales": scales,
                     "int8_max_abs_dp": worst["int8_dp"],
                     "int8_dp_bound": bound,
                     "lookup_err_over_half_scale":
                         worst["lookup_err_over_half_scale"]}
        if name == TOWER:
            out[name]["versus_plain_dcn_cross"] = plain_route
    return out


def _busy_us(prof):
    """The device's busy microseconds in a torch.profiler trace: the union
    of its kernels' and copies' intervals."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


def _dispatch_ms(entry, tier, bucket, rng, reps=50):
    """One dispatch from host to host (pad, the copies, the replay, the
    answer on the host), ``reps`` times: host ms, the stream's span from
    the first copy to the answer's copy (CUDA events: the device's work
    and the gaps the host leaves in it), and the replay alone, back to
    back. The device's busy time comes from a torch.profiler trace (CUDA
    activity only, to keep the tracer's host cost small) of ``reps`` more
    dispatches: the union of its kernels' and copies' device time. The idle
    share is one minus that over the loop's host time under the trace, and
    over the untraced dispatches' median host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import pad_batch

    reqs = _serve_requests(entry.name, bucket, rng,
                           features=entry.feature_dim)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host, device = [], []
    for _ in range(reps + 3):
        t0 = time.perf_counter()
        batch = pad_batch(reqs, bucket, entry)
        start.record()
        replay = entry.launch(tier, batch)
        end.record()
        entry.collect(replay)
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        device.append(start.elapsed_time(end))
    host, device = host[3:], device[3:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            entry.collect(entry.launch(tier, pad_batch(reqs, bucket,
                                                       entry)))
        window_ms = (time.perf_counter() - t0) * 1e3
    busy_us, n_events = _busy_us(prof)
    if n_events == 0:
        raise AssertionError(f"serve {entry.name}/{tier}/{bucket}: the "
                             "trace holds no device work")
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        replay.graph.replay()
    end.record()
    end.synchronize()
    replay_ms = start.elapsed_time(end) / reps
    busy = busy_us / 1e3 / window_ms
    return {"host_ms": _spread(host), "stream_span_ms": _spread(device),
            "replay_device_ms": replay_ms,
            "traced_host_ms_per_dispatch": window_ms / reps,
            "traced_device_busy_ms_per_dispatch": busy_us / 1e3 / reps,
            "traced_device_events_per_dispatch": n_events / reps,
            "device_idle_share": 1.0 - busy,
            "device_idle_share_untraced_host": 1.0 - busy_us / 1e3 / reps
            / _spread(host)["median"]}


def _bulk(model, name, rng):
    """configs/clax_baidu.serve_bulk at 262,144 x 10: host to host, and
    predict_clicks alone on the device; its bound: the 32-byte sectors the
    gathers touch plus the batch's bytes in and the answer's out."""
    import torch

    from repro_torch.configs.clax_baidu import SHAPES, serve_bulk
    from repro_torch.core.parameterization import EmbeddingParameter

    rows = SHAPES["serve_bulk"]["batch"]
    batch = {"positions": np.tile(np.arange(1, K_MAIN + 1, dtype=np.int32),
                                  (rows, 1)),
             "query_doc_ids": rng.integers(0, SERVE_PAIRS, (rows, K_MAIN))
             .astype(np.int32),
             "mask": np.ones((rows, K_MAIN), bool)}
    host = []
    for _ in range(6):
        t0 = time.perf_counter()
        out = serve_bulk(model, batch)
        host.append((time.perf_counter() - t0) * 1e3)
    if out.shape != (rows, K_MAIN) or not np.isfinite(out).all():
        raise AssertionError(f"serve_bulk {name}: {out.shape}")
    tensors = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with torch.no_grad():
        device = time_ms(lambda: model.predict_clicks(tensors), iters=20,
                         warmup=3)
        sectors = sum(int(torch.unique(m.row_ids(tensors) // 8).numel())
                      for m in model.modules()
                      if isinstance(m, EmbeddingParameter))
        lines, total = profile_kernels(lambda: model.predict_clicks(tensors),
                                       calls=5)
    n_bytes = sectors * SECTOR + rows * K_MAIN * (4 + 4 + 1) \
        + rows * K_MAIN * 4
    return {"rows": rows, "host_ms": _spread(host[1:]),
            "profile": {"device_kernels": total, "top": lines[:8]},
            "device_ms": device, "rows_per_s_device": rows / device * 1e3,
            "rows_per_s_host": rows / _spread(host[1:])["median"] * 1e3,
            "table_sectors": sectors, "bound_bytes": n_bytes,
            "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def _drill_registry(device):
    """The chaos drill's registry (tests/test_torch_serve.py's: PBM and DBN
    over 500 pairs, buckets 1, 4, 16, modeled service times), its
    parameters drawn by numpy from seeds 0 and 1, on ``device``."""
    import torch

    from repro_torch.core import MODEL_REGISTRY
    from repro_torch.serve import ModelRegistry, ServiceModel

    reg = ModelRegistry(buckets=(1, 4, 16), service_model=ServiceModel())
    for seed, name in enumerate(("pbm", "dbn")):
        model = MODEL_REGISTRY[name](query_doc_pairs=DRILL_PAIRS,
                                     positions=K_MAIN, device=device)
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(rng.normal(
                    0.0, 0.5, tuple(p.shape)).astype(np.float32)))
        reg.add(name, model, None, n_pairs=DRILL_PAIRS,
                quantize_min_size=64)
    reg.warmup()
    return reg


def _drill(reg):
    """tests/test_torch_serve.py's pinned chaos drill: a failing primary
    for pbm's first 6 dispatches, every 7th request from the 6th poisoned,
    SIGTERM at request 70, on the virtual clock."""
    from repro_torch.serve import ServeEngine, VirtualClock, poisson_trace
    from repro_torch.testing import PoisonTrace, ServeKillSwitch, SlowModel

    trace = PoisonTrace(poisson_trace(90, qps=500.0, models=["pbm", "dbn"],
                                      positions_k=K_MAIN,
                                      n_pairs=DRILL_PAIRS, deadline_s=0.05,
                                      seed=1),
                        at=[5, 12, 19, 26, 33], seed=0)
    eng = ServeEngine(reg, clock=VirtualClock(), faults=[
        SlowModel(model="pbm", fail=True, at_dispatches=range(0, 6)),
        ServeKillSwitch(at_request=70)],
        breaker_kwargs=dict(window=8, min_samples=2, threshold=0.5,
                            cooldown=4))
    results = eng.run_trace(trace, handle_signals=True)
    return eng, results


def _serve_launcher(root):
    """``python -m repro_torch.launch.serve --models dbn,pbm --virtual-time
    --fault-poison-every 17 --fault-sigterm-at 150 --requests 300`` on the
    card: exit 0, one result per request (no drop in flight), every JSONL
    line valid."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    metrics = os.path.join(root, "serve.jsonl")
    summary = os.path.join(root, "serve_summary.json")
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--models",
            "dbn,pbm", "--virtual-time", "--fault-poison-every", "17",
            "--fault-sigterm-at", "150", "--requests", "300",
            "--metrics-out", metrics, "--summary-out", summary]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve launcher exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    from repro_torch import obs

    events = obs.read_jsonl(metrics, validate=True)
    with open(summary) as f:
        report = json.load(f)
    s = report["summary"]
    if s["requests"] != 300 or s["answered"] + s["shed"] + s[
            "rejected"] != 300 or report["counters"].get(
            "serve.drains") != 1:
        raise AssertionError(f"serve launcher: {report}")
    return {"exit": 0, "seconds": seconds, "summary": s,
            "drops_in_flight": 0, "jsonl_lines": len(events),
            "jsonl_valid": True,
            "trace_counts": {m: h["trace_counts"]
                             for m, h in report["health"].items()},
            "last_line": proc.stdout.strip().splitlines()[-1]}


def phase_serve_engine(card):
    """The serving engine on the card (slice 11): the paper-width DBN and
    UBM and the two-tower PBM in one registry, every (model, tier, bucket)
    captured at warmup, then a wall-clock Poisson trace of 2,000 requests
    at 1,000 requests/s with 50 ms deadlines, counted (dcn_cross: 2 per
    two-tower forward, eager warm-ups and replayed graph nodes); each tier
    against its eager call; each graph's kernel nodes; one dispatch timed
    host to host; no host sync in a launch; serve_bulk; the chaos drill
    against the CPU port's; the launcher's SIGTERM drill."""
    import shutil
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.serve import ServeEngine, WallClock, poisson_trace
    from repro_torch.train import capture

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(11)
    reg = _serve_registry()
    entries = reg.entries
    tower = entries[TOWER]

    def main_path():
        reg.warmup()
        before = {n: dict(e.trace_counts) for n, e in entries.items()}
        trace = poisson_trace(2000, qps=1000.0, models=list(entries),
                              positions_k=K_MAIN, n_pairs=SERVE_PAIRS,
                              deadline_s=0.05, seed=0)
        feats = np.random.default_rng(1)
        for r in trace:
            if r.model == TOWER:
                r.features = feats.normal(size=(K_MAIN, tower.feature_dim)
                                          ).astype(np.float32)
        eng = ServeEngine(reg, clock=WallClock(),
                          recorder=obs.Recorder([obs.MemorySink()]))
        results = eng.run_trace(trace, handle_signals=False)
        return before, eng, results

    def tower_launches(out):
        del out
        return {"dcn_cross": 2 * (2 * len(SERVE_BUCKETS) + tower.replays)}

    (before, eng, results), counted = measured_run(
        "serve_engine", main_path, tower_launches,
        lambda _: {"dcn_cross": 2 * 2 * len(SERVE_BUCKETS)})
    after = {n: dict(e.trace_counts) for n, e in entries.items()}
    want = {"primary": len(SERVE_BUCKETS), "int8": len(SERVE_BUCKETS)}
    if any(c != want for c in before.values()) or after != before:
        raise AssertionError(f"serve_engine: captures {before} -> {after}")
    summary = eng.summary(results)
    if summary["requests"] != 2000 or sorted(
            r.request_id for r in results) != list(range(2000)):
        raise AssertionError(f"serve_engine: {summary}")
    # no model error, nothing degraded: every answer from a primary graph
    answered_tiers = Counter(r.tier for r in results if r.answered)
    if (eng.stats["serve.model_errors"] or summary["degraded"]
            or summary["rejected"] or not summary["answered"]
            or set(answered_tiers) != {"primary"}):
        raise AssertionError(f"serve_engine: {summary}, {dict(eng.stats)}, "
                             f"tiers {dict(answered_tiers)}")
    model_errors = eng.stats["serve.model_errors"]
    # each graph's kernel nodes: dcn_cross twice in the tower's, never in
    # the DBN's or the UBM's
    nodes = {}
    for name, entry in entries.items():
        for key, replay in entry._replays.items():
            n = port_kernels(capture.graph_kernels(
                replay.graph.raw_cuda_graph())).get("dcn_cross", 0)
            if n != (2 if name == TOWER else 0):
                raise AssertionError(f"serve_engine: {name} {key[0]} graph "
                                     f"holds {n} dcn_cross nodes")
            nodes[f"{name}/{key[0]}/{len(replay.host['positions'])}"] = n
    tiers = _tier_checks(reg, rng)
    # one dispatch, host to host, and no host sync in a launch
    dispatch = {}
    for name, entry in entries.items():
        for tier in ("primary", "int8"):
            for bucket in (1, 512):
                dispatch[f"{name}/{tier}/{bucket}"] = _dispatch_ms(
                    entry, tier, bucket, rng)
    from repro_torch.serve import pad_batch

    for name, entry in entries.items():
        for bucket in (1, 512):
            batch = pad_batch(_serve_requests(name, bucket, rng,
                                              features=entry.feature_dim),
                              bucket, entry)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                replay = entry.launch("primary", batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            entry.collect(replay)
    # the whole-table dequantize form as a yardstick, the DBN at 512
    dbn = entries["dbn"]
    batch = pad_batch(_serve_requests("dbn", 512, rng), 512, dbn)
    tensors = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    widen_ms = time_ms(lambda: _widened_forward(dbn, tensors), iters=10,
                       warmup=2)
    bulk = {name: _bulk(entries[name].model, name, rng)
            for name in ("dbn", "ubm")}
    sizes = {name: {"primary_nbytes": e.primary_nbytes,
                    "int8_nbytes": e.int8_nbytes,
                    "trace_counts": e.trace_counts,
                    "capture_ms": {k: v * 1e3 for k, v in
                                   e.capture_seconds.items()}}
             for name, e in entries.items()}
    del reg, entries, tower, dbn, tensors, eng, results
    gc.collect()
    torch.cuda.empty_cache()

    # the chaos drill on the card against the CPU port's
    gpu_eng, gpu_res = _drill(_drill_registry("cuda"))
    cpu_eng, cpu_res = _drill(_drill_registry("cpu"))
    sig = [(r.request_id, r.status, r.tier, r.reason) for r in gpu_res]
    if sig != [(r.request_id, r.status, r.tier, r.reason)
               for r in cpu_res] or dict(gpu_eng.stats) != dict(
                   cpu_eng.stats):
        raise AssertionError("serve chaos drill: the card's signature or "
                             "counters differ from the CPU port's")
    drill_err = max(float(np.abs(a.log_ctr - b.log_ctr).max())
                    for a, b in zip(gpu_res, cpu_res) if a.answered)
    if drill_err > 1e-5:
        raise AssertionError(f"serve chaos drill: log_ctr {drill_err}")
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        launcher = _serve_launcher(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("serve_engine", card=card, buckets=list(SERVE_BUCKETS),
         entries=sizes, launches=counted["launches"],
         wrapper_launches=counted["wrapper_launches"],
         replayed_launches=counted["replayed_launches"],
         dcn_cross_nodes_per_graph=nodes, captures_before_trace=before,
         captures_after_trace=after, trace=summary,
         trace_answered_tiers=dict(answered_tiers),
         trace_model_errors=model_errors, tiers=tiers,
         dispatch=dispatch, no_host_sync_in_launch=True,
         dequantize_whole_tables_ms=widen_ms, serve_bulk=bulk,
         chaos_drill={"signature_equal_cpu": True,
                      "counters": dict(gpu_eng.stats),
                      "max_log_ctr_err_vs_cpu": drill_err},
         launcher=launcher, seconds=time.perf_counter() - t_phase)
    return counted["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    phase_profile(smi)
    kernels = phase_kernels(smi)
    kernels.update(phase_recsys_kernels(smi))
    kernels.update(phase_dcn_kernel(smi))
    data = _synthetic_log(17 * B_MAIN)  # 16 training batches + 1 held out
    kernels.update(phase_optimizer_kernels(smi, data))
    # The six kernels this slice left untouched, as the run-to-run control:
    # their device ms beside the last run before it.
    emit("control", card=smi, device_ms={
        name: kernels[name]["device_ms"]["kernel"]
        for name in CONTROL_DEVICE_MS}, earlier_device_ms=CONTROL_DEVICE_MS)
    phase_train("dbn", data, 16, smi)
    dbn = phase_train("dbn_sparse", data, 16, smi)
    dctr = phase_train("dctr", data, 8, smi)
    phase_train("ubm", data, 8, smi, extra=ubm_marginal_check)
    phase_cpu_vs_gpu(data)
    tower_data, truth = _two_tower_log(9 * B_MAIN)  # 8 batches + 1 held out
    two_tower = phase_train_two_tower("pbm", tower_data, truth, 8, smi)
    phase_train_two_tower("dctr", tower_data, truth, 8, smi)
    deepfm = phase_recsys("deepfm", smi)
    autoint = phase_recsys("autoint", smi)
    phase_recsys_cpu_vs_gpu()
    # The Trainer's run contract, after the paths of earlier slices.
    phase_train_sweep_two_tower(tower_data, smi)
    del tower_data
    phase_train_sweep_dbn(data, smi)
    phase_guard_dbn(data, smi)
    phase_resume_dbn(data, smi)
    phase_em(data, smi)
    # The out-of-core data plane and its observability, after every
    # earlier path.
    phase_store(data, smi)
    phase_telemetry(data, smi)
    del data
    # The serving engine, after every earlier path.
    phase_serve_engine(smi)
    # Each kernel's launches in the training run of its path.
    for name, counts in (("examination_nll", dbn), ("session_nll", dctr),
                         ("embedding_bag", deepfm),
                         ("fm_interaction", deepfm),
                         ("flash_attention", autoint),
                         ("dcn_cross", two_tower),
                         ("adamw", dbn), ("sparse_adamw", dbn)):
        kernels[name]["launches"] = counts[name]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
