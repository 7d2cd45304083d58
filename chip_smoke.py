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
                  BST's attention (65,536, 8, 8, 21, 21, 4) in its
                  (B, S, H, Dh)-backed layout and BST's retrieval bag, one
                  (1, 20) mean bag over a 20,000,000 x 32 table, each a row
                  of its own;
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
                  torch.optim.SparseAdam; its forms (the live run walked,
                  the table gradient read at the live rows: the engine's)
                  and its first design, each equal to the bit to the
                  every-slot form, all timed; edges: unhashed Zipf ranks at
                  the same size, d = 3, bf16 moments, every row touched,
                  the same decay case, and the live run's edges (a
                  row-sharded rank's ids with sentinels on both sides, per
                  slot and table gradient; every slot a sentinel; one live
                  slot; a run that ends at the last slot).
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
                  Then gather_forms: table_lookup's row gather as
                  indexing, F.embedding and the port's index_add_ form, in
                  turns on one training batch: the loss's forward and
                  backward ms, the gathers alone, bits over two runs, the
                  most repeated row (after every train phase below too;
                  MIND also with its padding redrawn).
11. serve_autoint, train_autoint   the same for AutoInt: three
                  flash_attention launches per forward.
12. cpu_vs_gpu_recsys   the reduced DeepFM, AutoInt, BST and MIND: CPU
                  (plain) and GPU (kernels) agree on loss, every gradient
                  and the served scores.
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
                  and restore seconds and bytes. Beside it, in processes
                  of its own, the launcher's SIGKILL drill at its default
                  size (3 epochs; its two runs at once):
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
                  DBN and UBM against its bound, its pinned staging and
                  the pageable route in turns (answers equal to the bit,
                  host ms a call, the fill's and the DMA's GB/s, the piece
                  size swept, one staging set); the chaos drill on the
                  card against the CPU port's (signature, counters,
                  log_ctr); the launcher's SIGTERM drill in a subprocess.

16. Slice 12, after every earlier path:
   conformance    testing.conformance.run_conformance on the card: JAX's specs
                  at every shape, float32 and bfloat16 (flash_attention also
                  as (B, S, H, Dh)-backed views), values and gradients of
                  the kernel route (the public op: kernel forward, the op's
                  backward) against the plain route's autograd at TOLS
                  (1e-5, 2e-2), the extreme corpora and examination_nll's
                  saturated sessions; one line per kernel (cells, held,
                  largest value and gradient errors).
   serve_bst, train_bst   BST at its published width (a 20,000,000 x 32
                  table, 8 heads, S = 21, MLP 1024-512-256) on a synthetic
                  sequence log: serve at 512 and 262,144 rows and score
                  1,000,000 candidates (first and last 512 held to the
                  plain forward), then 8 AdamW(1e-3) steps at 65,536 rows:
                  one flash_attention per forward, one embedding_bag per
                  retrieval call, one adamw per parameter tensor a step;
                  peak memory allocated and reserved.
   serve_mind, train_mind   the same for MIND (10,000,000 x 64, 4
                  interests, history 50 with -1 padding): no kernel but
                  adamw.

17. Slice 13, after every earlier path:
   kernel adamw_bf16   adamw over llama3.2-1b's 1,498,482,688 parameter
                  elements in bfloat16, with bfloat16 and float32 gradients
                  and float32 and bfloat16 moments, against the plain chain
                  on the card tensor by tensor (moments equal to the bit,
                  the parameters' elements apart counted and held within
                  two bfloat16 steps), its predicate and norm modes and
                  edge cases; the 24 B (float32 g and moments) and 14 B
                  (all bfloat16) forms timed against their bounds, the
                  latter beside torch.optim.AdamW(fused=True).
   gnn            GraphSAGE (2 layers, hidden 128) on the copied
                  random_graph at JAX's four shapes, adam(1e-2): Reddit's
                  sampled minibatch_lg (232,965 nodes, 114,615,892 edges,
                  d 602, batch 1,024, fanout 15-10; 8 steps of one target
                  batch, the host's sample and gather, the copy and the
                  device step timed apart), ogb_products full batch
                  (2,449,029 nodes, 61,859,140 edges, d 100; 2 steps, its
                  edges summed in chunks; peak memory), full_graph_sm
                  (Cora's shape) and molecule (128 graphs of 30 nodes), 8
                  steps each; every loss falls; 6 adamw launches a step.
                  Then the reduced config on the CPU port and the card,
                  float32, at 1e-5 (gnn_cpu_vs_gpu).
   lm             llama3.2-1b (4 steps, global batch 4 of JAX's 256, 2
                  microbatches), granite-moe-1b-a400m (4 steps, batch 4)
                  and phi3-mini-3.8b (4 steps, batch 4, 4 microbatches,
                  scan_chunks 4) at their FULL widths, bfloat16, seq 4,096,
                  adamw(3e-4) over bfloat16 parameters (one launch per
                  tensor a step), on one repeated batch whose loss must
                  fall: tokens/s and peak memory (and one more llama3.2-1b
                  step under torch.profiler: its top kernels, the device's
                  busy ms); then one 32,768-token
                  prompt prefilled and 8 tokens decoded at batch 2 against
                  its cache (ms, tokens/s, no kernel); llama3-405b and
                  Maverick on meta (parameter counts). Then the five
                  reduced configs, float32, on the CPU port and the card:
                  logits, loss, gradients, AdamW steps with 1 and 2
                  microbatches, prefill and two decode steps at 1e-5
                  (lm_cpu_vs_gpu).
   grouped_mm     Moonlight-16B-A3B's grouped GEMM (kernels/grouped_mm.py,
                  torch._grouped_mm on the card) at its scoring cell's
                  shapes, one MoE layer of 8 x 4,096 tokens routed top-6 of
                  64 experts (196,608 rows): the gate and the down
                  projection against the plain form (within 2 bfloat16
                  ulps), device ms beside the bound and the plain form;
                  edges with empty experts.
18. Slice 14, after every earlier path:
   distrib        a world of one under NCCL (make_data_parallel_mesh()):
                  the paper-width DBN (dense and sparse tables) and DCTR
                  through Trainer.train(mesh=...), two epochs of 8 steps,
                  each equal to the bit (parameters, losses) to the same
                  run without a mesh, the launch counts exact in both
                  (NCCL's kernel nodes in the replayed graphs counted
                  apart, nccl_nodes); the warm step, peak memory, and one
                  replay's device us (NCCL's apart) with and without the
                  mesh, the replay under sync debug "error"; then
                  masked_psum_lookup (value to the bit, gradient at 1e-5)
                  and compressed_psum (to the bit) against their plain
                  forms, timed; GraphSAGE's edge-sharded and
                  dst-partitioned forms against the unsharded one at
                  full_graph_sm (logits, 8 steps' losses at 1e-5) and the
                  edge-sharded step at ogb_products on the graph the gnn
                  phase built (ms, peak, losses against the gnn phase's);
                  and, with several cards, a world over all of them (the
                  DBN's parameters against the world of one at 1e-5, the
                  all-reduce of its tables' gradients timed); with one
                  card a line says that part did not run. Between them,
                  the launcher with --data-parallel (a world of one) and
                  without, at once in two processes: records to the bit.
                  Since slice 15 the sparse tables run the route of any
                  model size (each model rank's block of the union's
                  rows), and a world of one must replay no NCCL kernel
                  node.
19. Slice 15, after every earlier path:
   lm_mesh        the LM family's sharded forms on a (1, 1) mesh: the
                  reduced llama3.2-1b and granite-moe configs in float32
                  through the mesh forms on the CPU port (a gloo world of
                  one) and on the card (NCCL), logits, loss, gradients, a
                  step, prefill, plain and flash decode at 1e-5
                  (lm_mesh_cpu_vs_gpu); llama3.2-1b at FULL width, 4 steps
                  with explicit_row_parallel off and on against the lm
                  phase's run without a mesh (losses within 2e-2,
                  tokens/s, peak, what the FSDP gathers copy);
                  granite-moe's capacity-bounded MoE (its losses fall) and
                  at capacity factor 32 against the dense oracle (within
                  2e-2); llama's decode against a seeded cache of the most
                  rows that fit, without a mesh, plain and with flash
                  decoding (ms a token, logits within 2e-2 relative L2);
                  and, with several cards, a (1, N) world (llama's step
                  and flash decode with tensor parallelism, the DBN's
                  sparse tables on model = N) against the world of one;
                  with one card a line says that part did not run.
20. Slice 16, after every earlier path:
   dryrun         the dry run (launch/dryrun.py) in two subprocesses,
                  started first so that their host work overlaps the
                  holds: six cells (the paper-width DBN and DeepFM
                  train_batch, AutoInt serve_p99, GraphSAGE ogb_products,
                  llama3.2-1b train_4k, llama3-405b decode_32k) for rank
                  0 of a fake world of 256 with fake CUDA tensors, each
                  meeting exactly its kernel ops (none launched; a fake
                  tensor's data_ptr raises), their bytes kernels/cost.py's
                  for the local shapes, one line a cell; and the DBN and
                  DeepFM cells at a world of one.
   roofline_dbn   Trainer(emit_roofline=True) on the paper-width DBN, one
                  chunk of 4: one roofline event (examination_nll 16.4 MB
                  and adamw 12.03 GB a step, kernels/cost.py's bound
                  bytes), parameters, losses and launch counts equal to
                  the bit to the run without it.
   recsys_mesh    DeepFM and BST at published width on a (1, 1) NCCL mesh,
                  4 steps against no mesh within 1e-5 (run under
                  deterministic algorithms: index_add_'s sorted path),
                  embedding_bag / flash_attention launches equal; then
                  the two world-of-one cells' real steps, their peak
                  beside the dry run's (dryrun_peak; told, not held).

Every phase that drives a path sets every kernel's launch count to 0 just
before it and reads the counts just after; they must be exact (where
graphs replay, the wrappers' and the graphs' kernel nodes together). A
control
line holds the device times of the six kernels this slice left untouched
beside the last runs before it. Then the kernel summary line (the six
ports of TPU kernels, each with its conformance summary, the optimizer's
two, BST's attention and retrieval bag and adamw over bfloat16 parameters
as rows of their own), the card's
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

from repro_torch.kernels import cost  # noqa: E402 (needs the path above)

B_MAIN, K_MAIN = 65536, 10
# H100 SXM peaks (NVIDIA data sheet), as kernels/cost.py holds them: HBM3
# bandwidth, fp32 outside the tensor cores. Every bound below is
# kernels/cost.py's: the work each kernel op must do.
PEAK_BYTES_PER_S = cost.PEAK_BYTES_PER_S
PEAK_FP32_PER_S = cost.PEAK_FP32_PER_S
RTOL, ATOL = 1e-5, 1e-6
# Device ms of the six kernels this slice leaves untouched, from the last
# runs before it (PERF.md's kernel table and the runs it cites; NVIDIA H100
# 80GB HBM3, 700.00 W).
CONTROL_DEVICE_MS = {"examination_nll": 0.01265, "session_nll": 0.00551,
                     "embedding_bag": 0.02810, "fm_interaction": 0.0439,
                     "flash_attention": 0.507, "dcn_cross": 0.0712}


_T0 = time.perf_counter()


def emit(phase: str, **data) -> None:
    """One JSON line, with ``t``: seconds since the script started."""
    print(json.dumps({"phase": phase, **data,
                      "t": round(time.perf_counter() - _T0, 2)}), flush=True)


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


def _meta(*shape, dtype=None):
    """A shape and a type, for kernels/cost.py."""
    import torch

    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


def bound(name, rows, cols):
    """(bound_ms, bound_by) of a loss kernel over (rows, cols), from
    kernels/cost.py: inputs read once, a scalar written."""
    x = _meta(rows, cols)
    return cost.bound_ms(cost.COSTS[name](x, x, None))


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
    _LAST_REPLAYED.clear()
    _LAST_REPLAYED.update(replayed)
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
    index_select_nodes = sum(
        n for name, n in _LAST_REPLAYED.items()
        if "indexselect" in name.lower().replace("_", ""))
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
            "index_select_nodes": index_select_nodes,
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
    # The sparse route reads each table's gradient where it lies: its
    # replay holds no index_select node beyond the dense route's.
    if kind == "dbn":
        _KEPT["dbn_index_select_nodes"] = timing["index_select_nodes"]
    elif kind == "dbn_sparse" and "dbn_index_select_nodes" in _KEPT:
        found["index_select_nodes_as_dense"] = (
            timing["index_select_nodes"] == _KEPT["dbn_index_select_nodes"])
        if not found["index_select_nodes_as_dense"]:
            raise AssertionError(
                f"dbn_sparse: {timing['index_select_nodes']} index_select "
                f"nodes a replay, the dense route "
                f"{_KEPT['dbn_index_select_nodes']}")
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
    """(bound_ms, bound_by), kernels/cost.py's: x0 and x read once, W and b
    read once, the float32 output written once; 2 D operations per output
    element for the product, 3 for the epilogue (+ b, * x0, + x)."""
    import torch

    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    x, w, b = _meta(rows, dim, dtype=dt), _meta(dim, dim, dtype=dt), \
        _meta(dim, dtype=dt)
    return cost.bound_ms(cost.dcn_cross(x, x, w, b))


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
SECTOR = cost.SECTOR


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


def adamw_bound(n, moments="float32", params="float32", grads="float32"):
    """(bound_ms, bound_by) of one adamw launch over n elements, from
    kernels/cost.py: p, g and both moments read, p and the moments written,
    each in its type (28 bytes an element in float32)."""
    import torch

    def meta(dtype):
        return _meta(n, dtype=getattr(torch, dtype))

    return cost.bound_ms(cost.adamw(meta(params), meta(grads),
                                    meta(moments), meta(moments)))


def sparse_adamw_bound(live_rows, slots, table_grad=False, spanned=False):
    """For a (R, 1) float32 table and moments: each distinct 32-byte sector
    that this run's touched rows fall in (eight rows a sector), read and
    written, in each of p, m and v; the 8-byte id of each slot walked
    (every slot, or with ``spanned`` the live run's), and each live slot's
    4-byte gradient (the kernel reads no gradient of a sentinel slot), read
    in order, or with ``table_grad`` the same sectors of the table gradient
    read."""
    import torch

    sectors = torch.unique(live_rows // (SECTOR // 4)).numel()
    table = _meta(DBN_ROWS, 1)
    grads = table if table_grad else _meta(slots, 1)
    span = _meta(2, dtype=torch.int64) if spanned else None
    return cost.bound_ms(cost.sparse_adamw(
        table, table, table, _meta(slots, dtype=torch.int64), grads,
        span=span, table_grad=table_grad, sectors=sectors,
        live=live_rows.numel()))


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
    parameters far past the tolerance, checked to be so. sparse_adamw's
    forms (the live run of ``live_span`` and of the dedupe's span; the
    table gradient read at the live rows, the engine's form), each against
    its every-slot form to the bit, timed in this call; and the live run's
    edges. (Its first design is timed beside it from a checkout of that
    tree: ``scripts/sparse_adamw_trees.py``.)"""
    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.core.parameterization import hash_ids
    from repro_torch.kernels import sparse_adamw_cuda, sparse_adamw_plain
    from repro_torch.optim.sparse import (init_sparse_table_state, live_span,
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
    rows, dedupe_span = unique_rows_with_sentinel(ids, DBN_ROWS,
                                                  return_span=True)
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
    # the live run: [0, count) from the dedupe (the engine's), and its
    # [start, end) found by live_span (a mesh's); the table gradient that
    # holds each live slot's gradient at its row (the engine's form reads it)
    bounds = torch.tensor([0, DBN_ROWS], dtype=torch.int64, device=device)
    span, zipf_span = live_span(rows, bounds), live_span(zipf_rows, bounds)
    d_table = torch.zeros(DBN_ROWS, 1, device=device)
    d_table[rows[:live]] = row_grads[:live]

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
    del tp, sp
    torch.cuda.empty_cache()
    # the kernel's forms against its every-slot form above: p, m and v to
    # the bit (held below with the other checks)
    for form, (grads_, extra) in {
            "span": (row_grads, dict(span=span)),
            "dedupe_span": (row_grads, dict(span=dedupe_span)),
            "table_grad": (d_table, dict(span=dedupe_span,
                                         table_grad=True))}.items():
        tf, sf = run(sparse_adamw_cuda, before, rows, grads_, 2,
                     {**kw, **extra})
        checks[f"{form}_bit_equal"] = bool(
            torch.equal(tf, tk) and torch.equal(sf.mu, sk.mu)
            and torch.equal(sf.nu, sk.nu))
        del tf, sf
        torch.cuda.empty_cache()
    del tk, sk
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
    # the norm mode (the telemetry's param_norm) in the engine's form, apply
    # and pred each True and False: the kernel writes what the predicate
    # form writes under pred & apply, to the bit, and the touched rows' sum
    # of squares it implies (theirs before plus its p'^2 - p^2) is the plain
    # form's, within 1e-5
    touched_before = float(torch.sum(before[rows[:live]].double() ** 2))

    def norm_run(kernel, apply, pred):
        t = before.clone()
        st = init_sparse_table_state(t)
        count = st.count + apply
        st.count.add_(pred & apply)
        delta = kernel(t, st.mu, st.nu, rows, d_table, count,
                       pred=pred & apply, norm=True, apply=apply,
                       span=dedupe_span, table_grad=True, **kw)
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
    live_run_edges = _sparse_live_run_edges(gen, kw)
    t = before.clone()
    st = init_sparse_table_state(t)
    engine_form = dict(span=dedupe_span, table_grad=True)

    def sparse_kernel(rows_=rows, pred=None, grads_=row_grads, **form):
        sparse_adamw_cuda(t, st.mu, st.nu, rows_, grads_, st.count,
                          pred=pred, **kw, **form)

    def engine_kernel(pred=None):
        sparse_kernel(pred=pred, grads_=d_table, **engine_form)

    s_ms = time_ms(engine_kernel, iters=100)
    # "kernel": the engine's form; "every_slot": the per-slot form without
    # a span, every slot walked
    s_device = {"kernel": graph_ms(engine_kernel),
                "per_slot_span": graph_ms(lambda: sparse_kernel(span=span)),
                "every_slot": graph_ms(sparse_kernel),
                "kernel_pred_true": graph_ms(lambda: engine_kernel(yes)),
                "kernel_pred_false": graph_ms(lambda: engine_kernel(no)),
                "dedupe": graph_ms(lambda: unique_rows_with_sentinel(
                    ids, DBN_ROWS)),
                "live_span": graph_ms(lambda: live_span(rows, bounds)),
                "zipf_ranks_kernel": graph_ms(
                    lambda: sparse_kernel(zipf_rows, span=zipf_span))}
    # What holds it: the floor of one live slot; the same live count drawn
    # from the table's first 8,000,000 rows (the touched pages' spread);
    # and cold L2 (a 512 MB write between calls evicts the rows; its own
    # time taken out)
    one_live = unique_rows_with_sentinel(
        torch.full((SPARSE_SLOTS,), 12_345, device=device), DBN_ROWS)
    compact = unique_rows_with_sentinel(
        torch.randperm(8_000_000, generator=gen, device=device)[:live],
        DBN_ROWS, max_unique=SPARSE_SLOTS)
    for name, rows_ in (("one_live", one_live), ("compact_rows_8m", compact)):
        span_ = live_span(rows_, bounds)
        s_device[name] = graph_ms(lambda: sparse_kernel(rows_, span=span_))
    del one_live, compact
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device=device)
    flush_ms = graph_ms(lambda: flush.add_(1))

    def cold_ms(fn):
        def after_flush():
            flush.add_(1)
            fn()
        return graph_ms(after_flush) - flush_ms

    s_device["cold"] = {
        "kernel": cold_ms(engine_kernel),
        "per_slot_span": cold_ms(lambda: sparse_kernel(span=span))}
    del flush
    s_plain_ms = time_ms(lambda: sparse_adamw_plain(
        t, st.mu, st.nu, rows, d_table, st.count, **kw, **engine_form),
        iters=5, warmup=1)
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
    # each form's own bound: every slot's id read, or the live run's
    slot_bound_ms, _ = sparse_adamw_bound(live_rows, SPARSE_SLOTS)
    span_bound_ms, _ = sparse_adamw_bound(live_rows, SPARSE_SLOTS,
                                          spanned=True)
    s_bound_ms, s_bound_by = sparse_adamw_bound(live_rows, SPARSE_SLOTS,
                                                table_grad=True, spanned=True)
    zipf_bound_ms, _ = sparse_adamw_bound(zipf_rows[:zipf_live],
                                          SPARSE_SLOTS, spanned=True)
    form_bounds = {"kernel": s_bound_ms, "per_slot_span": span_bound_ms,
                   "every_slot": slot_bound_ms}
    share_of_bound = {form: bound / s_device[form]
                      for form, bound in form_bounds.items()}
    emit("kernel", name="sparse_adamw", shape=[DBN_ROWS, 1, SPARSE_SLOTS],
         live_rows=live, span=span.tolist(), card=card, kernel_ms=s_ms,
         plain_ms=s_plain_ms,
         library_ms=s_library_ms,
         library="torch.optim.SparseAdam on the live rows' COO gradient "
                 "(no weight decay: timed, not held)",
         dedupe_ms=dedupe_ms, device_ms=s_device, bound_ms=s_bound_ms,
         bound_by=s_bound_by, form_bounds_ms=form_bounds,
         share_of_bound=share_of_bound, max_abs_err=err, checks=checks,
         zipf_ranks={"live_rows": zipf_live, "bound_ms": zipf_bound_ms},
         live_run_edges=live_run_edges,
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
        "form_bounds_ms": form_bounds, "live_rows": live,
        "predicate": s_predicate,
        "held": True}
    del before, touched, ids, rows, zipf_rows, row_grads, d_table
    gc.collect()
    torch.cuda.empty_cache()
    return results


def _sparse_live_run_edges(gen, kw):
    """sparse_adamw with the span its callers compute against the plain
    version without one (every slot walked), three steps over a (1000, 2)
    table: a row-sharded rank's ids (the global ids of 4000 rows deduped
    and shifted into the block [1000, 2000), sentinels on both sides of
    the run), per slot and with the table gradient; every slot a sentinel;
    one live slot; a run that ends at the last slot (no padding). The
    parameters within the main case's tolerance, the moments and the rows
    off the run equal to the bit; raises otherwise."""
    import torch

    from repro_torch.kernels import sparse_adamw_cuda, sparse_adamw_plain
    from repro_torch.optim.sparse import (init_sparse_table_state, live_span,
                                          unique_rows_with_sentinel)

    device = torch.device("cuda")
    n_rows, d, slots = 1000, 2, 700

    def bounds(lo, hi):
        return torch.tensor([lo, hi], dtype=torch.int64, device=device)

    def ids_of(case):
        if case.startswith("mesh_layout"):
            unique = unique_rows_with_sentinel(torch.randint(
                0, 4 * n_rows, (3 * n_rows,), generator=gen, device=device),
                4 * n_rows)
            local = unique - n_rows
            return (torch.where((local >= 0) & (local < n_rows), local,
                                n_rows),
                    live_span(unique, bounds(n_rows, 2 * n_rows)))
        if case == "all_sentinel":
            ids = torch.full((slots,), n_rows, device=device)
        elif case == "one_live":
            ids = unique_rows_with_sentinel(
                torch.full((slots,), 417, device=device), n_rows)
        else:  # run_to_last_slot
            ids = torch.sort(torch.randperm(n_rows, generator=gen,
                                            device=device)[:slots]).values
        return ids, live_span(ids, bounds(0, n_rows))

    out, bad = {}, {}
    for case in ("mesh_layout", "mesh_layout_table_grad", "all_sentinel",
                 "one_live", "run_to_last_slot"):
        ids, span = ids_of(case)
        table_grad = case.endswith("table_grad")
        grads = torch.randn(n_rows if table_grad else ids.numel(), d,
                            generator=gen, device=device)
        base = torch.randn(n_rows, d, generator=gen, device=device)
        runs = []
        for kernel, extra in ((sparse_adamw_cuda, dict(span=span)),
                              (sparse_adamw_plain, {})):
            t = base.clone()
            st = init_sparse_table_state(t)
            for _ in range(3):
                st.count.add_(1)
                kernel(t, st.mu, st.nu, ids, grads, st.count,
                       table_grad=table_grad, **kw, **extra)
            runs.append((t, st))
        (tk, sk), (tp, sp) = runs
        off = torch.ones(n_rows, dtype=torch.bool, device=device)
        off[ids[ids < n_rows]] = False
        row = {"live": int((ids < n_rows).sum()), "span": span.tolist(),
               "params_over": _over(tk, tp, 1e-6, 1e-6),
               "params_abs_err": _max_err(tk, tp),
               "moments_bit_equal": bool(torch.equal(sk.mu, sp.mu)
                                         and torch.equal(sk.nu, sp.nu)),
               "off_run_rows_bit_equal": bool(torch.equal(tk[off],
                                                          base[off]))}
        out[case] = row
        if not (row["params_over"] <= 0 and row["moments_bit_equal"]
                and row["off_run_rows_bit_equal"]):
            bad[case] = row
    if bad:
        raise AssertionError(f"sparse_adamw live-run edges: {bad}")
    return out


# ---------------------------------------------------------------------------
# recsys: the three kernels of DeepFM and AutoInt
# ---------------------------------------------------------------------------

TABLE_ROWS = 80_000_000     # configs/deepfm.py, configs/autoint.py
N_FIELDS = 39
FM_D = 10                   # DeepFM's embed_dim
ATTN = (65536, 2, 2, 39, 39, 16)  # AutoInt: (B, Hq, Hkv, Sq, Skv, Dh)
BST_ATTN = (65536, 8, 8, 21, 21, 4)  # BST (configs/bst.py) at train_batch
BST_ROWS, BST_D, BST_L = 20_000_000, 32, 20  # its table and history


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


class SequenceLog:
    """A synthetic behavior log made on the card from a seed, its ids drawn
    the way CriteoLog draws them: item ids Zipf-skewed over the whole item
    vocabulary (rank r with density ~ 1/r), a ``history_len`` history and a
    target item per row, and labels from a planted logistic model (a random
    weight per item: the target's plus the history's mean, base rate
    ~25%). With ``padded``, half the rows keep a history of 0 to L - 1
    items and pad the rest with -1 (MIND's histories; a row with none is
    fully padded). Ids are int32, as the JAX package hands them over."""

    def __init__(self, device, vocab, history_len, padded=False, seed=0):
        import torch

        self.vocab, self.history_len, self.padded = vocab, history_len, padded
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device = device
        self.planted = torch.randn(vocab, generator=self.gen,
                                   device=device) * 0.7

    def item_ids(self, *shape):
        import torch

        u = torch.rand(*shape, generator=self.gen, device=self.device)
        rank = torch.floor(torch.pow(float(self.vocab), u)).long() - 1
        return rank.clamp_(0, self.vocab - 1).int()

    def history(self, n):
        import torch

        ids = self.item_ids(n, self.history_len)
        if self.padded:
            L = self.history_len
            keep = torch.randint(0, L, (n, 1), generator=self.gen,
                                 device=self.device)
            cut = torch.rand(n, 1, generator=self.gen,
                             device=self.device) < 0.5
            keep = torch.where(cut, keep, L)
            ids[torch.arange(L, device=self.device)[None, :] >= keep] = -1
        return ids

    def batch(self, n):
        import torch

        hist, target = self.history(n), self.item_ids(n)
        live = (hist >= 0).float()
        past = (self.planted[hist.clamp(min=0).long()] * live).sum(1) / (
            live.sum(1).clamp(min=1.0))
        logit = self.planted[target.long()] + past - 1.2
        labels = (torch.rand(n, generator=self.gen, device=self.device)
                  < torch.sigmoid(logit)).float()
        return {"history_ids": hist, "target_ids": target, "labels": labels}

    def candidates(self, n):
        """One user's history beside ``n`` candidate items drawn uniformly
        over the vocabulary."""
        import torch

        return {"history_ids": self.history(1),
                "candidate_ids": torch.randint(
                    0, self.vocab, (n,), generator=self.gen,
                    device=self.device, dtype=torch.int32)}


def bag_bound(table, ids, weights):
    """(bound_ms, bound_by) of one bag call on these inputs: ids (and
    weights) read once, each 32-byte table sector that a live id touches
    read once, the output written once; a multiply-add per gathered float.
    Ids are counted at 4 bytes while the table has fewer than 2^31 rows
    (the function needs no more; the TPU kernel reads int32), whatever
    width the caller hands over. A row of D floats touches the sectors from
    its first byte's to its last's (DeepFM's first-order D = 1: one; BST's
    D = 32: four); the table starts on a sector boundary (torch allocations
    do)."""
    import torch

    rows, dim = table.shape
    live = torch.clamp(ids[ids >= 0].long(), max=rows - 1)
    first, last = live * dim * 4 // 32, ((live + 1) * dim * 4 - 1) // 32
    sectors = 0
    if live.numel():
        span = int((last - first).max()) + 1
        sectors = int(torch.unique(torch.cat([
            torch.minimum(first + k, last) for k in range(span)])).numel())
    return cost.bound_ms(cost.embedding_bag(table, ids, weights,
                                            sectors=sectors))


def fm_bound(v):
    return cost.bound_ms(cost.fm_interaction(v))


def flash_bound(q, k, v):
    """Non-causal: q, k, v read once, o written once, in their own type;
    per (query, key) pair 2 Dh operations for the score, 2 Dh for the
    weighted sum, one exp, all float32."""
    return cost.bound_ms(cost.flash_attention(q, k, v, False))


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
    tensors: the layout AutoInt's and BST's projections hand the kernel."""
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
    cases = {name: (_attn_inputs(gen, device, *shape[:6]), shape[6])
             for name, shape in shapes.items()}
    # BST's attention at train_batch, in the layout its projections give.
    cases["bst_8x21_dh4"] = (
        _autoint_layout(_attn_inputs(gen, device, *BST_ATTN)), False)
    return cases


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
             edge_cases=len(errs),
             max_edge_abs_err=max(errs.values(), default=0.0),
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
    # BST's retrieval bag, a row of its own: one (1, 20) mean bag (weights
    # 1 / 20, as the op's mean combiner makes them) over the 20,000,000 x
    # 32 table, the smallest grid of the launch plan (wide variant).
    table = torch.randn(BST_ROWS, BST_D, generator=gen, device=device)
    ids = SequenceLog(device, BST_ROWS, BST_L, seed=1).history(1)
    args = [table, ids, torch.full((1, BST_L), 1.0 / BST_L, device=device)]
    got, want = embedding_bag_cuda(*args), embedding_bag_plain(*args)
    _hold("embedding_bag_bst_b1", {"main": _over(got, want, 1e-5)})
    if _over(bag_library(*args), want, 1e-4) > 0:
        raise AssertionError("embedding_bag B = 1: library yardstick "
                             "disagrees")
    record("embedding_bag_bst_b1", "cuda",
           "src/repro_torch/kernels/csrc/embedding_bag.cu",
           "src/repro/kernels/embedding_bag.py:33", [BST_ROWS, BST_D, 1, BST_L],
           embedding_bag_cuda, embedding_bag_plain, bag_library, args,
           {"main": _max_err(got, want)}, bag_bound(*args))
    results["embedding_bag_bst_b1"].update(
        kernel="embedding_bag", plan=bag_plan_for(*args)._asdict())
    del table, args

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
        # (B H / 32,768, 32,768): PyTorch's fp32 kernel puts batch and
        # heads on grid axes that hold at most 65,535 blocks. A view in the
        # (B, S, H, Dh) layout is copied by the refold.
        B, H, S, D = q.shape
        n = B * H
        fold = [t.reshape(-(-n // 32768), min(n, 32768), S, D)
                for t in (q, k, v)]
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
    # BST's attention at train_batch in its (B, S, H, Dh)-backed layout, a
    # row of its own.
    args = cases["bst_8x21_dh4"][0]
    library_err = _max_err(attn_library(*args), flash_attention_plain(*args))
    record("flash_attention_bst", "cuda",
           "src/repro_torch/kernels/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:30", list(BST_ATTN),
           flash_attention_cuda, flash_attention_plain, attn_library, args,
           {"main": errs["bst_8x21_dh4"]}, flash_bound(*args))
    results["flash_attention_bst"].update(
        kernel="flash_attention", layout="bshd_views",
        library_max_abs_err=library_err, plan=plan_for(*args)._asdict())
    del main, cases
    torch.cuda.empty_cache()
    return results


SEQUENCE_ARCHS = ("bst", "mind")


def per_forward(model, retrieval=False):
    """Kernel launches in one forward (or, with ``retrieval``, one
    retrieval_score call): DeepFM one embedding_bag and one fm_interaction,
    AutoInt one flash_attention per attention layer, BST one
    flash_attention per block (its retrieval one mean embedding_bag and no
    attention), MIND none."""
    cfg = model.cfg
    if cfg.name.startswith("bst"):
        return ({"embedding_bag": 1} if retrieval
                else {"flash_attention": cfg.n_blocks})
    if cfg.name.startswith("mind"):
        return {}
    if hasattr(cfg, "n_attn_layers"):
        return {"flash_attention": cfg.n_attn_layers}
    return {"embedding_bag": 1, "fm_interaction": 1}


def _config(arch):
    from repro_torch.configs.registry import get_arch

    return get_arch(arch)


def _log(arch, device, seed):
    """The synthetic log each recsys arch trains and serves on."""
    if arch not in SEQUENCE_ARCHS:
        return CriteoLog(device, seed=seed)
    cfg = _config(arch).FULL
    if arch == "bst":
        return SequenceLog(device, cfg.item_vocab, cfg.seq_len, seed=seed)
    return SequenceLog(device, cfg.item_vocab, cfg.history_len, padded=True,
                       seed=seed)


@contextlib.contextmanager
def _swapped(module, **names):
    """``module``'s attributes replaced by ``names`` for the block."""
    saved = {name: getattr(module, name) for name in names}
    for name, value in names.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def _plain_forward(arch, model, batch):
    """The model's forward (or, for a candidate batch of BST or MIND, its
    retrieval_score) with each kernel's plain version in its place, on the
    same card: the reference the kernels' forward is held to."""
    import torch

    from repro_torch.kernels import (embedding_bag_plain,
                                     flash_attention_plain,
                                     fm_interaction_plain)
    from repro_torch.models.recsys import bst, table_lookup

    cfg = model.cfg
    if arch == "bst":
        def plain_mean_bag(table_cfg, params, ids, combiner, mesh=None):
            live = (ids >= 0).float()
            return embedding_bag_plain(
                params["table"], ids,
                live / live.sum(1, keepdim=True).clamp_min(1.0))

        def plain_attention(q, k, v, causal=False):
            return flash_attention_plain(q, k, v, causal=causal)

        with _swapped(bst, bag_lookup=plain_mean_bag,
                      flash_attention=plain_attention):
            if "candidate_ids" in batch:
                return model.retrieval_score(batch)
            return model.forward(batch)
    if arch == "mind":  # no kernel
        if "candidate_ids" in batch:
            return model.retrieval_score(batch)
        return model.forward(batch)
    ids = batch["field_ids"]
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
    """Hold the scores of the first and last 512 rows of a call (for a
    sequence model's retrieval, of its candidates), where the kernels'
    offsets are smallest and largest, to the plain forward of those alone,
    rtol and atol 1e-5; rows are independent, so no full plain pass is
    needed. Returns the largest error."""
    import torch

    from repro_torch.stable import log_sigmoid

    n = scores.shape[-1]
    sel = torch.unique(torch.cat([
        torch.arange(min(512, n)), torch.arange(max(0, n - 512), n)
    ])).to(scores.device)
    if "candidate_ids" in batch:  # BST, MIND: one user, (1, C) scores
        sub = dict(batch, candidate_ids=batch["candidate_ids"][sel])
        got = scores[:, sel]
    else:
        sub = {k: v[sel] for k, v in batch.items() if k != "labels"}
        got = scores[sel]
    want = _plain_forward(arch, model, sub)
    if serve:
        want = log_sigmoid(want)
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

    expected = Counter()
    out, ref_err = {}, {}
    with torch.no_grad():
        reset_counts()
        for shape, iters in (("serve_p99", 50), ("serve_bulk", 10),
                             ("retrieval_cand", 3)):
            info = SHAPES[shape]
            retrieval = info["kind"] == "retrieval"
            if retrieval:
                rows = info["n_candidates"]
                batch, fn = log.candidates(rows), model.retrieval_score
                want_shape = ((1, rows) if arch in SEQUENCE_ARCHS
                              else (rows,))
            else:
                rows = info["batch"]
                batch, fn = log.batch(rows), model.serve
                want_shape = (rows,)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            scores = fn(batch)
            torch.cuda.synchronize()
            first_call_ms = (time.perf_counter() - t0) * 1e3
            if scores.shape != want_shape or not bool(
                    torch.isfinite(scores).all()):
                raise AssertionError(f"{arch} {shape}: bad scores")
            if info["kind"] == "serve" and bool(torch.any(scores > 0)):
                raise AssertionError(f"{arch} {shape}: log-prob above 0")
            ref_err[shape] = _check_rows(arch, shape, model, batch, scores,
                                         info["kind"] == "serve")
            del scores
            ms = time_ms(lambda: fn(batch), iters=iters, warmup=1)
            for k, n in per_forward(model, retrieval).items():
                expected[k] += n * (1 + 1 + iters)
            out[shape] = {"rows": rows, "ms_per_call": ms,
                          "rows_per_s": rows / ms * 1e3,
                          "first_call_ms": first_call_ms,
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated(),
                          "max_memory_reserved":
                              torch.cuda.max_memory_reserved()}
        launches = check_counts(f"serve_{arch}", expected)
    emit(f"serve_{arch}", card=card, params=model.n_params(),
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
    peak_reserved = torch.cuda.max_memory_reserved()
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
         max_memory_allocated=peak, max_memory_reserved=peak_reserved,
         launches=launches, train_losses=losses,
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
                with _swapped(deepfm, bag_lookup=unfolded
                              if form == "before" else folded):
                    times[form].append(time_ms(lambda: fn(batch),
                                               iters=iters, warmup=3))
            out[what] = {form: min(v) for form, v in times.items()}
    emit("clamp_fold", card=card, **out)
    return out


GATHER_FORMS = ("index", "embedding", "index_add")


def _gather_form(form):
    """``table_lookup``'s row gather in each form, as ``embedding._Rows``
    is called: ``index`` is ``table[rows]`` (the form before slice 12; its
    backward is ``index_put_`` with accumulate, which sorts the ids and
    sums an id's repeats one after another), ``embedding`` is
    ``F.embedding`` (sorted into partial sums), ``index_add`` the ``_Rows``
    the port keeps (one ``index_add_``: atomics, in no fixed order)."""
    import types

    import torch.nn.functional as F

    from repro_torch.models.recsys import embedding

    if form == "index_add":
        return embedding._Rows
    if form == "index":
        return types.SimpleNamespace(apply=lambda table, rows: table[rows])
    return types.SimpleNamespace(
        apply=lambda table, rows: F.embedding(rows, table))


def _gathers(model, batch):
    """(table, rows) of every ``table_lookup`` gather in the model's loss."""
    import types

    import torch

    from repro_torch.models.recsys import embedding

    seen = []

    def record(table, rows):
        seen.append((table.detach(), rows))
        return table[rows]

    with _swapped(embedding, _Rows=types.SimpleNamespace(apply=record)), \
            torch.no_grad():
        model.loss(batch)
    return seen


def _gather_form_times(model, batch, gen, rounds=("index", "embedding",
                                                  "index_add", "index_add",
                                                  "embedding", "index")):
    """In the turns ``rounds`` gives, the best of each form: ms of the loss's
    forward and backward (every parameter's gradient), and ms of the
    gathers alone (each gather's forward and its table's gradient from a
    fixed cotangent), both back to back from CUDA events; and whether each
    form's table gradients come out equal to the bit when taken twice."""
    import torch

    from repro_torch.models.recsys import embedding

    params = list(model.parameters())
    gathers = _gathers(model, batch)
    cotangents = [torch.randn(*rows.shape, table.shape[1], generator=gen,
                              device=rows.device)
                  for table, rows in gathers]

    def gather_grads(form):
        out = []
        for (table, rows), g in zip(gathers, cotangents):
            leaf = table.requires_grad_(True)
            (d,) = torch.autograd.grad(form.apply(leaf, rows), [leaf], g)
            leaf.requires_grad_(False)
            out.append(d)
        return out

    step = {f: [] for f in GATHER_FORMS}
    alone = {f: [] for f in GATHER_FORMS}
    bits = {}
    for name in rounds:
        form = _gather_form(name)
        with _swapped(embedding, _Rows=form):
            step[name].append(time_ms(
                lambda: torch.autograd.grad(model.loss(batch), params),
                iters=2, warmup=1))
        alone[name].append(time_ms(lambda: gather_grads(form), iters=2,
                                   warmup=1))
        if name not in bits:
            first, second = gather_grads(form), gather_grads(form)
            bits[name] = all(torch.equal(a, b)
                             for a, b in zip(first, second))
    return ({f: min(v) for f, v in step.items()},
            {f: min(v) for f, v in alone.items()}, bits, gathers)


def gather_forms(arch, model, log, card):
    """``table_lookup``'s gather forms (``_gather_form``) on one training
    batch of ``arch``, in turns: the loss's forward and backward ms, the
    gathers alone, bits over repeats, and the ids' skew (rows gathered, the
    most repeated row's count). For MIND also the same batch with its -1
    history slots redrawn from the log, so that the padded slots' repeats
    of row 0 (MIND reads a -1 as row 0, as JAX's ``maximum(ids, 0)`` does)
    can be told apart from the rest."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    batch = log.batch(B_MAIN)
    variants = {"batch": batch}
    if arch == "mind":
        hist = batch["history_ids"]
        variants["unpadded"] = dict(batch, history_ids=torch.where(
            hist < 0, log.item_ids(*hist.shape), hist))
    out = {}
    for what, b in variants.items():
        step, alone, bits, gathers = _gather_form_times(model, b, gen)
        rows = torch.cat([r.reshape(-1) for _, r in gathers])
        entry = {"step_fwd_bwd_ms": step, "gathers_ms": alone,
                 "bits_equal_over_repeats": bits,
                 "rows_gathered": rows.numel(),
                 "hottest_row_repeats": int(
                     torch.unique(rows, return_counts=True)[1].max())}
        if arch == "mind":
            entry["padded_share"] = float(
                (b["history_ids"] < 0).float().mean())
        out[what] = entry
    emit("gather_forms", arch=arch, card=card, **out)
    return out


def phase_recsys(arch, card):
    """Serve, then train, the published-width model; freed afterwards.
    Returns the serve and the train phase's launches."""
    import torch

    log = _log(arch, torch.device("cuda"), seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _config(arch).make_model(device="cuda", seed=0)
    torch.cuda.synchronize()
    emit(f"build_{arch}", params=model.n_params(),
         seconds=time.perf_counter() - t0,
         memory_allocated=torch.cuda.memory_allocated())
    serve = phase_serve(arch, model, log, card)
    if arch == "deepfm":
        clamp_fold_timing(model, log, card)
    train = phase_train_recsys(arch, model, log, card)
    gather_forms(arch, model, log, card)
    del model, log
    gc.collect()
    torch.cuda.empty_cache()
    return serve, train


def _cpu_batch(arch, cfg, rng, rows=512):
    """A numpy batch for the reduced ``cfg``: field ids, or a history (MIND's
    with a fully and a partly padded row and 10% padding) and targets."""
    if arch not in SEQUENCE_ARCHS:
        return {"field_ids": rng.integers(0, cfg.table_rows,
                                          (rows, cfg.n_sparse)),
                "labels": (rng.random(rows) < 0.3).astype(np.float32)}
    L = cfg.seq_len if arch == "bst" else cfg.history_len
    hist = rng.integers(0, cfg.item_vocab, (rows, L)).astype(np.int32)
    if arch == "mind":
        hist[rng.random((rows, L)) < 0.1] = -1
        hist[0], hist[1, 3:] = -1, -1
    return {"history_ids": hist,
            "target_ids": rng.integers(0, cfg.item_vocab, rows
                                       ).astype(np.int32),
            "labels": (rng.random(rows) < 0.3).astype(np.float32)}


def phase_recsys_cpu_vs_gpu():
    """The reduced DeepFM, AutoInt, BST and MIND with the same weights
    through ``convert``: CPU (plain versions) and GPU (kernels) agree on the
    loss, every gradient and the served scores to 1e-5."""
    import numpy as np
    import torch

    from repro_torch.convert import export_params, load_jax_params

    out = {}
    for arch in ("deepfm", "autoint", "bst", "mind"):
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
        batch = _cpu_batch(arch, cfg, rng)
        losses, grads, served = [], [], []
        reset_counts()
        for model, dev in ((cpu, torch.device("cpu")),
                           (gpu, torch.device("cuda"))):
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            loss = model.loss(b)
            grads.append(torch.autograd.grad(loss, list(model.parameters())))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                served.append(model.serve(b).cpu())
        check_counts(f"cpu_vs_gpu {arch}", {
            k: 2 * n for k, n in per_forward(gpu).items()})
        check_close(f"cpu_vs_gpu {arch} loss", losses[1], losses[0],
                    rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(served[1], served[0], rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{arch} serve: {m}")
        worst = 0.0
        for (name, _), g_cpu, g_gpu in zip(cpu.named_parameters(), *grads):
            torch.testing.assert_close(g_gpu.cpu(), g_cpu, rtol=1e-5,
                                       atol=1e-5,
                                       msg=lambda m: f"{arch} {name}: {m}")
            worst = max(worst, _max_err(g_gpu.cpu(), g_cpu))
        out[arch] = {"loss_cpu": losses[0], "loss_gpu": losses[1],
                     "max_grad_abs_err": worst,
                     "max_serve_abs_err": _max_err(served[1], served[0])}
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
    and test metrics. Both runs start at once, on threads of their own;
    the drill returns ``finish``, which waits for them, checks them and
    returns the record (so the caller's own work runs beside them)."""
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

    pool = ThreadPoolExecutor(2)
    killed = pool.submit(records, base + [
        "--ckpt-dir", ckpt, "--fault-kill-at-step", "100",
        "--max-restarts", "1"])
    clean = pool.submit(records, base)
    pool.shutdown(wait=False)

    def finish():
        try:
            _, want_epochs, want_tests, clean_s = clean.result()
            out, epochs, tests, drill_s = killed.result()
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        relaunched = ("relaunching" in out
                      and "completed after 1 restart" in out
                      and "resumed at epoch=1" in out)
        same = epochs[-len(want_epochs) + 1:] == want_epochs[1:] \
            and tests == want_tests and len(tests) == 1
        if not (relaunched and same):
            raise AssertionError(f"drill: relaunched {relaunched}, records "
                                 f"{epochs} / {tests} against {want_epochs}"
                                 f" / {want_tests}")
        return {"exit": 0, "relaunched": relaunched, "test": tests[0],
                "equal_to_uninterrupted": same, "drill_seconds": drill_s,
                "uninterrupted_seconds": clean_s}

    return finish


def phase_resume_dbn(data, card, steps=16):
    """The paper-width DBN, one epoch of 16 steps, with checkpoints every 8
    steps (keep 1) in a temporary directory: a SIGTERM KillSwitch at batch
    9 under handle_preemption ends the run with a checkpoint; a fresh
    Trainer resumes from it and must end on an uninterrupted run's
    parameters, moments and history to the bit. Both runs counted, their
    launches held to the steps each ran. Save and restore seconds and
    bytes. The launcher's SIGKILL drill runs beside it, in processes of
    its own."""
    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    finish_drill = _sigkill_drill()
    try:
        body = _resume_body(data, card, steps)
    finally:
        drill = finish_drill()
    emit("resume_dbn", **body, sigkill_drill=drill,
         seconds=time.perf_counter() - t_phase)


def _resume_body(data, card, steps):
    """phase_resume_dbn's in-process part: the record it emits, but the
    drill's."""
    import shutil
    import signal
    import tempfile

    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model
    from repro_torch.testing import KillSwitch
    from repro_torch.train import Trainer
    from repro_torch.train.capture import tree_leaves

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
    saves = timed_k.saves + timed_r.saves
    return dict(
        card=card, steps=steps, preempted_at_step=stopped_at,
        launches={"preempted": killed_counts["launches"],
                  "resumed": resumed_counts["launches"]},
        wrapper_launches={"preempted": killed_counts["wrapper_launches"],
                          "resumed": resumed_counts["wrapper_launches"]},
        versus_uninterrupted=versus, history_equal=history_equal,
        bits_equal=True, saves=saves,
        restores=timed_k.restores + timed_r.restores,
        save_gb=[x["bytes"] / 1e9 for x in saves],
        save_gb_per_s=[x["bytes"] / 1e9 / x["seconds"] for x in saves],
        disk_free_gb=free_gb, history=strip(h_full))


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
            # two rounds (three before the dry run joined the smoke's time)
            warm_ms, input_path, warm_over = warm_and_input_rounds(
                warm(loader_fn), loader_fn(), n, rounds=2)
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
        # two rounds (three before the dry run joined the smoke's time)
        for r in range(2):
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


def _bulk_routes(model, batches, rounds=11):
    """serve_bulk's pinned staging against the pageable route it replaced
    (``torch.from_numpy(v).to(device)``, ``.cpu()``), in turns over
    ``batches`` (each route first in every other round): each route's host
    ms a call, and the answers held equal to the bit, batch by batch."""
    import torch

    from repro_torch.configs.clax_baidu import serve_bulk

    device = next(model.parameters()).device

    @torch.no_grad()
    def pageable(batch):
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in batch.items()}
        return model.predict_clicks(inputs).cpu().numpy()

    routes = {"pinned": lambda b: serve_bulk(model, b), "pageable": pageable}
    host = {r: [] for r in routes}
    first = {r: [] for r in routes}
    for i in range(rounds):
        for r in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
            for b in batches:
                t0 = time.perf_counter()
                out = routes[r](b)
                if i == 0:  # each batch's first call warms the route
                    first[r].append(out)
                else:
                    host[r].append((time.perf_counter() - t0) * 1e3)
    for j, (got, want) in enumerate(zip(first["pinned"], first["pageable"])):
        if (got.shape != want.shape or got.dtype != want.dtype
                or got.tobytes() != want.tobytes()):
            raise AssertionError(f"serve_bulk: batch {j}'s pinned answer "
                                 "differs from the pageable route's")
    return {r: _spread(ms) for r, ms in host.items()}


def _bulk_rates(model, batch, reps=10):
    """GB/s of the pinned route's parts over one batch: the host's fill of
    pinned buffers from the caller's arrays (torch's threaded ``copy_``,
    host clock), the DMA from them and of the answer back into pinned
    memory (CUDA events), and the pageable copies beside them."""
    import torch

    device = next(model.parameters()).device
    src = {k: torch.from_numpy(v) for k, v in batch.items()}
    staged = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for k, t in src.items()}
    dst = {k: torch.empty(t.shape, dtype=t.dtype, device=device)
           for k, t in src.items()}
    n_in = sum(t.nbytes for t in src.values())
    with torch.no_grad():
        out = model.predict_clicks(dst)
    answer = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)

    def fill():
        for k, t in src.items():
            staged[k].copy_(t)

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def dma_in():
        for k, t in staged.items():
            dst[k].copy_(t, non_blocking=True)

    ms = {"fill": host_ms(fill),
          "dma_in": time_ms(dma_in, iters=reps, warmup=2),
          "dma_out": time_ms(lambda: answer.copy_(out, non_blocking=True),
                             iters=reps, warmup=2),
          "pageable_in": host_ms(lambda: [dst[k].copy_(t) for k, t
                                          in src.items()]),
          "pageable_out": host_ms(lambda: out.cpu())}
    size = {"fill": n_in, "dma_in": n_in, "pageable_in": n_in,
            "dma_out": out.nbytes, "pageable_out": out.nbytes}
    return {"ms": ms, "gb_per_s": {k: size[k] / ms[k] / 1e6 for k in ms},
            "threads": torch.get_num_threads()}


def _bulk_pieces(model, batches, rounds=4):
    """The piece size of serve_bulk's copy in swept (1-16 MiB and whole
    arrays) over ``batches``, sizes in turns: host ms a call, the
    ``serve_bulk.copy_in`` span (the fill and the enqueues), and the copy
    in to the end of its DMA (the staging's copy in, then a
    synchronize)."""
    import torch

    from repro_torch import obs
    from repro_torch.configs import clax_baidu
    from repro_torch.data import staging as pinned

    device = next(model.parameters()).device
    staging = pinned.staging_for(model, device)
    whole = max(v.nbytes for b in batches for v in b.values())
    sizes = [1 << 20, 2 << 20, 4 << 20, 8 << 20, 16 << 20, whole]
    kept = pinned.PIECE_BYTES
    before = obs.get_recorder()
    got = {p: {"call": [], "copy_in_span": [], "copy_in_done": []}
           for p in sizes}
    try:
        for i in range(rounds):
            for piece in (sizes if i % 2 == 0 else sizes[::-1]):
                pinned.PIECE_BYTES = piece
                rec = obs.set_recorder(obs.Recorder())
                for b in batches:
                    t0 = time.perf_counter()
                    clax_baidu.serve_bulk(model, b)
                    got[piece]["call"].append(
                        (time.perf_counter() - t0) * 1e3)
                got[piece]["copy_in_span"] += [
                    s.duration * 1e3 for s in rec.tracer.spans
                    if s.name == "serve_bulk.copy_in"]
                for b in batches:
                    host = {k: np.ascontiguousarray(v) for k, v in b.items()}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    staging.copy_in(host, device)
                    torch.cuda.synchronize()
                    got[piece]["copy_in_done"].append(
                        (time.perf_counter() - t0) * 1e3)
    finally:
        pinned.PIECE_BYTES = kept
        obs.set_recorder(before)
    return {("whole" if p == whole else f"{p >> 20}MiB"):
            {k: _spread(v) for k, v in row.items()}
            for p, row in got.items()}


def _bulk(model, name, rng):
    """configs/clax_baidu.serve_bulk at 262,144 x 10 over 4 distinct
    batches (94 MB, past the host's last-level cache, as the benchmark's 8
    are): host to host through its pinned staging and through the
    pageable route in turns, the answers equal to the bit; the fill's and
    the DMA's GB/s; the piece size swept; the staging's counters;
    predict_clicks alone on the device; its bound: the 32-byte sectors the
    gathers touch plus the batch's bytes in and the answer's out."""
    import torch

    from repro_torch import obs
    from repro_torch.configs.clax_baidu import SHAPES
    from repro_torch.data.staging import PIECE_BYTES
    from repro_torch.core.parameterization import EmbeddingParameter

    rows = SHAPES["serve_bulk"]["batch"]
    batches = [{"positions": np.tile(np.arange(1, K_MAIN + 1,
                                               dtype=np.int32), (rows, 1)),
                "query_doc_ids": rng.integers(0, SERVE_PAIRS, (rows, K_MAIN))
                .astype(np.int32),
                "mask": rng.random((rows, K_MAIN)) < 0.9}
               for _ in range(4)]
    before = obs.get_recorder()
    rec = obs.set_recorder(obs.Recorder())
    try:
        routes = _bulk_routes(model, batches)
        counters = {k: v for k, v in rec.detail_snapshot().items()
                    if k.startswith("serve_bulk.")}
    finally:
        obs.set_recorder(before)
    if (counters["serve_bulk.pinned_calls"] != counters["serve_bulk.calls"]
            or counters["serve_bulk.pinned_allocs"] != 1):
        raise AssertionError(f"serve_bulk {name}: counters {counters}")
    rates = _bulk_rates(model, batches[0])
    pieces = _bulk_pieces(model, batches)
    tensors = {k: torch.from_numpy(v).cuda() for k, v in batches[0].items()}
    with torch.no_grad():
        out = model.predict_clicks(tensors)
        if out.shape != (rows, K_MAIN) or not torch.isfinite(out).all():
            raise AssertionError(f"serve_bulk {name}: {out.shape}")
        device = time_ms(lambda: model.predict_clicks(tensors), iters=20,
                         warmup=3)
        sectors = sum(int(torch.unique(m.row_ids(tensors) // 8).numel())
                      for m in model.modules()
                      if isinstance(m, EmbeddingParameter))
        lines, total = profile_kernels(lambda: model.predict_clicks(tensors),
                                       calls=5)
    n_bytes = sectors * SECTOR + rows * K_MAIN * (4 + 4 + 1) \
        + rows * K_MAIN * 4
    host = routes["pinned"]["median"]
    return {"rows": rows, "host_ms": routes["pinned"], "routes": routes,
            "piece_bytes": PIECE_BYTES, "pieces": pieces, "rates": rates,
            "counters": counters,
            "profile": {"device_kernels": total, "top": lines[:8]},
            "device_ms": device, "rows_per_s_device": rows / device * 1e3,
            "rows_per_s_host": rows / host * 1e3,
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


# ---------------------------------------------------------------------------
# Slice 12: the kernel conformance sweep on the card
# ---------------------------------------------------------------------------

def phase_conformance(card):
    """``testing.conformance.run_conformance`` on the card: every spec x
    shape x dtype of JAX's six specs (flash_attention's also as (B, S, H,
    Dh)-backed views), values and gradients of the kernel route (the public op: the
    kernel's forward, the op's backward on what it produced) against the
    plain route's autograd on the same card at TOLS, each extreme corpus
    and examination_nll's saturated sessions. One line per kernel; raises
    after every cell was measured if any missed. Returns the summary by
    kernel."""
    from repro_torch.testing import conformance

    t0 = time.perf_counter()
    report, misses = conformance.run_conformance(device="cuda")
    for name, row in report.items():
        emit("conformance", name=name, card=card, **row)
    emit("conformance_done", seconds=time.perf_counter() - t0,
         cells=sum(r["cells"] for r in report.values()),
         held=sum(r["held"] for r in report.values()), misses=misses)
    if misses:
        raise AssertionError(f"conformance: {len(misses)} misses: "
                             + "; ".join(misses))
    return report


# ---------------------------------------------------------------------------
# Slice 13: GraphSAGE and the LM family at their published widths, and the
# adamw kernel over bfloat16 parameters
# ---------------------------------------------------------------------------

#: adamw's bytes an element by (parameter, gradient, moments) type for the
#: two timed forms: p, g, m and v read once, p, m and v written once.
ADAMW_BF16_BYTES = {("bfloat16", "bfloat16", "bfloat16"): 14,
                    ("bfloat16", "float32", "float32"): 24}
LM_SEED = 13


def _free_card():
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gb():
    import torch

    return {"max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "max_memory_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


def _lm_param_shapes(cfg):
    """The shapes of an LM's parameter tensors, in the train step's order
    (``params.parameters()``), from a ``meta`` init."""
    from repro_torch.models.lm import init_params

    return [tuple(p.shape) for p in init_params(cfg, device="meta"
                                                ).parameters()]


def _bf16_steps(got, want):
    """The most bfloat16 steps between two bfloat16 tensors, element by
    element: their bit patterns read as sign-magnitude integers, so +0 and
    -0 are 0 apart and neighbours across 0 are counted through it."""
    import torch

    def key(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((key(got) - key(want)).abs().max()) if got.numel() else 0


def _bf16_apart_max(n):
    """The most parameters of ``n`` a bfloat16 step may leave apart from
    the plain chain: 1 + n / 10^7 (150 of llama3.2-1b's 1,498,482,688; the
    sound kernel left 3). A form that rounds only p + u, not the update
    first, leaves some 1% apart (``_single_rounding_run``)."""
    return 1 + n // 10 ** 7


def _single_rounding_run(make_opt, params0, grads, steps):
    """The plain chain with apply_updates's first rounding left out: p + u
    in float32, rounded once to p's type. The control that the bfloat16
    hold must refuse."""
    params = [p.clone() for p in params0]
    opt = make_opt()
    state = opt.init(params)
    for _ in range(steps):
        updates, state = opt.update(grads, state, params)
        for p, u in zip(params, updates):
            p.copy_((p.float() + u.float()).to(p.dtype))
        del updates
    return params


def _bf16_compare(make_opt, params0, grads, steps=2, control=False):
    """Kernel against plain chain from the same bfloat16 parameters, tensor
    by tensor (the plain chain's float32 temporaries of one tensor at a
    time): moments equal to the bit; the parameters' elements apart, the
    max abs error and the most bfloat16 steps apart. A bfloat16 parameter
    rounds the update and the sum, so where the chain's float32 division
    is an ulp off the kernel's correctly rounded one, a rounding can flip
    by one step. With ``control`` the single-rounding form
    (``_single_rounding_run``) is held against the plain chain the same
    way."""
    import torch

    out = {"elements": 0, "params_apart": 0, "params_abs_err": 0.0,
           "bf16_steps": 0, "moments_bit_equal": True}
    if control:
        out["control"] = {"params_apart": 0, "bf16_steps": 0}
    for p0, g in zip(params0, grads):
        runs = [_adam_run(make_opt, [p0], [g], steps, fused)
                for fused in (True, False)]
        (pk, sk), (pp, sp) = runs
        out["elements"] += p0.numel()
        out["params_apart"] += int((pk[0] != pp[0]).sum())
        out["params_abs_err"] = max(out["params_abs_err"],
                                    _max_err(pk[0], pp[0]))
        out["bf16_steps"] = max(out["bf16_steps"], _bf16_steps(pk[0], pp[0]))
        out["moments_bit_equal"] &= bool(
            torch.equal(sk[0].mu[0], sp[0].mu[0])
            and torch.equal(sk[0].nu[0], sp[0].nu[0]))
        out["count"] = int(sk[0].count)
        del runs, pk, sk
        if control:
            (pc,) = _single_rounding_run(make_opt, [p0], [g], steps)
            c = out["control"]
            c["params_apart"] += int((pc != pp[0]).sum())
            c["bf16_steps"] = max(c["bf16_steps"], _bf16_steps(pc, pp[0]))
            del pc
        del pp, sp
        torch.cuda.empty_cache()
    out["params_bit_equal"] = out["params_apart"] == 0
    out["apart_max"] = _bf16_apart_max(out["elements"])
    if control:
        c = out["control"]
        c["held"] = c["bf16_steps"] <= 1 and \
            c["params_apart"] <= out["apart_max"]
    return out


def _hold_bf16(cases):
    """Raise, after every case was measured, unless each case's moments are
    equal to the bit and its parameters are within one bfloat16 step and at
    most ``apart_max`` of them apart; and unless every control the case
    ran is refused by that hold."""
    bad = {name: c for name, c in cases.items()
           if not (c["moments_bit_equal"] and c["bf16_steps"] <= 1
                   and c["params_apart"] <= c["apart_max"])}
    if bad:
        raise AssertionError(f"adamw bf16 kernel vs plain chain: {bad}")
    passed = {name: c["control"] for name, c in cases.items()
              if c.get("control", {}).get("held", False)}
    if passed:
        raise AssertionError("adamw bf16: the hold passes the single-"
                             f"rounding control, so it cannot see it: "
                             f"{passed}")


def phase_adamw_bf16(card):
    """adamw over bfloat16 parameters, the LM family's, at llama3.2-1b's
    parameter tensors (its train step's launches): bfloat16 p with bfloat16
    and float32 g, float32 and bfloat16 moments, each against the plain
    chain on the card (two steps from the same inputs: the moments equal to
    the bit, the parameters within one bfloat16 step and at most
    ``_bf16_apart_max`` of them apart; the single-rounding control, run on
    the float32 g and moments, must fail that hold); the predicate and norm
    modes and edge cases (a tail, a 0-d scalar, an unaligned view,
    decay-dominant steps) on bfloat16 parameters; the 14 B and 24 B forms
    timed against their bounds, the 14 B one beside
    torch.optim.AdamW(fused=True) over the same bfloat16 tensors (its state
    in bfloat16: decay first, another order; timed, not held). The row's
    main form is the 24 B one, which no PyTorch call computes."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import llama3_2_1b

    device = torch.device("cuda")
    _free_card()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    shapes = _lm_param_shapes(llama3_2_1b.FULL)
    n = sum(math.prod(s) for s in shapes)

    def make(mdt, lr=3e-4, wd=1e-4):
        return lambda: optim.adamw(lr, weight_decay=wd, moment_dtype=mdt)

    def tensors(shape_list, dtype, scale):
        return [(torch.randn(s, generator=gen, device=device) * scale
                 ).to(dtype) for s in shape_list]

    params = tensors(shapes, torch.bfloat16, 0.02)
    cases, times = {}, {}
    for gdt in (torch.bfloat16, torch.float32):
        grads = tensors(shapes, gdt, 1e-3)
        for mdt in (torch.bfloat16, torch.float32):
            key = ("bfloat16", str(gdt).split(".")[1], str(mdt).split(".")[1])
            name = "p_{}_g_{}_m_{}".format(*key)
            cases[name] = _bf16_compare(
                make(mdt), params, grads,
                control=key == ("bfloat16", "float32", "float32"))
            if key not in ADAMW_BF16_BYTES:
                continue
            opt = make(mdt)()
            work = [p.clone() for p in params]
            state = opt.init(work)
            t = {"kernel": time_ms(lambda: optim.step(opt, grads, state,
                                                      work),
                                   iters=10, warmup=2),
                 "device": graph_ms(lambda: optim.step(opt, grads, state,
                                                       work),
                                    calls=3, replays=4)}

            def plain_step():
                updates, _ = opt.update(grads, state, work)
                optim.apply_updates(work, updates)

            t["plain"] = time_ms(plain_step, iters=3, warmup=1)
            del work, state
            _free_card()
            t_bound, t_by = adamw_bound(n, moments=key[2], params=key[0],
                                        grads=key[1])
            t.update(bound=t_bound, bound_by=t_by,
                     bytes_per_element=ADAMW_BF16_BYTES[key], library=None)
            if key == ("bfloat16",) * 3:
                lib_params = [torch.nn.Parameter(p.clone()) for p in params]
                for p, g in zip(lib_params, grads):
                    p.grad = g
                lib = torch.optim.AdamW(lib_params, lr=3e-4,
                                        weight_decay=1e-4, fused=True)
                t["library"] = time_ms(lib.step, iters=10, warmup=2)
                del lib, lib_params
                _free_card()
            times[name] = t
        del grads
        _free_card()
    del params
    _free_card()
    # predicate, norm modes and edges on bfloat16 parameters
    small = [torch.randn(1_000_003, generator=gen, device=device
                         ).to(torch.bfloat16)]
    small_g = [torch.randn(1_000_003, generator=gen, device=device)]
    predicate = _adam_pred_forms(make(torch.float32), small, small_g)
    if not all(predicate.values()):
        raise AssertionError(f"adamw bf16 predicate forms: {predicate}")
    norm_forms = _adam_norm_forms(make(torch.float32), small,
                                  [g.to(torch.bfloat16) for g in small_g])
    edges = {}
    for case, shape in {"n7": (7,), "scalar": (), "10x10": (10, 10)}.items():
        p = [torch.randn(shape, generator=gen, device=device
                         ).to(torch.bfloat16)]
        g = [torch.randn(shape, generator=gen, device=device)]
        edges[case] = _bf16_compare(make(torch.float32), p, g)
    base = torch.randn(4100, generator=gen, device=device).to(torch.bfloat16)
    g = torch.randn(4099, generator=gen, device=device).to(torch.bfloat16)
    edges["n4099_bf16_g_and_moments"] = _bf16_compare(
        make(torch.bfloat16), [base[1:]], [g])
    edges["decay_dominant"] = _bf16_compare(
        make(torch.float32, lr=0.05, wd=0.1), [base[1:].contiguous()],
        [g.float()], steps=5)
    main_key = "p_bfloat16_g_float32_m_float32"
    emit("kernel", name="adamw_bf16", card=card, elements=n,
         shapes="llama3.2-1b's parameter tensors", cases=cases, times=times,
         predicate=predicate, norm_forms=norm_forms, edge_cases=edges)
    _hold_bf16({**cases, **edges})
    t, bf16 = times[main_key], times["p_bfloat16_g_bfloat16_m_bfloat16"]
    return {"adamw_bf16": {
        "name": "adamw_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "src/repro/optim/optimizers.py:93 (no pallas_call: the "
                    "loop XLA fuses from scale_by_adam, add_decayed_weights, "
                    "scale and apply_updates, :29, over bfloat16 "
                    "parameters)",
        "max_abs_err": cases[main_key]["params_abs_err"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": t["bound"],
        "bound_by": t["bound_by"], "library_ms": t["library"],
        "device_ms": {k: v["device"] for k, v in times.items()},
        "bf16_g_and_moments": bf16, "held": True}}


def _sage_step_loop(step, params, opt_state, data, steps):
    """``steps`` train steps on ``data``: losses and ms per step (host clock
    closed by a synchronize)."""
    import torch

    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, data)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def _falls(what, losses):
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: loss did not fall: {losses}")


def _to_device(batch, device):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _molecule_graph(info, rng):
    n, n_graphs, e = info["n_nodes"], info["batch"], info["n_edges"]
    offsets = np.repeat(np.arange(n_graphs) * n, e)
    src = rng.integers(0, n, n_graphs * e) + offsets
    dst = rng.integers(0, n, n_graphs * e) + offsets
    deg = np.bincount(dst, minlength=n_graphs * n).astype(np.float32)
    return {"features": rng.normal(size=(n_graphs * n, info["d_feat"])
                                   ).astype(np.float32),
            "src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "degree_inv": (1.0 / np.maximum(deg, 1.0)).astype(np.float32),
            "labels": rng.integers(0, info["n_classes"], n_graphs * n
                                   ).astype(np.int32),
            "graph_ids": np.repeat(np.arange(n_graphs), n).astype(np.int32)}


def phase_gnn(card):
    """GraphSAGE (FULL: 2 layers, hidden 128) on JAX's four shapes, each
    graph the copied ``random_graph`` at its size from a seed, trained with
    adam(1e-2) (one fused adamw launch per tensor, six a step):
    ``minibatch_lg`` (Reddit's sampled training, 8 steps of the same 1,024
    target nodes through the copied sampler, host sample + gather, copy and
    device step timed apart), ``ogb_products`` (full batch, 2 steps, its
    edges summed in chunks: peak memory and ms a step), ``full_graph_sm``
    and ``molecule`` (8 steps each). Then the reduced config on the CPU
    port and the card, float32, at 1e-5. Returns the sampled run's
    counts."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import graphsage_reddit as conf
    from repro_torch.models import gnn
    from repro_torch.models.gnn import graphsage

    device = torch.device("cuda")
    t_phase = time.perf_counter()
    out = {}

    def graph_of(shape):
        info = conf.SHAPES[shape]
        t0 = time.perf_counter()
        g = gnn.random_graph(info["n_nodes"], info["n_edges"],
                             info["d_feat"], info["n_classes"], seed=LM_SEED)
        return g, time.perf_counter() - t0

    # The two large graphs are built at once (numpy releases the
    # interpreter lock in its bulk fills, searches and sorts), before any
    # step is timed.
    with ThreadPoolExecutor(1) as pool:
        ogb_graph = pool.submit(graph_of, "ogb_products")
        # --- minibatch_lg: Reddit, sampled ------------------------------
        info = conf.SHAPES["minibatch_lg"]
        cfg = conf.shape_config("minibatch_lg")
        _free_card()
        g, t_graph = graph_of("minibatch_lg")
        t0 = time.perf_counter()
        sampler = gnn.NeighborSampler(g["src"], g["dst"], info["n_nodes"],
                                      seed=LM_SEED)
        t_csr = time.perf_counter() - t0
        g_ogb, t_ogb = ogb_graph.result()
    t_graphs = time.perf_counter() - t_phase
    nodes = np.random.default_rng(LM_SEED).choice(
        info["n_nodes"], info["batch_nodes"], replace=False)
    params = gnn.init_params(cfg, device=device, seed=LM_SEED)
    opt = optim.adam(1e-2)
    state = opt.init(list(params.parameters()))
    step = gnn.make_sampled_train_step(cfg, opt)
    reset_counts()
    host_ms, copy_ms, device_ms, losses = [], [], [], []
    for _ in range(8):
        t0 = time.perf_counter()
        batch_np = sampler.sample_batch(nodes, cfg.sample_sizes,
                                        g["features"], g["labels"])
        t1 = time.perf_counter()
        batch = _to_device(batch_np, device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host_ms.append((t1 - t0) * 1e3)
        copy_ms.append((t2 - t1) * 1e3)
        device_ms.append((t3 - t2) * 1e3)
        losses.append(float(loss))
    counts = check_counts("gnn minibatch_lg", {"adamw": 6 * 8})
    _falls("gnn minibatch_lg", losses)
    gathered = info["batch_nodes"] * (1 + 15 + 150)
    out["minibatch_lg"] = {
        "nodes": info["n_nodes"], "edges": info["n_edges"],
        "d_feat": info["d_feat"], "batch_nodes": info["batch_nodes"],
        "fanout": list(cfg.sample_sizes), "steps": 8,
        "graph_seconds": t_graph, "csr_seconds": t_csr,
        "both_graphs_wall_seconds": t_graphs,
        "host_sample_gather_ms": host_ms, "copy_ms": copy_ms,
        "device_step_ms": device_ms, "losses": losses,
        "gathered_rows": gathered,
        "gathered_mb": gathered * info["d_feat"] * 4 / 1e6,
        "launches": counts, **_peak_gb(),
        "cut": "8 steps of one target batch (the same 1,024 nodes, "
               "neighbours drawn anew each step)"}
    emit("gnn", shape="minibatch_lg", card=card, **out["minibatch_lg"])
    del g, sampler, batch, batch_np, params, state
    # --- ogb_products: full batch ----------------------------------------
    info = conf.SHAPES["ogb_products"]
    cfg = conf.shape_config("ogb_products")
    _free_card()
    graph = _to_device(g_ogb, device)
    _KEPT["ogb_products_graph"] = g_ogb  # for the distrib phase
    del g_ogb
    params = gnn.init_params(cfg, device=device, seed=LM_SEED)
    state = opt.init(list(params.parameters()))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, ms = _sage_step_loop(gnn.make_full_graph_train_step(cfg, opt),
                                 params, state, graph, 2)
    counts = check_counts("gnn ogb_products", {"adamw": 6 * 2})
    _falls("gnn ogb_products", losses)
    _KEPT["ogb_products_losses"] = losses
    dims = [info["d_feat"], cfg.d_hidden]
    out["ogb_products"] = {
        "nodes": info["n_nodes"], "edges": info["n_edges"],
        "d_feat": info["d_feat"], "steps": 2, "graph_seconds": t_ogb,
        "step_ms": ms, "losses": losses, "launches": counts, **_peak_gb(),
        "materialized_messages_gb": [info["n_edges"] * d * 4 / 1e9
                                     for d in dims],
        "edge_chunks": [-(-info["n_edges"] // max(
            1, graphsage.EDGE_CHUNK_BYTES // (d * 4))) for d in dims],
        "cut": "none (2 steps)"}
    emit("gnn", shape="ogb_products", card=card, **out["ogb_products"])
    del graph, params, state
    # --- full_graph_sm (Cora's shape) and molecule ----------------------
    for shape in ("full_graph_sm", "molecule"):
        info = conf.SHAPES[shape]
        cfg = conf.shape_config(shape)
        _free_card()
        rng = np.random.default_rng(LM_SEED)
        if shape == "molecule":
            g = _molecule_graph(info, rng)
            step = conf._make_molecule_step(cfg, opt, info["batch"])
        else:
            g = gnn.random_graph(info["n_nodes"], info["n_edges"],
                                 info["d_feat"], info["n_classes"],
                                 seed=LM_SEED)
            step = gnn.make_full_graph_train_step(cfg, opt)
        graph = _to_device(g, device)
        params = gnn.init_params(cfg, device=device, seed=LM_SEED)
        state = opt.init(list(params.parameters()))
        reset_counts()
        losses, ms = _sage_step_loop(step, params, state, graph, 8)
        counts = check_counts(f"gnn {shape}", {"adamw": 6 * 8})
        _falls(f"gnn {shape}", losses)
        out[shape] = {"nodes": int(graph["features"].shape[0]),
                      "edges": int(graph["src"].shape[0]),
                      "steps": 8, "step_ms": ms, "losses": losses,
                      "launches": counts, **_peak_gb(), "cut": "none"}
        emit("gnn", shape=shape, card=card, **out[shape])
    # --- the reduced config: the CPU port against the card ---------------
    out["cpu_vs_gpu"] = _gnn_cpu_vs_gpu()
    emit("gnn_cpu_vs_gpu", card=card, **out["cpu_vs_gpu"])
    emit("gnn_done", card=card, seconds=time.perf_counter() - t_phase)
    _free_card()
    return out["minibatch_lg"]["launches"]


def _hold_close(what, got, want, tol=1e-5):
    """Every element within tol + tol |want|; returns the max abs error."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")
    return _max_err(got, want)


def _gnn_cpu_vs_gpu():
    """GraphSAGE's reduced config with one set of weights on the CPU port
    (the plain path) and on the card: the full-graph forward with edge
    weights, the sampled forward with masks, the loss, every gradient and
    one adam step of each, float32, at 1e-5."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import graphsage_reddit as conf
    from repro_torch.convert import export_params, load_jax_params
    from repro_torch.models import gnn

    cfg = conf.reduced()
    rng = np.random.default_rng(5)
    g = gnn.random_graph(300, 1500, cfg.d_in, cfg.n_classes, seed=5)
    g["edge_weight"] = rng.uniform(0.1, 2.0, 1500).astype(np.float32)
    batch = gnn.NeighborSampler(g["src"], g["dst"], 300, seed=5
                                ).sample_batch(np.arange(64),
                                               cfg.sample_sizes,
                                               g["features"], g["labels"])
    batch["mask_hop_2"] = rng.random((64, 5, 3)) < 0.7
    cpu = gnn.init_params(cfg, device="cpu", seed=5)
    tree = export_params(cpu)
    worst = 0.0
    for name, data, make in (
            ("full", g, gnn.make_full_graph_train_step),
            ("sampled", batch, gnn.make_sampled_train_step)):
        results = []
        for dev in ("cpu", "cuda"):
            params = gnn.init_params(cfg, device=dev, seed=6)
            load_jax_params(params, tree)
            d = _to_device(data, torch.device(dev))
            forward = (gnn.full_graph_forward if name == "full"
                       else gnn.sampled_forward)
            logits = forward(cfg, params, d)
            loss = gnn.node_classification_loss(logits, d["labels"])
            grads = torch.autograd.grad(loss, list(params.parameters()))
            opt = optim.adam(1e-2)
            make(cfg, opt)(params, opt.init(list(params.parameters())), d)
            results.append([logits, loss, *grads, *params.parameters()])
        for a, b in zip(*results):
            worst = max(worst, _hold_close(f"gnn cpu_vs_gpu {name}", b, a))
    return {"max_abs_err": worst}


def _lm_batch(cfg, batch, seq, gen):
    from repro_torch.configs.lm_common import lm_smoke_batch

    return lm_smoke_batch(cfg, batch=batch, seq=seq, gen=gen, device="cuda")


#: Each LM run at FULL width: (train steps, global batch); JAX's global
#: batch is 256 at seq 4,096. The prefill and decode batches are the most
#: rows that fit the card (``_lm_serve_rows``), up to JAX's 32 (prefill,
#: 32,768) and 128 (decode against 32,768).
LM_RUNS = {"llama3.2-1b": (4, 4),
           "granite-moe-1b-a400m": (4, 4),
           "phi3-mini-3.8b": (4, 4)}
# 4 llama steps and 8 decode steps (8 and 16 before the dry run joined
# the smoke's time)
LM_TRAIN_SEQ, LM_PREFILL_SEQ, LM_DECODE_STEPS = 4096, 32768, 8
LM_PREFILL_BATCH, LM_DECODE_BATCH = 32, 128  # JAX's
#: The share of the card's memory kept free of the reckoned rows: the
#: allocator's rounding and fragmentation, cuBLAS's workspaces.
LM_MEMORY_SLACK = 0.15


def _lm_serve_rows(cfg):
    """The prefill and decode batches at seq 32,768 that fit what the card
    has free now (the parameters already on it), less ``LM_MEMORY_SLACK``
    of its memory, reckoned a row at a time:

    * a cache row: K and V, every layer, seq x kv heads x head dim in the
      compute type;
    * prefill: its cache row, and five float32 score blocks of one
      attention chunk (heads x chunk x seq x 4 B: the scores, scaled,
      masked, the softmax and the einsum's own; the chunked attention holds
      one chunk's at a time). The card's peaks at seq 32,768 stay 4-12%
      under it;
    * decode: its cache row at seq 32,784, and one layer's repeated K and
      V (bfloat16 where GQA repeats them) with their float32 copies (heads
      x seq x head dim each), as the card's peaks read them.

    The decode cache is filled while the prefill's is held, so its rows
    also fit beside that. Returns (prefill rows, decode rows, the
    reckoning)."""
    import torch

    free, total = torch.cuda.mem_get_info()
    budget = free - LM_MEMORY_SLACK * total
    item = torch.empty((), dtype=cfg.dtype).element_size()
    s_pre, s_dec = LM_PREFILL_SEQ, LM_PREFILL_SEQ + LM_DECODE_STEPS
    kv = cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 * item  # a token
    chunk = min(cfg.attn_chunk, s_pre)
    prefill_row = kv * s_pre + 5 * cfg.n_heads * chunk * s_pre * 4
    group = cfg.n_heads // cfg.n_kv_heads
    temps = 2 * cfg.n_heads * s_dec * cfg.head_dim * (
        4 + (item if group > 1 else 0))
    decode_row = kv * s_dec + temps
    pre_b = min(LM_PREFILL_BATCH, int(budget // prefill_row))
    dec_b = min(LM_DECODE_BATCH, int(budget // decode_row),
                int((budget - pre_b * kv * s_pre) // (kv * s_dec)))
    reckoning = {"free_gb": free / 1e9, "total_gb": total / 1e9,
                 "budget_gb": budget / 1e9,
                 "prefill_row_gb": prefill_row / 1e9,
                 "decode_row_gb": decode_row / 1e9,
                 "cache_row_gb": kv * s_dec / 1e9}
    if pre_b < 1 or dec_b < 1:
        raise AssertionError(f"lm {cfg.name}: no row fits {reckoning}")
    return pre_b, dec_b, reckoning


def _lm_run(arch, card):
    """One LM arch at FULL width on the card: ``steps`` train steps on one
    repeated batch (the loss must fall), then prefill of 32,768-token
    prompts and 8 decode steps against their cache, each at the most rows
    that fit (``_lm_serve_rows``). Returns the train run's counts."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.models import lm

    cfg = registry.get_arch(arch).FULL
    steps, batch = LM_RUNS[arch]
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    _free_card()
    params = lm.init_params(cfg, device=device, seed=LM_SEED)
    n_tensors = len(list(params.parameters()))
    opt = optim.adamw(3e-4, moment_dtype=cfg.opt_dtype)
    state = opt.init(list(params.parameters()))
    data = _lm_batch(cfg, batch, LM_TRAIN_SEQ, gen)
    step = lm.make_train_step(cfg, opt)
    reset_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, data)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = check_counts(f"lm {arch} train", {"adamw": n_tensors * steps})
    _falls(f"lm {arch}", losses)
    # the no-mesh run the lm_mesh phase holds its mesh forms against
    _KEPT[f"lm_{arch}"] = {"losses": losses, "step_ms": ms,
                           "tokens_per_s": batch * LM_TRAIN_SEQ
                           / (float(np.median(ms[1:])) / 1e3),
                           **_peak_gb()}
    # one profiled step (llama3.2-1b's: processing a larger trace costs
    # the smoke tens of seconds)
    profiled = (_step_profile(lambda: step(params, state, data))
                if arch == "llama3.2-1b" else None)
    tokens = batch * LM_TRAIN_SEQ
    train = {"steps": steps, "global_batch": batch, "seq": LM_TRAIN_SEQ,
             "microbatches": cfg.microbatches, "scan_chunks": cfg.scan_chunks,
             "step_ms": ms, "losses": losses,
             "tokens_per_s": tokens / (float(np.median(ms[1:])) / 1e3),
             "launches": counts, "param_tensors": n_tensors,
             "params": sum(p.numel() for p in params.parameters()),
             **_peak_gb(), "profiled_step": profiled,
             "cut": f"global batch 256 -> {batch} (one repeated batch)"}
    emit("lm", arch=arch, run="train", card=card, **train)
    del state, data, step, opt
    _free_card()
    # prefill, then decode against its cache
    pre_b, dec_b, reckoning = _lm_serve_rows(cfg)
    prompt = _lm_batch(cfg, pre_b, LM_PREFILL_SEQ, gen)["tokens"]
    prefill, decode = lm.make_prefill_step(cfg), lm.make_decode_step(cfg)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    _check_lm_logits(f"lm {arch} prefill", cfg, logits, pre_b)
    pre_peak = _peak_gb()
    torch.cuda.empty_cache()  # the prefill's blocks, before the decode cache
    full = lm.init_cache(cfg, dec_b, LM_PREFILL_SEQ + LM_DECODE_STEPS,
                         device=device)
    for k in full:  # the prompts' rows in turn
        for r in range(pre_b):
            full[k][:, :, r::pre_b, :LM_PREFILL_SEQ] = cache[k][:, :, r:r + 1]
    del cache
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.randint(0, cfg.vocab, (dec_b, 1), generator=gen,
                           device=device, dtype=torch.int32)
    dec_ms = []
    for i in range(LM_DECODE_STEPS):
        t0 = time.perf_counter()
        logits, full = decode(params, full, tokens, LM_PREFILL_SEQ + i)
        tokens = torch.argmax(logits[:, -1], dim=-1, keepdim=True
                              ).to(torch.int32)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t0) * 1e3)
    _check_lm_logits(f"lm {arch} decode", cfg, logits, dec_b)
    check_counts(f"lm {arch} prefill and decode", {})
    serve = {"prefill_batch": pre_b, "prefill_seq": LM_PREFILL_SEQ,
             "prefill_ms": prefill_ms,
             "prefill_tokens_per_s": pre_b * LM_PREFILL_SEQ
             / (prefill_ms / 1e3),
             "prefill_peak": pre_peak, "decode_batch": dec_b,
             "cache_tokens": LM_PREFILL_SEQ + LM_DECODE_STEPS,
             "cache_gb": 2 * full["k"].numel() * 2 / 1e9,
             "decode_ms": dec_ms,
             "decode_ms_per_token": float(np.median(dec_ms[1:])),
             "decode_tokens_per_s": dec_b / (float(np.median(dec_ms[1:]))
                                             / 1e3),
             "decode_peak": _peak_gb(), "rows": reckoning,
             "cut": f"prefill batch {LM_PREFILL_BATCH} -> {pre_b}, decode "
                    f"batch {LM_DECODE_BATCH} -> {dec_b}: the most rows "
                    f"that fit {reckoning['budget_gb']:.1f} GB at "
                    f"{reckoning['prefill_row_gb']:.2f} and "
                    f"{reckoning['decode_row_gb']:.2f} GB a row (the "
                    f"prompts' caches repeated over the decode rows)"}
    emit("lm", arch=arch, run="prefill_decode", card=card, **serve)
    del params, full, logits
    _free_card()
    return counts


def _step_profile(fn, top=8):
    """One more call of ``fn`` (a train step, after the timed and counted
    ones) under torch.profiler: its wall ms, the device's busy ms (the
    union of kernel and copy intervals), and the ``top`` kernels by device
    ms with their launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    per_kernel = Counter()
    launches = Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            name = evt.name[:100]
            per_kernel[name] += evt.time_range.elapsed_us() / 1e3
            launches[name] += 1
    busy_us, n = _busy_us(prof)
    return {"wall_ms": wall, "device_busy_ms": busy_us / 1e3,
            "device_records": n,
            "top_kernels": [{"kernel": k, "ms": ms, "launches": launches[k]}
                            for k, ms in per_kernel.most_common(top)]}


def _check_lm_logits(what, cfg, logits, batch):
    import torch

    if tuple(logits.shape) != (batch, 1, cfg.padded_vocab):
        raise AssertionError(f"{what}: logits {tuple(logits.shape)}")
    real = logits[..., :cfg.vocab]
    if not bool(torch.isfinite(real).all()):
        raise AssertionError(f"{what}: non-finite logits")
    if not bool(torch.isneginf(logits[..., cfg.vocab:]).all()):
        raise AssertionError(f"{what}: padded vocab not -inf")


def _lm_cpu_vs_gpu():
    """The five LM archs' reduced configs in float32 with one set of weights
    on the CPU port and on the card: logits, loss, every gradient, one
    AdamW step with microbatches 1 and 2 (eps 1e-2: Adam's first step with
    eps 1e-8 is sign(g) wherever a gradient is within rounding of 0, so a
    rounding apart moves a parameter by 2 lr), prefill and two decode
    steps, at 1e-5."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.convert import export_params, load_jax_params
    from repro_torch.models import lm

    out = {}
    for arch in registry.LM_ARCHS:
        cfg = dataclasses.replace(registry.get_arch(arch).reduced(),
                                  dtype=torch.float32,
                                  param_dtype=torch.float32)
        tree = export_params(lm.init_params(cfg, device="cpu", seed=7))
        rng = np.random.default_rng(7)
        data = {"tokens": rng.integers(0, cfg.vocab, (4, 21)).astype(np.int32),
                "targets": rng.integers(-1, cfg.vocab, (4, 21)
                                        ).astype(np.int32)}
        results = []
        for dev in ("cpu", "cuda"):
            def fresh():
                p = lm.init_params(cfg, device=dev, seed=8)
                load_jax_params(p, tree)
                return p

            d = _to_device(data, torch.device(dev))
            params = fresh()
            logits = lm.forward(cfg, params, d["tokens"])
            loss = lm.lm_loss(cfg, params, d)
            res = [logits, loss, *torch.autograd.grad(
                loss, list(params.parameters()))]
            for m in (1, 2):
                stepped = fresh()
                opt = optim.adamw(1e-3, eps=1e-2)
                _, _, sl = lm.make_train_step(
                    dataclasses.replace(cfg, microbatches=m), opt)(
                    stepped, opt.init(list(stepped.parameters())), d)
                res += [sl, *stepped.parameters()]
            pl, cache = lm.make_prefill_step(cfg)(params, d["tokens"][:2])
            full = lm.init_cache(cfg, 2, 32, device=torch.device(dev))
            for k in full:
                full[k][:, :, :, :21] = cache[k]
            res += [pl[..., :cfg.vocab], cache["k"], cache["v"]]
            for i in range(2):
                dl, full = lm.make_decode_step(cfg)(
                    params, full, d["tokens"][2:, i:i + 1], 21 + i)
                res += [dl[..., :cfg.vocab], full["k"].clone(),
                        full["v"].clone()]
            results.append(res)
        worst = 0.0
        for a, b in zip(*results):
            worst = max(worst, _hold_close(f"lm cpu_vs_gpu {arch}", b, a))
        out[arch] = {"max_abs_err": worst, "tensors": len(results[0])}
    return out


def phase_lm(card):
    """The LM family at FULL width: llama3.2-1b, granite-moe-1b-a400m and
    phi3-mini-3.8b trained (seq 4,096, JAX's microbatches and scan_chunks;
    the fused adamw over bfloat16 parameters), prefilled at 32,768 and
    decoded 16 tokens against that cache; llama3-405b and Maverick on
    ``meta`` (counts only: neither fits one card). Then the five reduced
    configs on the CPU port against the card. Returns llama3.2-1b's train
    counts."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    _free_card()
    emit("lm_start", card=card,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         memory_reserved_gb=torch.cuda.memory_reserved() / 1e9)
    counts = {}
    for arch in LM_RUNS:
        counts[arch] = _lm_run(arch, card)
    for arch in ("llama3-405b", "llama4-maverick-400b-a17b"):
        cfg = registry.get_arch(arch).FULL
        params = lm.init_params(cfg, device="meta")
        numel = sum(p.numel() for p in params.parameters())
        padding = 2 * (cfg.padded_vocab - cfg.vocab) * cfg.d_model
        if numel != cfg.param_count() + padding or not all(
                p.is_meta for p in params.parameters()):
            raise AssertionError(f"lm {arch} meta init: {numel}")
        emit("lm", arch=arch, run="meta", card=card,
             param_count=cfg.param_count(),
             active_param_count=cfg.active_param_count(),
             meta_elements=numel,
             bf16_param_gb=cfg.param_count() * 2 / 1e9)
    emit("lm_cpu_vs_gpu", card=card, **_lm_cpu_vs_gpu())
    emit("lm_done", card=card, seconds=time.perf_counter() - t_phase)
    torch.cuda.synchronize()
    return counts["llama3.2-1b"]


def _moonlight_routing(tokens, gen):
    """Moonlight's MoE-layer routing of ``tokens`` tokens: sigmoid scores
    of unit-size logits plus a +-0.05 choice bias, top-6 of 64 experts;
    the (E,) counts and the slots sorted by expert."""
    import torch

    from repro_torch.configs import moonlight_16b

    cfg = moonlight_16b.FULL
    logits = torch.randn(tokens, cfg.n_experts, device="cuda", generator=gen)
    bias = (torch.rand(cfg.n_experts, device="cuda", generator=gen) - 0.5) / 10
    top_i = torch.topk(torch.sigmoid(logits) + bias, cfg.top_k, -1).indices
    flat = top_i.reshape(-1)
    return torch.bincount(flat, minlength=cfg.n_experts), flat.numel()


def phase_grouped_mm(card):
    """Moonlight's grouped GEMM at the scoring cell's shapes: one MoE
    layer's 196,608 routed rows (8 x 4,096 tokens, top-6) over 64 experts,
    the gate (and up) projection (K 2,048, N 1,408) and the down projection
    (K 1,408, N 2,048): the port's ``grouped_mm`` (``torch._grouped_mm`` on
    the card) against its plain form (max abs error, bfloat16 ulps), its
    device ms beside its bound (operations at 989 TFLOP/s, or the experts'
    weights and the rows in and out at 3.35 TB/s) and the plain form's ms;
    and the edge cases (an expert with no rows, one row, all rows on one
    expert)."""
    import torch

    from repro_torch.kernels import grouped_mm as gmm

    _free_card()
    gen = torch.Generator(device="cuda").manual_seed(33)
    counts, M = _moonlight_routing(8 * 4096, gen)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    E, D, Fm = 64, 2048, 1408

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(torch.bfloat16)

    def ulps(got, want):
        # a bfloat16 ulp at each answer, or at the answers' RMS near 0:
        # the two sum in float32 in other orders, then round once
        want = want.float()
        err = (got.float() - want).abs()
        return err, err / (torch.finfo(torch.bfloat16).eps * (
            want.abs() + want.pow(2).mean().sqrt()))

    cases = {"gate": (bf16(M, D), bf16(E, D, Fm, scale=D ** -0.5)),
             "down": (bf16(M, Fm), bf16(E, Fm, D, scale=Fm ** -0.5))}
    for name, (x, w) in cases.items():
        K, N = w.shape[1], w.shape[2]
        got = gmm.grouped_mm(x, w, ends)
        torch.cuda.synchronize()
        err, ulp = ulps(got, gmm.grouped_mm_plain(x, w, ends))
        if float(ulp.max()) > 2.0:
            raise AssertionError(f"grouped_mm {name}: {float(err.max())}")
        flops = 2.0 * M * K * N
        nbytes = 2.0 * (E * K * N + M * K + M * N)
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        kernel = time_ms(lambda: gmm.grouped_mm(x, w, ends), iters=20,
                         warmup=3)
        plain = time_ms(lambda: gmm.grouped_mm_plain(x, w, ends), iters=3,
                        warmup=1)
        emit("kernel", kernel="grouped_mm", card=card, case=name,
             rows=M, experts=E, k=K, n=N,
             rows_per_expert={"min": int(counts.min()),
                              "max": int(counts.max())},
             max_abs_err=float(err.max()),
             max_err_bf16_ulps=float(ulp.max()),
             device_ms={"kernel": kernel, "plain": plain, "bound": bound},
             share_of_bound=bound / kernel, tflops=flops / kernel / 1e9)
        del got, err, ulp
    edges = {}
    for name, c in (("empty_and_one_row", [0, 1, 300, 0, 77, 0, 5, 1]),
                    ("one_expert", [0, 0, 513, 0, 0, 0, 0, 0]),
                    ("all_empty_but_tail", [0] * 7 + [129])):
        cnt = torch.tensor(c, device="cuda")
        e = torch.cumsum(cnt, 0, dtype=torch.int32)
        x, w = bf16(sum(c), 256), bf16(8, 256, 96)
        err, ulp = ulps(gmm.grouped_mm(x, w, e), gmm.grouped_mm_plain(x, w, e))
        edges[name] = float(err.max())
        if float(ulp.max()) > 2.0:
            raise AssertionError(f"grouped_mm edge {name}: {edges[name]}")
    emit("kernel_edges", kernel="grouped_mm", card=card, max_abs_err=edges)
    del cases
    _free_card()


# ---------------------------------------------------------------------------
# slice 14: the distributed layer
# ---------------------------------------------------------------------------

# every kernel node the last measured_run's replays launched, by name
_LAST_REPLAYED: Counter = Counter()
# what an earlier phase leaves for the distrib phase (the ogb_products graph
# on the host and its unsharded losses)
_KEPT: dict = {}


def _nccl_nodes(counter) -> dict:
    return {name: n for name, n in counter.items() if "nccl" in name.lower()}


def _dist_run(kind, make_loader, steps, mesh):
    """Two epochs of ``steps`` steps each of the paper-width ``kind``
    through ``Trainer.train`` (chunks of 4), with or without ``mesh``, as a
    :func:`measured_run` (the first chunk eager and captured, the rest
    replays): the model, the history, the parameters (device copies), the
    counts, the NCCL kernel nodes replayed, the warm step (epoch 2: replays
    only) and the peak memory."""
    import torch

    from repro_torch.train import TrainEngine, Trainer

    _free_card()
    model, make_optimizer, sparse, per_step, _ = _train_spec(kind)
    per_opt = _optimizer_launches(TrainEngine(model, make_optimizer(),
                                              **sparse), 1)
    trainer = Trainer(make_optimizer(), epochs=2, chunk_batches=4,
                      device="cuda", log_fn=_quiet, mesh=mesh, **sparse)
    total = {k: n * 2 * steps for k, n in {**per_step, **per_opt}.items()}
    eager = {k: n * 4 for k, n in {**per_step, **per_opt}.items()}
    what = f"distrib_{kind}" + ("_mesh" if mesh is not None else "")
    loader = make_loader()  # a loader's cursor moves: one each run
    history, counted = measured_run(what, lambda: trainer.train(model,
                                                                loader),
                                    total, eager)
    params = [p.detach().clone() for p in model.parameters()]
    return {"model": model, "history": history, "params": params,
            "launches": counted["launches"],
            "replayed_kernel_nodes": counted["replayed_kernels"],
            "nccl_nodes": _nccl_nodes(_LAST_REPLAYED),
            "warm_step_ms": history[1]["seconds"] / steps * 1e3,
            **_peak_gb()}


def _replay_profile(model, kind, mesh, batch):
    """One chunk of 4 through a fresh engine on ``model`` (with or without
    ``mesh``): captured, then replayed under torch.profiler: device us of
    the NCCL kernels and of all kernels per replay; then one replay, its
    copies included, under sync debug "error"."""
    import torch

    from repro_torch.train import TrainEngine

    _, make_optimizer, sparse, _, _ = _train_spec(kind)
    engine = TrainEngine(model, make_optimizer(), chunk_batches=4,
                         mesh=mesh, **sparse)
    state = engine.init_opt_state()
    chunk = _chunk_of(batch)
    for _ in range(2):  # capture, then a replay
        state, _ = engine.step(state, chunk)
    lines, total = profile_kernels(lambda: engine.step(state, chunk),
                                   calls=3)
    nccl = [x for x in lines if "nccl" in x["kernel"].lower()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.step(state, chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {"device_us_per_replay": total["device_us_per_call"],
           "kernels_per_replay": total["launches_per_call"],
           "nccl_device_us_per_replay": sum(x["device_us_per_call"]
                                            for x in nccl),
           "nccl_kernels": nccl, "captures": engine.graphs.captures,
           "no_host_sync_in_replay": True}
    del engine, state
    return out


def _lookup_and_compression(mesh, card):
    """masked_psum_lookup (value, gradient) and compressed_psum on the
    card at a world of one against their plain forms, timed."""
    import torch

    from repro_torch.distrib import masked_psum_lookup
    from repro_torch.distrib.compression import (CompressedAllReduce,
                                                 compressed_psum,
                                                 dequantize_int8,
                                                 quantize_int8)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    table = torch.randn(1 << 20, 16, generator=gen, device="cuda")
    ids = torch.randint(0, 1 << 20, (B_MAIN, K_MAIN), generator=gen,
                        device="cuda")
    weight = torch.randn(B_MAIN, K_MAIN, 16, generator=gen, device="cuda")
    lookup = masked_psum_lookup(mesh)
    got, want = lookup(table, ids), table[ids]
    t = table.clone().requires_grad_(True)
    (lookup(t, ids) * weight).sum().backward()
    grad_want = torch.zeros_like(table).index_put_(
        (ids.reshape(-1),), weight.reshape(-1, 16), accumulate=True)
    grads = torch.randn(B_MAIN * K_MAIN, generator=gen, device="cuda")
    state = CompressedAllReduce.init(grads)
    group = mesh.get_group("data")
    reduced, _ = compressed_psum(grads, group, state)
    plain = dequantize_int8(*quantize_int8(grads))
    out = {
        "lookup_bits_equal": bool(torch.equal(got, want)),
        "lookup_grad_max_abs_err": _hold_close(
            "masked_psum_lookup grad", t.grad, grad_want, tol=1e-5),
        "lookup_ms": time_ms(lambda: lookup(table, ids), iters=50),
        "plain_gather_ms": time_ms(lambda: table[ids], iters=50),
        "compressed_psum_bits_equal": bool(torch.equal(reduced, plain)),
        "compressed_psum_ms": time_ms(
            lambda: compressed_psum(grads, group, state), iters=50),
        "plain_quantize_ms": time_ms(
            lambda: dequantize_int8(*quantize_int8(grads)), iters=50)}
    if not (out["lookup_bits_equal"] and out["compressed_psum_bits_equal"]):
        raise AssertionError(f"distrib collectives on the card: {out}")
    emit("distrib_collectives", card=card, **out)


def _sage_mesh(card, mesh):
    """GraphSAGE's two sharded forms at a world of one against the
    unsharded form: full_graph_sm (logits and 8 train steps' losses at
    1e-5), then ogb_products (the edge-sharded step, 2 steps, on the graph
    the gnn phase built: ms, peak, losses against the gnn phase's)."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.configs import graphsage_reddit as conf
    from repro_torch.models import gnn

    device = torch.device("cuda")
    out = {}
    info = conf.SHAPES["full_graph_sm"]
    cfg = conf.shape_config("full_graph_sm")
    g = gnn.random_graph(info["n_nodes"], info["n_edges"], info["d_feat"],
                         info["n_classes"], seed=LM_SEED)
    graph = _to_device(g, device)
    params = gnn.init_params(cfg, device=device, seed=LM_SEED)
    with torch.no_grad():
        dense = gnn.full_graph_forward(cfg, params, graph)
        errs = {}
        for form, c in (("edge_sharded", cfg), ("dst_partitioned",
                        dataclasses.replace(cfg, partitioned_edges=True))):
            errs[form] = _hold_close(
                f"sage {form}", gnn.full_graph_forward(c, params, graph,
                                                       mesh), dense)
    losses = {}
    for form, m in (("unsharded", None), ("edge_sharded", mesh)):
        p = gnn.init_params(cfg, device=device, seed=LM_SEED)
        opt = optim.adam(1e-2)
        losses[form], _ = _sage_step_loop(
            gnn.make_full_graph_train_step(cfg, opt, m), p,
            opt.init(list(p.parameters())), graph, 8)
    for a, b in zip(losses["unsharded"], losses["edge_sharded"]):
        if abs(a - b) > 1e-5 * (1 + abs(a)):
            raise AssertionError(f"sage full_graph_sm losses: {losses}")
    out["full_graph_sm"] = {"logits_max_abs_err": errs, "losses": losses}
    del graph, params
    g_ogb = _KEPT.pop("ogb_products_graph", None)
    if g_ogb is None:
        info = conf.SHAPES["ogb_products"]
        g_ogb = gnn.random_graph(info["n_nodes"], info["n_edges"],
                                 info["d_feat"], info["n_classes"],
                                 seed=LM_SEED)
    cfg = conf.shape_config("ogb_products")
    _free_card()
    graph = _to_device(g_ogb, device)
    del g_ogb
    p = gnn.init_params(cfg, device=device, seed=LM_SEED)
    opt = optim.adam(1e-2)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, ms = _sage_step_loop(gnn.make_full_graph_train_step(cfg, opt,
                                                                mesh),
                                 p, opt.init(list(p.parameters())), graph, 2)
    counts = check_counts("distrib sage ogb_products", {"adamw": 6 * 2})
    unsharded = _KEPT.pop("ogb_products_losses", None)
    if unsharded is not None:
        for a, b in zip(unsharded, losses):
            if abs(a - b) > 1e-5 * (1 + abs(a)):
                raise AssertionError(f"sage ogb_products: edge-sharded "
                                     f"{losses} vs unsharded {unsharded}")
    out["ogb_products"] = {"step_ms": ms, "losses": losses,
                           "unsharded_losses": unsharded,
                           "launches": counts, **_peak_gb()}
    del graph, p
    _free_card()
    emit("distrib_sage", card=card, **out)


def _world_worker(rank, world, port, path, steps, result):
    """A rank of the world over every card: the paper-width DBN (dense
    tables) for ``steps`` steps of the global batch on a data-parallel
    mesh; rank 0 holds its parameters against the world of one's (``path``)
    at 1e-5, and every rank times the all-reduce of the two tables'
    gradients."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    from repro_torch.data import ClickLogLoader
    from repro_torch.launch.mesh import make_data_parallel_mesh
    from repro_torch.train import Trainer

    mesh = make_data_parallel_mesh()
    with np.load(os.path.join(os.path.dirname(path), "data.npz")) as f:
        data = {k: f[k] for k in f.files}
    model, make_optimizer, _, _, _ = _train_spec("dbn")
    trainer = Trainer(make_optimizer(), epochs=1, chunk_batches=4,
                      device="cuda", log_fn=_quiet, mesh=mesh)
    history = trainer.train(model, ClickLogLoader(data, batch_size=B_MAIN,
                                                  seed=0))
    grads = [torch.ones_like(p) for p in model.parameters()
             if p.numel() > 1_000_000]
    for g in grads:
        dist.all_reduce(g)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        for g in grads:
            dist.all_reduce(g)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    if rank == 0:
        want = torch.load(path)
        err = max(float((p.detach() - w.cuda()).abs().max())
                  for p, w in zip(model.parameters(), want["params"]))
        loss_err = abs(history[0]["train_loss"] - want["train_loss"])
        with open(result, "w") as f:
            json.dump({"world": world, "params_max_abs_err": err,
                       "train_loss": history[0]["train_loss"],
                       "train_loss_err": loss_err,
                       "allreduce_ms_per_step": ms,
                       "allreduce_bytes": sum(g.numel() * 4 for g in grads),
                       "warm_seconds": history[0]["seconds"]}, f)
    dist.destroy_process_group()


def _multi_card(card, data, steps):
    """The world over every card when there are several: the DBN's
    parameters against the world of one's at 1e-5, and the all-reduce's
    time. One card: a line saying it did not run."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.data import ClickLogLoader
    from repro_torch.launch.mesh import make_data_parallel_mesh
    from repro_torch.train import Trainer

    world = torch.cuda.device_count()
    if world < 2:
        emit("distrib_world", card=card, ran=False,
             reason="one card: the world over several cards did not run "
                    "(neither a pass nor a failure)")
        return
    with tempfile.TemporaryDirectory() as tmp:
        # the world of one's run of the same steps, kept for rank 0
        _free_card()
        model, make_optimizer, _, _, _ = _train_spec("dbn")
        trainer = Trainer(make_optimizer(), epochs=1, chunk_batches=4,
                          device="cuda", log_fn=_quiet,
                          mesh=make_data_parallel_mesh())
        history = trainer.train(model, ClickLogLoader(
            {k: v[:steps * B_MAIN] for k, v in data.items()},
            batch_size=B_MAIN, seed=0))
        np.savez(os.path.join(tmp, "data.npz"),
                 **{k: v[:steps * B_MAIN] for k, v in data.items()})
        path = os.path.join(tmp, "one.pt")
        torch.save({"params": [p.detach().cpu() for p in model.parameters()],
                    "train_loss": history[0]["train_loss"]}, path)
        del model, trainer
        _free_card()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        result = os.path.join(tmp, "world.json")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_world_worker,
                             args=(r, world, port, path, steps, result))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise AssertionError(f"distrib world of {world}: exit codes "
                                 f"{codes}")
        with open(result) as f:
            found = json.load(f)
    if found["params_max_abs_err"] > 1e-5 or found["train_loss_err"] > 1e-5:
        raise AssertionError(f"distrib world of {world}: {found}")
    emit("distrib_world", card=card, ran=True, **found)


def _launcher_data_parallel(card):
    """``python -m repro_torch.launch.train --data-parallel`` on the card
    (a world of one under NCCL; UBM, 200,000 sessions, hashed 10x, two
    epochs) beside the same launcher without the flag, both at once: exit
    0, the mesh printed once, and the epoch records and test metrics of
    the two equal to the bit."""
    import ast

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--sessions",
            "200000", "--epochs", "2", "--batch", "8192", "--compression",
            "hash", "--ratio", "10"]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(argv + extra, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, extra in (("plain", []),
                                 ("data_parallel", ["--data-parallel"]))}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"launcher {name} exited {proc.returncode}"
                                 f": {stderr[-3000:]}")
        records = [ast.literal_eval(line.split("] ", 1)[1])
                   for line in stdout.splitlines()
                   if line.startswith("[trainer] {")]
        out[name] = {"records": [{k: v for k, v in r.items()
                                  if k != "seconds"} for r in records],
                     "test": [line for line in stdout.splitlines()
                              if line.startswith("[train] test")],
                     "mesh_lines": [line for line in stdout.splitlines()
                                    if "data-parallel mesh" in line]}
    seconds = time.perf_counter() - t0
    dp, plain = out["data_parallel"], out["plain"]
    if (len(dp["mesh_lines"]) != 1 or len(dp["records"]) != 2
            or dp["records"] != plain["records"]
            or dp["test"] != plain["test"]):
        raise AssertionError(f"launcher --data-parallel: {out}")
    emit("distrib_launcher", card=card, seconds=seconds,
         mesh=dp["mesh_lines"][0], records_bits_equal=True,
         records=dp["records"], test=dp["test"][0])


def phase_distrib(card, data, steps=8):
    """Slice 14: a world of one under NCCL (``make_data_parallel_mesh()``)
    through ``Trainer.train(mesh=...)``: the paper-width DBN (dense and
    sparse tables) and DCTR, ``steps`` steps an epoch for two epochs, each
    equal to the bit (parameters and losses) to the same run without a
    mesh, with exact launch counts (NCCL's kernel nodes counted apart);
    the warm step, peak memory, and one replay's collectives' device time,
    with and without the mesh. Then masked_psum_lookup and compressed_psum
    against their plain forms, GraphSAGE's sharded forms against the
    unsharded one, and the world over every card where there are
    several."""
    import torch

    from repro_torch.data import ClickLogLoader
    from repro_torch.launch.mesh import make_data_parallel_mesh

    t_phase = time.perf_counter()
    mesh = make_data_parallel_mesh()
    emit("distrib_mesh", card=card,
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
         backend=torch.distributed.get_backend(),
         torch=torch.__version__, nccl=".".join(
             str(v) for v in torch.cuda.nccl.version()))
    train = {k: v[:steps * B_MAIN] for k, v in data.items()}

    def make_loader():
        return ClickLogLoader(train, batch_size=B_MAIN, seed=0)

    held_lo = len(data["clicks"]) - B_MAIN
    held_out = _device_batch(data, held_lo, held_lo + B_MAIN)
    for kind in ("dbn", "dbn_sparse", "dctr"):
        runs, profiles = {}, {}
        for name, m in (("no_mesh", None), ("mesh", mesh)):
            run = _dist_run(kind, make_loader, steps, m)
            profiles[name] = _replay_profile(run.pop("model"), kind, m,
                                             held_out)
            runs[name] = run
        a, b = runs["no_mesh"], runs["mesh"]
        params_equal = all(torch.equal(x, y) for x, y in zip(a["params"],
                                                             b["params"]))
        losses = [[r["train_loss"] for r in run["history"]]
                  for run in (a, b)]
        if not params_equal or losses[0] != losses[1] or \
                a["launches"] != b["launches"] or b["nccl_nodes"]:
            raise AssertionError(f"distrib {kind}: the world of one is not "
                                 f"the run without a mesh: losses {losses}, "
                                 f"launches {a['launches']} "
                                 f"{b['launches']}")
        for run in (a, b):
            del run["params"], run["history"]
        emit("distrib_train", kind=kind, card=card, steps=2 * steps,
             batch=B_MAIN, params_bits_equal=True, losses_bits_equal=True,
             train_loss=losses[1], no_mesh=a, mesh=b, replay=profiles)
        del runs
        _free_card()
    del held_out
    _lookup_and_compression(mesh, card)
    _sage_mesh(card, mesh)
    _launcher_data_parallel(card)
    _multi_card(card, data, steps)
    torch.distributed.destroy_process_group()
    emit("distrib_done", card=card, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# slice 15: the LM family's sharded forms, sparse tables over 'model'
# ---------------------------------------------------------------------------

#: lm_mesh's runs at FULL width: train steps (llama3.2-1b and granite at
#: the lm phase's global batch), decode steps against a random cache
LM_MESH_STEPS, LM_MESH_DECODE_STEPS = 4, 4
#: JAX's own bfloat16 bound on the sharded forms (tests/test_archs.py):
#: losses apart, and the decode logits' relative L2
LM_MESH_TOL = 2e-2


def _rows_of(mesh, tensors):
    """This rank's rows of each global tensor (split over the data axes)."""
    from repro_torch.distrib.shardings import DATA_AXES, NamedSharding, P

    return {k: NamedSharding(mesh, P(DATA_AXES(mesh))).local(v).contiguous()
            for k, v in tensors.items()}


def _lm_mesh_train(arch, mesh, **changes):
    """``LM_MESH_STEPS`` train steps of ``arch`` at FULL width (``changes``
    on its config) from the lm phase's parameters and batch (LM_SEED), on
    ``mesh``'s shards and rows (None: no mesh): losses, ms a step,
    tokens/s, peak memory and the adamw launches."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.models import lm

    cfg = dataclasses.replace(registry.get_arch(arch).FULL, **changes)
    batch = LM_RUNS[arch][1]
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    _free_card()
    params = lm.init_params(cfg, device=device, seed=LM_SEED)
    data = _lm_batch(cfg, batch, LM_TRAIN_SEQ, gen)
    if mesh is not None:
        params = lm.place_params(cfg, params, mesh)
        data = _rows_of(mesh, data)
    n_tensors = len(list(params.parameters()))
    opt = optim.adamw(3e-4, moment_dtype=cfg.opt_dtype)
    state = opt.init(list(params.parameters()))
    step = lm.make_train_step(cfg, opt, mesh)
    _free_card()
    reset_counts()
    losses, ms = [], []
    for _ in range(LM_MESH_STEPS):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, data)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = check_counts(f"lm_mesh {arch} {changes}",
                          {"adamw": n_tensors * LM_MESH_STEPS})
    out = {"losses": losses, "step_ms": ms,
           "tokens_per_s": batch * LM_TRAIN_SEQ
           / (float(np.median(ms[1:])) / 1e3), "launches": counts,
           **_peak_gb()}
    del params, state, data, step, opt
    _free_card()
    return out


def _losses_apart(what, got, want, tol=LM_MESH_TOL):
    """The largest |got - want| over the common steps, held to ``tol``."""
    n = min(len(got), len(want))
    apart = max(abs(a - b) for a, b in zip(got[:n], want[:n]))
    if not apart <= tol:
        raise AssertionError(f"{what}: losses {got} vs {want}")
    return apart


def _unit_gathers(cfg):
    """What one rank's FSDP gathers copy in a train step: a unit's weights
    (in ``param_dtype``), gathered in the forward and again in its
    recomputed forward, every microbatch, and reduce-scattered as much
    back in the backward; plus ``embed`` and ``lm_head`` once a
    microbatch."""
    import torch

    from repro_torch.models.lm.transformer import _stack_shapes

    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    unit = sum(int(np.prod(shape)) for stack in _stack_shapes(cfg).values()
               for shape in stack.values())
    head = 2 * cfg.padded_vocab * cfg.d_model
    per_step = cfg.microbatches * (2 * cfg.n_units * unit + head) * item
    return {"unit_weights_gb": unit * item / 1e9,
            "gathered_gb_per_step": per_step / 1e9,
            "reduce_scattered_gb_per_step": per_step / 1e9}


def _rel_l2(got, want):
    import torch

    got, want = got.detach().float(), want.detach().float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


#: what the mesh decode forms' logits are held to against no mesh
#: (relative L2 over the real vocabulary), by the run's type. At a world of
#: one the plain form runs no mesh's operations on tensors laid out as no
#: mesh's, so it is held to the bit in both types. Flash decoding divides
#: its partial sums instead of taking a softmax: in float32 that is
#: rounding apart (2.1e-6 to 2.9e-6 on the H100), held at 1e-4, the gate.
#: In bfloat16 any float32 rounding apart flips some of the attention's
#: bfloat16 outputs and the flips grow over 16 layers: 2.1e-2 to 2.2e-2
#: (an H100 80GB HBM3 at 700 W, 34 rows x 32,772), past JAX's 2e-2
#: (tests/test_archs.py:177). So the bfloat16 flash line is a smoke, not a
#: hold on the function: 5e-2, JAX's bound for flash decoding in bfloat16
#: (tests/test_archs.py:223), catches a gross fault only.
LM_MESH_DECODE_TOL = {"float32": {"plain": 0.0, "flash": 1e-4},
                      "bfloat16": {"plain": 0.0, "flash": 5e-2}}


def _lm_mesh_decode(mesh, card, dtype="bfloat16", rows=None,
                    prefix=LM_PREFILL_SEQ):
    """llama3.2-1b at FULL width in ``dtype``: a cache of ``rows`` (default
    the most that fit, ``_lm_serve_rows``) at ``prefix`` +
    ``LM_MESH_DECODE_STEPS`` positions, filled with seeded values up to
    ``prefix``, decoded ``LM_MESH_DECODE_STEPS`` tokens without a mesh, on
    the mesh plain and with flash decoding: ms a token each, and each mesh
    form's logits against no mesh (relative L2 over the real vocabulary,
    held to ``LM_MESH_DECODE_TOL``). The line is printed before the
    hold."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import lm

    kind = getattr(torch, dtype)
    cfg = dataclasses.replace(registry.get_arch("llama3.2-1b").FULL,
                              dtype=kind, param_dtype=kind)
    device = torch.device("cuda")
    _free_card()
    full = lm.init_params(cfg, device=device, seed=LM_SEED)
    placed = lm.place_params(cfg, full, mesh)
    reckoning = None
    if rows is None:
        _, rows, reckoning = _lm_serve_rows(cfg)
    seq = prefix + LM_MESH_DECODE_STEPS
    cache = lm.init_cache(cfg, rows, seq, device=device, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    for k in cache:  # seeded keys and values, layer by layer
        for u in range(cfg.n_units):
            cache[k][u, :, :, :prefix].normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab, (LM_MESH_DECODE_STEPS, rows, 1),
                           generator=gen, device=device, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    out, logits = {}, {}
    for form, params, m, c in (
            ("no_mesh", full, None, cfg), ("plain", placed, mesh, cfg),
            ("flash", placed, mesh,
             dataclasses.replace(cfg, flash_decode=True))):
        step = lm.make_decode_step(c, m)
        reset_counts()
        ms, got = [], []
        for i in range(LM_MESH_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step(params, cache, tokens[i], prefix + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append(lg[..., :cfg.vocab].float().clone())
        check_counts(f"lm_mesh decode {form}", {})
        _check_lm_logits(f"lm_mesh decode {form}", cfg, lg, rows)
        logits[form] = got
        out[form] = {"decode_ms": ms,
                     "decode_ms_per_token": float(np.median(ms[1:]))}
    for form in ("plain", "flash"):
        out[form].update(
            rel_l2_vs_no_mesh=[_rel_l2(a, b) for a, b in zip(
                logits[form], logits["no_mesh"])],
            logits_bits_equal_no_mesh=all(torch.equal(a, b) for a, b in zip(
                logits[form], logits["no_mesh"])),
            tol=LM_MESH_DECODE_TOL[dtype][form])
    out.update(dtype=dtype, rows=rows, cache_tokens=seq, peak=_peak_gb(),
               cache_gb=2 * cache["k"].numel() * cache["k"].element_size()
               / 1e9, reckoning=reckoning)
    del full, placed, cache, logits
    _free_card()
    emit("lm_mesh", run="decode", arch="llama3.2-1b", card=card, **out)
    for form in ("plain", "flash"):
        if not max(out[form]["rel_l2_vs_no_mesh"]) <= out[form]["tol"]:
            raise AssertionError(f"lm_mesh decode {dtype} {form}: "
                                 f"{out[form]} against no mesh")


def _row_parallel_gemm(card):
    """The partial product of the row-parallel ``wo`` and ``w_down`` at
    llama3.2-1b's FULL width, one train microbatch's tokens, the whole
    contraction (a model axis of N takes 1/N of it): ``sharded._MatmulF32``
    (bfloat16 operands, float32 result) against the float32 GEMM of the
    upcast operands and the bfloat16 GEMM of the explicit form, ms each
    (CUDA events, TF32 off), forward and backward against the upcast
    form's autograd, by relative L2. The forward is held at 1e-4: two
    float32 sums of 8,192 products in different orders (9.2e-6 apart on
    an H100), where a bfloat16 result would be ~2e-3 apart; the
    gradients, bfloat16 GEMMs against the float32 GEMM cast down, at
    1e-2, one bfloat16 rounding."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.lm import sharded

    cfg = registry.get_arch("llama3.2-1b").FULL
    batch, M = LM_RUNS["llama3.2-1b"][1], cfg.microbatches
    tokens = batch * LM_TRAIN_SEQ // M
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    out = {"tokens": tokens}
    for name, K in (("wo", cfg.n_heads * cfg.head_dim), ("w_down", cfg.d_ff)):
        x = torch.randn(tokens, K, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        w = (torch.randn(K, cfg.d_model, device="cuda", generator=gen)
             * K ** -0.5).to(torch.bfloat16)
        x.requires_grad_(True)
        w.requires_grad_(True)
        got = sharded._MatmulF32.apply(x, w)
        gy = torch.randn_like(got).to(torch.bfloat16).float()
        gx, gw = torch.autograd.grad(got, (x, w), gy)
        want = x.float() @ w.float()
        wx, ww = torch.autograd.grad(want, (x, w), gy)
        errs = {"forward": _rel_l2(got, want), "grad_x": _rel_l2(gx, wx),
                "grad_w": _rel_l2(gw, ww)}
        with torch.no_grad():
            ms = {"f32_out": time_ms(lambda: sharded._MatmulF32.apply(x, w),
                                     iters=20, warmup=3),
                  "upcast": time_ms(lambda: x.float() @ w.float(), iters=20,
                                    warmup=3),
                  "bf16": time_ms(lambda: x @ w, iters=20, warmup=3)}
        out[name] = {"shape": [tokens, K, cfg.d_model], "ms": ms,
                     "rel_l2": errs}
        del x, w, got, gy, gx, gw, want, wx, ww
        if not (errs["forward"] <= 1e-4 and errs["grad_x"] <= 1e-2
                and errs["grad_w"] <= 1e-2):
            raise AssertionError(f"lm_mesh row-parallel GEMM {name}: {out}")
    _free_card()
    emit("lm_mesh", run="row_parallel_gemm", arch="llama3.2-1b", card=card,
         **out)


#: the reduced configs the card holds to the CPU port's mesh forms, float32
LM_MESH_REDUCED = ("llama3.2-1b", "granite-moe-1b-a400m")


def _lm_mesh_forms(mesh, device):
    """The reduced configs in float32 through the mesh forms on ``device``
    (a world of one): logits, loss, every gradient, one AdamW step, the
    prefill's logits and cache, two plain decode steps and a flash one.
    The MoE at capacity factor n_experts, where no cut is left to
    rounding. Returns ``{arch: [tensors on the CPU]}``."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.convert import export_params, load_jax_params
    from repro_torch.models import lm

    out = {}
    dev = torch.device(device)
    for arch in LM_MESH_REDUCED:
        cfg = registry.get_arch(arch).reduced()
        cfg = dataclasses.replace(
            cfg, dtype=torch.float32, param_dtype=torch.float32,
            capacity_factor=float(max(cfg.n_experts, 1)))
        tree = export_params(lm.init_params(cfg, device="cpu", seed=7))
        rng = np.random.default_rng(7)
        data = {"tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab, (4, 24)).astype(np.int32)).to(dev),
                "targets": torch.from_numpy(rng.integers(
                    -1, cfg.vocab, (4, 24)).astype(np.int32)).to(dev)}

        def fresh():
            p = lm.init_params(cfg, device=dev, seed=8)
            load_jax_params(p, tree)
            return lm.place_params(cfg, p, mesh)

        params = fresh()
        res = [lm.forward(cfg, params, data["tokens"], mesh)]
        loss = lm.lm_loss(cfg, params, data, mesh)
        res += [loss, *torch.autograd.grad(loss, list(params.parameters()))]
        stepped = fresh()
        opt = optim.adamw(1e-3, eps=1e-2)
        _, _, sl = lm.make_train_step(cfg, opt, mesh)(
            stepped, opt.init(list(stepped.parameters())), data)
        res += [sl, *stepped.parameters()]
        pl, cache = lm.make_prefill_step(cfg, mesh)(params,
                                                    data["tokens"][:2])
        res += [pl[..., :cfg.vocab], cache["k"], cache["v"]]
        full = lm.init_cache(cfg, 2, 32, device=dev, mesh=mesh)
        for k in full:
            full[k][:, :, :, :24] = cache[k]
        for i, c in enumerate((cfg, cfg, dataclasses.replace(
                cfg, flash_decode=True))):
            dl, full = lm.make_decode_step(c, mesh)(
                params, full, data["tokens"][2:, i:i + 1], 24 + i)
            res += [dl[..., :cfg.vocab], full["k"].clone(),
                    full["v"].clone()]
        out[arch] = [t.detach().cpu() for t in res]
    return out



#: the world over several cards, and the world of one it is held to:
#: llama3.2-1b's train steps at the lm phase's batch (its microbatches) with
#: tensor parallelism over ``model``, one flash decoding step against a
#: seeded cache of these rows and positions, and the paper-width DBN with
#: sparse tables row-sharded over ``model``, one epoch of these steps
LM_TP = {"steps": 2, "decode_rows": 8, "decode_seq": 4096, "dbn_steps": 8}


def _lm_tp_forms(mesh, log):
    """``LM_TP``'s runs on ``mesh`` (a world of one, or ``(1, N)`` over N
    cards): llama3.2-1b's losses, the flash decoding step's logits over
    the real vocabulary, and the DBN's parameters after its epoch (row
    shards gathered), on the CPU."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.data import ClickLogLoader
    from repro_torch.distrib.shardings import DATA_AXES, NamedSharding, P
    from repro_torch.models import lm
    from repro_torch.train import TrainEngine, Trainer

    cfg = registry.get_arch("llama3.2-1b").FULL
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = lm.place_params(cfg, lm.init_params(cfg, device=device,
                                                 seed=LM_SEED), mesh)
    data = _rows_of(mesh, _lm_batch(cfg, LM_RUNS["llama3.2-1b"][1],
                                    LM_TRAIN_SEQ, gen))
    opt = optim.adamw(3e-4, moment_dtype=cfg.opt_dtype)
    state = opt.init(list(params.parameters()))
    step = lm.make_train_step(cfg, opt, mesh)
    losses = []
    for _ in range(LM_TP["steps"]):
        params, state, loss = step(params, state, data)
        losses.append(float(loss))
    del state, opt, step, data
    flash = dataclasses.replace(cfg, flash_decode=True)
    rows, seq = LM_TP["decode_rows"], LM_TP["decode_seq"]
    whole = lm.init_cache(flash, rows, seq, device=device)
    for k in whole:
        whole[k][:, :, :, :seq - 1].normal_(generator=gen)
    block = NamedSharding(mesh, P(None, None, DATA_AXES(mesh), "model"))
    cache = {k: block.local(v).clone() for k, v in whole.items()}
    del whole
    tokens = torch.randint(0, cfg.vocab, (rows, 1), generator=gen,
                           device=device, dtype=torch.int32)
    logits, _ = lm.make_decode_step(flash, mesh)(
        params, cache, _rows_of(mesh, {"t": tokens})["t"], seq - 1)
    logits = logits[..., :cfg.vocab].float().cpu()
    del params, cache
    _free_card()
    model, make_optimizer, sparse, _, _ = _train_spec("dbn_sparse")
    trainer = Trainer(make_optimizer(), epochs=1, chunk_batches=4,
                      device="cuda", log_fn=_quiet, mesh=mesh, **sparse)
    trainer.train(model, ClickLogLoader(log, batch_size=B_MAIN, seed=0))
    engine = TrainEngine(model, make_optimizer(), mesh=mesh, **sparse)
    dbn = engine.gathered(dict(zip(engine.names, engine.params)))
    out = {"llama_losses": losses, "decode_logits": logits,
           "dbn_params": {n: p.detach().cpu() for n, p in dbn.items()}}
    del model, trainer, engine, dbn
    _free_card()
    return out


def _lm_tp_worker(rank, world, port, path, result):
    """A rank of the ``(1, world)`` mesh over every card: ``_lm_tp_forms``;
    rank 0 holds them against the world of one's (``path``): llama's
    losses within ``LM_MESH_TOL``, the decode logits' relative L2 within
    it, the DBN's parameters at 1e-5."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, world), ("data", "model"))
    with np.load(os.path.join(os.path.dirname(path), "log.npz")) as f:
        log = {k: f[k] for k in f.files}
    got = _lm_tp_forms(mesh, log)
    if rank == 0:
        want = torch.load(path)
        found = {
            "world": world, "llama_losses": got["llama_losses"],
            "llama_losses_apart": max(abs(a - b) for a, b in zip(
                got["llama_losses"], want["llama_losses"])),
            "decode_rel_l2": _rel_l2(got["decode_logits"],
                                     want["decode_logits"]),
            "dbn_params_max_abs_err": max(
                float((got["dbn_params"][n] - w).abs().max())
                for n, w in want["dbn_params"].items())}
        with open(result, "w") as f:
            json.dump(found, f)
    dist.destroy_process_group()


def _lm_mesh_multi_card(card, mesh, data):
    """With several cards, a ``(1, N)`` world over all of them against the
    world of one (``mesh``): llama3.2-1b's step and decode with tensor
    parallelism, the DBN's sparse tables on ``model`` = N. One card: a
    line saying it did not run."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    if world < 2:
        emit("lm_mesh_world", card=card, ran=False,
             reason="one card: the (1, N) world over several cards did not "
                    "run (neither a pass nor a failure)")
        return
    log = {k: v[:LM_TP["dbn_steps"] * B_MAIN] for k, v in data.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "one.pt")
        torch.save(_lm_tp_forms(mesh, log), path)
        np.savez(os.path.join(tmp, "log.npz"), **log)
        _free_card()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        result = os.path.join(tmp, "world.json")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_lm_tp_worker,
                             args=(r, world, port, path, result))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 400
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise AssertionError(f"lm_mesh world of {world}: exit codes "
                                 f"{codes}")
        with open(result) as f:
            found = json.load(f)
    if (found["llama_losses_apart"] > LM_MESH_TOL
            or found["decode_rel_l2"] > LM_MESH_DECODE_TOL["bfloat16"]["flash"]
            or found["dbn_params_max_abs_err"] > 1e-5):
        raise AssertionError(f"lm_mesh world of {world}: {found}")
    emit("lm_mesh_world", card=card, ran=True, **found)


def phase_lm_mesh(card, data):
    """Slice 15, after every earlier path: the LM family's sharded forms
    on a ``(1, 1)`` mesh under NCCL. The reduced llama and granite configs
    in float32 through the mesh forms on the CPU port (a gloo world of
    one, first) and on the card, at 1e-5; llama3.2-1b at FULL width,
    ``LM_MESH_STEPS`` steps with ``explicit_row_parallel`` off and on
    against the lm phase's run without a mesh (losses within
    ``LM_MESH_TOL``, tokens/s, peak, what the FSDP gathers copy);
    granite-moe's capacity form (its losses fall) and at capacity factor
    32 against the dense oracle; llama's decode against a seeded cache
    without a mesh, plain and with flash decoding; the row-parallel
    matmul's float32 partial products. With several cards, a ``(1, N)``
    world against the world of one."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    cpu_mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    cpu = _lm_mesh_forms(cpu_mesh, "cpu")
    dist.destroy_process_group()
    mesh = make_mesh((1, 1), ("data", "model"))
    emit("lm_mesh_start", card=card,
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
         backend=dist.get_backend())
    arch = "llama3.2-1b"
    cfg = registry.get_arch(arch).FULL
    runs = {"no_mesh": _KEPT.pop(f"lm_{arch}", None)
            or _lm_mesh_train(arch, None)}
    want = runs["no_mesh"]["losses"]
    for erp in (False, True):
        run = _lm_mesh_train(arch, mesh, explicit_row_parallel=erp)
        run.update(losses_apart=_losses_apart(
            f"lm_mesh {arch} explicit_row_parallel={erp}", run["losses"],
            want), losses_bits_equal=run["losses"] == want[:LM_MESH_STEPS])
        runs[f"mesh_explicit_row_parallel_{erp}"] = run
    emit("lm_mesh", run="train", arch=arch, card=card,
         steps=LM_MESH_STEPS, gathers=_unit_gathers(cfg), **runs)
    arch = "granite-moe-1b-a400m"
    runs = {"dense_oracle": _KEPT.pop(f"lm_{arch}", None)
            or _lm_mesh_train(arch, None)}
    runs["capacity_1.25"] = _lm_mesh_train(arch, mesh)
    _falls(f"lm_mesh {arch} capacity", runs["capacity_1.25"]["losses"])
    lossless = _lm_mesh_train(arch, mesh, capacity_factor=32.0)
    lossless["losses_apart"] = _losses_apart(
        f"lm_mesh {arch} capacity 32", lossless["losses"],
        runs["dense_oracle"]["losses"])
    runs["capacity_32"] = lossless
    emit("lm_mesh", run="train", arch=arch, card=card, steps=LM_MESH_STEPS,
         capacity=registry.get_arch(arch).FULL.capacity_factor, **runs)
    _lm_mesh_decode(mesh, card, "float32", rows=4, prefix=4096)
    _lm_mesh_decode(mesh, card)
    _row_parallel_gemm(card)
    gpu = _lm_mesh_forms(mesh, "cuda")
    emit("lm_mesh_cpu_vs_gpu", card=card, max_abs_err={
        arch: max(_hold_close(f"lm_mesh cpu_vs_gpu {arch}", b, a)
                  for a, b in zip(cpu[arch], gpu[arch])) for arch in cpu},
        tensors={arch: len(v) for arch, v in cpu.items()})
    del cpu, gpu
    _free_card()
    _lm_mesh_multi_card(card, mesh, data)
    dist.destroy_process_group()
    emit("lm_mesh_done", card=card, seconds=time.perf_counter() - t_phase)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# slice 16: the dry run, the roofline, the recsys models on a mesh
# ---------------------------------------------------------------------------

#: The dry run's cells in the smoke, for rank 0 of a fake world of 256 with
#: fake CUDA tensors, and the kernel ops each must meet
DRYRUN_CELLS = {("clax-dbn-baidu", "train_batch"): {"examination_nll",
                                                   "adamw"},
                ("deepfm", "train_batch"): {"embedding_bag",
                                            "fm_interaction", "adamw"},
                ("autoint", "serve_p99"): {"flash_attention"},
                ("graphsage-reddit", "ogb_products"): {"adamw"},
                ("llama3.2-1b", "train_4k"): {"adamw"},
                ("llama3-405b", "decode_32k"): set()}
#: ... and at a world of one, each beside a real step's peak on the card
PEAK_CELLS = (("clax-dbn-baidu", "train_batch"), ("deepfm", "train_batch"))
DRYRUN_TIMEOUT_S = 240
#: the recsys models on a (1, 1) NCCL mesh: steps, and the hold against the
#: run without a mesh (the table gather's index_add_ sums in no fixed
#: order, so not to the bit)
RECSYS_MESH_STEPS, RECSYS_MESH_TOL = 4, 1e-5


def start_dryrun():
    """Start the dry run on the card in two subprocesses (one world each):
    the :data:`DRYRUN_CELLS` over the production mesh's fake world of 256
    and the :data:`PEAK_CELLS` over a fake world of one; returns what
    :func:`phase_dryrun` reads."""
    import tempfile

    out = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for name, cells, jobs in (("pod16x16", list(DRYRUN_CELLS), 3),
                              ("1x1", list(PEAK_CELLS), 1)):
        log = open(os.path.join(out, f"{name}.log"), "w")
        procs.append((name, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
             ",".join(f"{a}:{s}" for a, s in cells), "--mesh", name,
             "--device", "cuda", "--jobs", str(jobs), "--out", out,
             "--timeout", str(DRYRUN_TIMEOUT_S - 10)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)))
    return out, procs, time.perf_counter()


def stop_dryrun(started) -> None:
    """Kill whatever :func:`start_dryrun` started that still runs."""
    for _, log, proc in started[1]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _expected_kernel_bytes(arch, model_rows):
    """kernels/cost.py's bytes for each kernel op a cell meets for rank 0
    of the production mesh (model rows ``model_rows``, data rows 16), from
    the local shapes; None where the smoke does not recompute them."""
    import torch

    from repro_torch.configs import clax_baidu, deepfm

    dp = 16
    if arch == "clax-dbn-baidu":
        rows = B_MAIN // dp
        model = clax_baidu.make_model("dbn", device="meta")
    elif arch == "deepfm":
        rows = B_MAIN // dp
        model = deepfm.make_model(device="meta")
    else:
        return None

    def local(p):
        shape = tuple(p.shape)
        if shape and shape[0] >= 1_000_000:
            shape = (shape[0] // model_rows,) + shape[1:]
        return _meta(*shape)

    params = [local(p) for p in model.parameters() if p.numel()]
    out = {"adamw": sum(cost.adamw(p, p, p, p).bytes for p in params)}
    if arch == "clax-dbn-baidu":
        out["examination_nll"] = cost.examination_nll(
            _meta(rows, K_MAIN), None, None).bytes
    else:
        cfg = model.cfg
        table = _meta(cfg.table_rows // model_rows, 1)
        ids = _meta(rows, cfg.n_sparse, dtype=torch.int32)
        out["embedding_bag"] = cost.embedding_bag(table, ids).bytes
        out["fm_interaction"] = cost.fm_interaction(
            _meta(rows, cfg.n_sparse, cfg.embed_dim)).bytes
    return out


def phase_dryrun(card, started):
    """Slice 16: the dry run on the card (``launch/dryrun.py``, started by
    :func:`start_dryrun` before the holds so that its host work overlaps
    theirs). Each cell must be counted with fake CUDA tensors (a fake
    tensor's ``data_ptr`` raises, so a kernel binding that touched one
    would fail the cell), meet exactly its kernel ops (none launched), each
    op's bytes kernels/cost.py's for its local shapes; one line a cell.
    Returns the world-of-one records' predicted peaks."""
    out, procs, t0 = started
    deadline = t0 + DRYRUN_TIMEOUT_S
    for name, log, proc in procs:
        try:
            rc = proc.wait(max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            with open(log.name) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"dryrun {name}: exit {rc}\n{tail}")
    seconds = time.perf_counter() - t0
    for (arch, shape), kernels in DRYRUN_CELLS.items():
        with open(os.path.join(out, f"{arch}__{shape}__pod16x16.json")) as f:
            rec = json.load(f)
        got = rec["kernel_ops"]
        if rec["device"] != "cuda" or set(got) != kernels:
            raise AssertionError(f"dryrun {arch} {shape}: kernel ops "
                                 f"{sorted(got)} != {sorted(kernels)}")
        want = _expected_kernel_bytes(arch, 16)
        if want is not None:
            for name, per_step in want.items():
                row = got[name]
                count = 1 if name == "adamw" else row["count"]
                if not math.isclose(row["bytes"], per_step * count,
                                    rel_tol=1e-12):
                    raise AssertionError(
                        f"dryrun {arch} {shape}: {name} {row['bytes']} "
                        f"bytes, kernels/cost.py {per_step * count}")
        emit("dryrun", card=card, arch=arch, shape=shape, mesh=rec["mesh"],
             kind=rec["kind"], model_flops=rec["model_flops"],
             flops_per_device=rec["cost"]["flops_per_device"],
             bytes_per_device=rec["cost"]["bytes_accessed_per_device"],
             wire_bytes_per_device=rec["collectives"][
                 "total_wire_bytes_per_device"],
             collective_counts=rec["collectives"]["op_counts"],
             peak_bytes_per_device=rec["memory"]["peak_bytes_per_device"],
             kernel_ops=got, build_seconds=rec["build_seconds"],
             count_seconds=rec["count_seconds"])
    predicted = {}
    for arch, shape in PEAK_CELLS:
        with open(os.path.join(out, f"{arch}__{shape}__1x1.json")) as f:
            predicted[arch] = json.load(f)["memory"]["peak_bytes_per_device"]
    emit("dryrun_done", card=card, seconds=seconds, cells=len(DRYRUN_CELLS),
         world_of_one_predicted_peak_bytes=predicted)
    return predicted


def _roofline_hold(card, data, steps=4):
    """Trainer(emit_roofline=True) on the paper-width DBN, one epoch of
    ``steps`` steps in one chunk, beside the same run without it: one
    ``roofline`` event, in which examination_nll's bytes are its bound's
    16.4 MB a step and adamw's the DBN's parameters' (the two tables' 12.03
    GB); the parameters and losses equal to the bit, the launch counts
    equal."""
    import torch

    from repro_torch.data import ClickLogLoader
    from repro_torch.obs import MemorySink, Recorder
    from repro_torch.train import Trainer

    train = {k: v[:steps * B_MAIN] for k, v in data.items()}
    runs = {}
    for flag in (False, True):
        _free_card()
        model, make_optimizer, sparse, _, _ = _train_spec("dbn")
        sink = MemorySink()
        trainer = Trainer(make_optimizer(), epochs=1, chunk_batches=steps,
                          device="cuda", log_fn=_quiet,
                          recorder=Recorder(sinks=[sink]),
                          emit_roofline=flag, **sparse)
        reset_counts()
        t0 = time.perf_counter()
        history = trainer.train(model, ClickLogLoader(train,
                                                      batch_size=B_MAIN,
                                                      seed=0))
        torch.cuda.synchronize()
        runs[flag] = {"seconds": time.perf_counter() - t0,
                      "launches": read_counts(),
                      "losses": [r["train_loss"] for r in history],
                      "params": [p.detach().clone()
                                 for p in model.parameters()],
                      "events": sink.by_kind("roofline"),
                      "spans": [e for e in sink.by_kind("span")
                                if e["name"] == "roofline"]}
        del model, trainer
    a, b = runs[False], runs[True]
    equal = all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    if not equal or a["losses"] != b["losses"] or \
            a["launches"] != b["launches"]:
        raise AssertionError(f"roofline: the run with it differs: losses "
                             f"{a['losses']} {b['losses']}, launches "
                             f"{a['launches']} {b['launches']}")
    if a["events"] or len(b["events"]) != 1 or len(b["spans"]) != 1:
        raise AssertionError(f"roofline: {len(b['events'])} events, "
                             f"{len(b['spans'])} spans (want 1 each)")
    rf = b["events"][0]["data"]
    exam = rf["kernel_ops"]["examination_nll"]
    adam = rf["kernel_ops"]["adamw"]
    exam_bytes = cost.examination_nll(_meta(B_MAIN, K_MAIN), None,
                                      None).bytes
    params = [_meta(*p.shape) for p in b["params"] if p.numel()]
    adam_bytes = sum(cost.adamw(p, p, p, p).bytes for p in params)
    tables = sum(cost.adamw(p, p, p, p).bytes for p in params
                 if p.dim() and p.shape[0] >= 1_000_000)
    if exam["count"] != steps or exam["bytes"] != steps * exam_bytes or \
            adam["count"] != steps * len(params) or \
            adam["bytes"] != steps * adam_bytes:
        raise AssertionError(f"roofline: kernel ops {rf['kernel_ops']}, "
                             f"want examination_nll {exam_bytes} and adamw "
                             f"{adam_bytes} bytes a step")
    emit("roofline_dbn", card=card, steps=steps, batch=B_MAIN,
         params_bits_equal=True, losses_bits_equal=True,
         launches=b["launches"], roofline=rf,
         examination_nll_bytes_per_step=exam_bytes,
         adamw_bytes_per_step=adam_bytes, adamw_table_bytes_per_step=tables,
         roofline_span_s=b["spans"][0].get("dur"),
         train_seconds={"without": a["seconds"], "with": b["seconds"]})
    del runs
    _free_card()


def _measured_cell_peak(arch, shape, mesh):
    """The peak device memory of one real step of the dry-run cell (real
    tensors on the card, filled with valid values) on ``mesh``, from the
    cell's arguments on: its parameters, state and batch are allocated
    before the count starts, as the dry run's arguments are."""
    import torch

    from repro_torch.configs import registry

    _free_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    cell = registry.build_cell(arch, shape, mesh)
    with torch.no_grad():
        for p in cell.args[0].parameters():
            if p.is_floating_point():
                p.normal_(0.0, 0.02, generator=gen)
        batch = cell.args[2]
        for k, t in batch.items():
            if k == "positions":
                t.copy_(torch.arange(t.shape[-1], device=t.device).expand_as(
                    t))
            elif k == "mask":
                t.fill_(True)
            elif k in ("clicks", "labels"):
                t.copy_(torch.rand(t.shape, generator=gen, device=t.device)
                        < 0.3)
            elif k == "field_ids":
                t.random_(0, 80_000_000, generator=gen)
            else:
                t.random_(0, 2 ** 31 - 1, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cell.fn(*cell.args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del cell, batch
    _free_card()
    return peak


def _recsys_mesh_hold(card, predicted):
    """DeepFM and BST at their published widths on a (1, 1) NCCL mesh
    (``place_``, ``make_train_step(mesh=)``), RECSYS_MESH_STEPS steps
    against the same steps without a mesh from the same weights: losses
    and parameters within RECSYS_MESH_TOL, and the embedding_bag and
    flash_attention launches equal. Then the :data:`PEAK_CELLS`' real
    steps on that mesh, their peaks beside the dry run's prediction (told,
    not held)."""
    import torch

    from repro_torch.configs.recsys_common import SHAPES
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"))
    rows = SHAPES["train_batch"]["batch"]
    # index_add_'s atomics sum an id's repeats in no fixed order,
    # and Adam turns a last-bit difference in a near-zero row gradient into
    # a step's difference (1.9e-4 after 4 steps in this hold's first run):
    # the runs take index_add_'s sorted, deterministic path.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _recsys_mesh_runs(card, mesh, rows)
    finally:
        torch.use_deterministic_algorithms(False)
    peaks = {}
    for arch, shape in PEAK_CELLS:
        peaks[arch] = {"measured_bytes": _measured_cell_peak(arch, shape,
                                                             mesh),
                       "predicted_bytes": predicted.get(arch)}
    emit("dryrun_peak", card=card, world="1x1 (NCCL)", cells=peaks)
    torch.distributed.destroy_process_group()


def _recsys_mesh_runs(card, mesh, rows):
    """The runs of :func:`_recsys_mesh_hold`: DeepFM and BST with and
    without ``mesh``."""
    import torch

    from repro_torch import optim

    for arch in ("deepfm", "bst"):
        log = _log(arch, torch.device("cuda"), seed=4)
        batches = [log.batch(rows) for _ in range(RECSYS_MESH_STEPS)]
        runs = {}
        for name in ("no_mesh", "mesh"):
            _free_card()
            model = _config(arch).make_model(device="cuda", seed=0)
            m = None
            if name == "mesh":
                model.place_(mesh)
                m = mesh
            step = model.make_train_step(optim.adamw(1e-3), m)
            state = step.init()
            reset_counts()
            losses = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches:
                state, loss = step(state, batch)
                losses.append(loss)
            torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "launches": read_counts(),
                          "losses": [float(x) for x in losses],
                          "params": [p.detach().clone()
                                     for p in model.parameters()]}
            del model, step, state
        a, b = runs["no_mesh"], runs["mesh"]
        worst = max(float((x - y).abs().max())
                    for x, y in zip(a["params"], b["params"]))
        loss_gap = max(abs(x - y) for x, y in zip(a["losses"],
                                                  b["losses"]))
        kernels = ("embedding_bag", "flash_attention", "fm_interaction",
                   "adamw")
        if worst > RECSYS_MESH_TOL or loss_gap > RECSYS_MESH_TOL or any(
                a["launches"][k] != b["launches"][k] for k in kernels):
            raise AssertionError(f"recsys_mesh {arch}: parameters "
                                 f"{worst}, losses {loss_gap} apart; "
                                 f"launches {a['launches']} "
                                 f"{b['launches']}")
        emit("recsys_mesh", card=card, arch=arch, steps=RECSYS_MESH_STEPS,
             batch=rows, max_abs_param_diff=worst, max_loss_diff=loss_gap,
             tol=RECSYS_MESH_TOL, launches=b["launches"],
             losses=b["losses"],
             ms_per_step={k: r["seconds"] / RECSYS_MESH_STEPS * 1e3
                          for k, r in runs.items()},
             deterministic_algorithms=True)
        del runs, batches, log


def phase_slice16(card, data, started=None):
    """Slice 16, after every earlier path: the dry run (``started`` by
    :func:`start_dryrun` earlier, else here, in subprocesses whose host
    work overlaps other phases), the roofline hold and the recsys models on
    a mesh; the dry run's prediction of the world-of-one peaks beside the
    real steps'."""
    t0 = time.perf_counter()
    if started is None:
        started = start_dryrun()
    try:
        _roofline_hold(card, data)
        predicted = phase_dryrun(card, started)
    finally:  # a failed hold leaves no dry-run process behind
        stop_dryrun(started)
    _recsys_mesh_hold(card, predicted)
    emit("slice16_done", card=card, seconds=time.perf_counter() - t0)


def _after_lm(smi, data, dryrun) -> None:
    """The phases after the LM family's."""
    # Slice 14, after every earlier path: a world of one under NCCL, and
    # a world over every card where there are several.
    phase_distrib(smi, data)
    # Slice 15, after every earlier path: the LM family's sharded forms on
    # a mesh (and, with several cards, a world over all of them).
    phase_lm_mesh(smi, data)
    # Slice 16, after every earlier path: the dry run (started before the
    # LM phase), the roofline and the recsys models on a mesh.
    phase_slice16(smi, data, dryrun)


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
    # The serving engine, after every earlier path.
    phase_serve_engine(smi)
    # Slice 12, after every earlier path: the conformance sweep forward and
    # backward, then BST and MIND at their published widths.
    conformance = phase_conformance(smi)
    bst_serve, bst = phase_recsys("bst", smi)
    phase_recsys("mind", smi)
    # Slice 13, after every earlier path: adamw over bfloat16 parameters,
    # then GraphSAGE and the LM family at their published widths.
    kernels.update(phase_adamw_bf16(smi))
    phase_gnn(smi)
    # slice 16's dry run is host work in subprocesses: it runs beside the
    # LM phase, whose steps keep the card busy, and is read at the end
    dryrun = start_dryrun()
    try:
        lm = phase_lm(smi)
        phase_grouped_mm(smi)
        _after_lm(smi, data, dryrun)
    finally:
        stop_dryrun(dryrun)
    del data
    # Each kernel's launches in the training run of its path; BST's
    # retrieval bag in its serve phase.
    for name, counts in (("examination_nll", dbn), ("session_nll", dctr),
                         ("embedding_bag", deepfm[1]),
                         ("fm_interaction", deepfm[1]),
                         ("flash_attention", autoint[1]),
                         ("dcn_cross", two_tower),
                         ("adamw", dbn), ("sparse_adamw", dbn)):
        kernels[name]["launches"] = counts[name]
    kernels["flash_attention_bst"]["launches"] = bst["flash_attention"]
    kernels["embedding_bag_bst_b1"]["launches"] = bst_serve["embedding_bag"]
    kernels["adamw_bf16"]["launches"] = lm["adamw"]  # llama3.2-1b's train
    for name, row in conformance.items():
        kernels[name]["conformance"] = row
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
