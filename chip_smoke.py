#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device         the card's name, count, power limit (nvidia-smi).
2. build          nvcc builds every CUDA source (examination_nll,
                  embedding_bag, flash_attention, dcn_cross) at once into
                  src/repro_torch/kernels/build/, with ptxas's registers
                  and spill bytes for every kernel entry (flash_attention's
                  attention_rows_kernel and attention_tiles_kernel
                  instances among them).
   profile        torch.profiler's device kernels, one line each, of one
                  examination_nll_cuda call at 65,536 x 10 and of DeepFM's
                  first-order bag_lookup at its main shape.
3. kernels        each hand-written kernel against its plain PyTorch
                  version on the card, at its main-path shape and at edge
                  shapes; times of kernel, plain version, library call, and
                  the bound. The loss kernels at 65,536 x 10, and for
                  examination_nll repeated calls, two batches back to back
                  and a graph replay equal to the bit, one device kernel
                  per call in the profiler, its launch plan's rows per
                  block beside their neighbours and two yardsticks (a
                  torch.sum over the same bytes, a one-float launch);
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
                  conformance and sweep shapes, (65,536, 1024) and bf16.
4. train_dbn      the paper-width DBN (2 x 214,748,672 hashed rows, batch
                  65,536, AdamW 3e-3) takes 16 steps through the Trainer;
                  the examination_nll kernel must be launched 16 times and a
                  fixed held-out batch's loss must fall.
5. train_dctr     the same for DCTR, 8 steps, through session_nll.
6. train_ubm      the paper-width UBM (214,748,672 hashed rows), 8 steps;
                  no kernel; its test pass runs ubm_marginal_clicks at
                  65,536 x 10 x 10, held to predict_clicks_loop.
7. cpu_vs_gpu     small DBN, DCTR, CM, UBM, two-tower PBM and DCTR and a
                  mixture with a shared tower: CPU (plain versions) and GPU
                  (kernels) agree on loss and every gradient.
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
                  a synthetic Criteo-shaped log; the held-out loss must fall.
11. serve_autoint, train_autoint   the same for AutoInt: three
                  flash_attention launches per forward.
12. cpu_vs_gpu_recsys   the reduced DeepFM and AutoInt: CPU (plain) and GPU
                  (kernels) agree on loss and every gradient.

Every phase that drives a path sets every kernel's launch count to 0 just
before it and reads the counts just after; they must be exact. A control
line holds the device times of the kernels this slice left untouched
beside the last run before it. Then the kernel summary line, the card's
name and power limit as nvidia-smi prints them, and the final status
line. Any mismatch raises, and the script exits
non-zero; it exits non-zero without a result when no GPU is visible. It
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

B_MAIN, K_MAIN = 65536, 10
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores. Both kernels are float32 elementwise work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Operations per (B, K) element, counted from the kernel sources (compares,
# selects, adds, multiplies, divides and transcendentals each count one).
OPS_PER_ELEMENT = {"examination_nll": 44, "session_nll": 18}
BYTES_PER_ELEMENT = {"examination_nll": 6 * 4 + 1, "session_nll": 2 * 4 + 1}
RTOL, ATOL = 1e-5, 1e-6
# Device ms of the kernels this slice leaves untouched, from the last run
# before it (PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700.00 W).
CONTROL_DEVICE_MS = {"session_nll": 0.0106, "fm_interaction": 0.0439,
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
            "session_nll": k.session_nll_triton,
            "embedding_bag": k.embedding_bag_cuda,
            "fm_interaction": k.fm_interaction_triton,
            "flash_attention": k.flash_attention_cuda,
            "dcn_cross": k.dcn_cross_cuda}


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
    loss, skip runs whose odds saturate."""
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
                                     examination_nll_plain,
                                     session_nll_plain, session_nll_triton)

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    specs = [
        ("examination_nll", examination_nll_cuda, examination_nll_plain,
         None, exam_inputs, "cuda",
         "src/repro_torch/kernels/csrc/examination_nll.cu",
         "src/repro/kernels/examination_nll.py:48"),
        ("session_nll", session_nll_triton, session_nll_plain,
         lambda x, c, m: torch.nn.functional.binary_cross_entropy_with_logits(
             x, c, weight=m.float(), reduction="sum")
         / m.float().sum().clamp_min(1.0),
         session_inputs, "triton",
         "src/repro_torch/kernels/session_nll.py",
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
        if name == "examination_nll":
            results[name].update(exam_forms(args, make, gen, device, card))
    return results


def exam_forms(args, make, gen, device, card):
    """examination_nll's single-launch design: repeated calls give the same
    bits, two batches back to back each their own loss (the last block's
    ticket is reset), a CUDA-graph replay the eager call's bits, one device
    kernel per call in the profiler and one count per call; launch_plan's
    rows per block beside its neighbours (device ms) and each edge case's
    plan."""
    import torch

    from repro_torch.kernels import examination_nll_cuda, examination_nll_plain
    from repro_torch.kernels.examination_nll import launch_plan

    first = examination_nll_cuda(*args)
    repeats = [examination_nll_cuda(*args) for _ in range(10)]
    if not all(bool(torch.equal(r, first)) for r in repeats):
        raise AssertionError("examination_nll: repeated calls differ "
                             f"{[float(r) for r in repeats]}")
    other = make(gen, B_MAIN, K_MAIN, device)
    pair = [examination_nll_cuda(*other), examination_nll_cuda(*args),
            examination_nll_cuda(*other)]
    check_close("examination_nll other batch", pair[0],
                examination_nll_plain(*other))
    if not (torch.equal(pair[1], first) and torch.equal(pair[2], pair[0])):
        raise AssertionError("examination_nll: back-to-back batches differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        examination_nll_cuda(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = examination_nll_cuda(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(captured, first):
            raise AssertionError(f"examination_nll: graph replay "
                                 f"{float(captured)} != eager "
                                 f"{float(first)}")
    del graph
    before = examination_nll_cuda.launches
    lines, total = profile_kernels(lambda: examination_nll_cuda(*args))
    counted = examination_nll_cuda.launches - before
    if total["launches_per_call"] != 1.0 or counted != 23:  # 3 warm + 20
        raise AssertionError(f"examination_nll: {lines} device kernels, "
                             f"{counted} counted launches for 23 calls")
    sweep = {}
    for rows_per_block in (None, 32, 64, 128, 256):
        plan = launch_plan(B_MAIN, K_MAIN, rows_per_block)
        key = f"R{plan.rows_per_block}" + ("_default"
                                           if rows_per_block is None else "")
        sweep[key] = graph_ms(lambda: examination_nll_cuda(*args, plan=plan))
    # Yardsticks of what holds it: one torch.sum over as many bytes as the
    # kernel reads (a single-launch read of 16.4 MB), and a launch that
    # does nothing but add 1 to one float (the replay's launch floor).
    nbytes = sum(t.numel() * t.element_size() for t in args)
    buf = torch.ones(nbytes // 4, device=device)
    tiny = torch.zeros(1, device=device)
    yardsticks = {"sum_same_bytes_device_ms": graph_ms(lambda: torch.sum(buf)),
                  "one_float_add_device_ms": graph_ms(lambda: tiny.add_(1.0)),
                  "bytes": nbytes}
    del buf, tiny
    plans = {case: launch_plan(*case_args[0].shape)._asdict()
             for case, case_args in edge_cases(
                 "examination_nll", make, gen, device).items()}
    forms = {"plan": launch_plan(B_MAIN, K_MAIN)._asdict(),
             "repeat_bits_equal": True, "graph_replay_bits_equal": True,
             "back_to_back_batches": [float(x) for x in pair],
             "profile_kernels_per_call": total["launches_per_call"],
             "profile_device_us_per_call": total["device_us_per_call"],
             "plan_sweep_device_ms": sweep, "yardsticks": yardsticks}
    emit("kernel_forms", name="examination_nll", card=card,
         shape=[B_MAIN, K_MAIN], edge_plans=plans, **forms)
    return forms


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


def phase_profile(card):
    """The profiler's breakdown, one line per device kernel, of one
    examination_nll_cuda call at 65,536 x 10 and of DeepFM's first-order
    term, bag_lookup over the real (80,000,000, 1) table with 65,536 bags
    of 39 Zipf ids, as the model calls it."""
    import torch

    from repro_torch.kernels import examination_nll_cuda
    from repro_torch.models.recsys.embedding import TableConfig, bag_lookup

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    exam = exam_inputs(gen, B_MAIN, K_MAIN, device)
    log = CriteoLog(device, seed=1)
    cfg = TableConfig(TABLE_ROWS, 1)
    params = {"table": torch.randn(TABLE_ROWS, 1, generator=gen,
                                   device=device)}
    ids = log.field_ids(B_MAIN)
    del log
    out = {}
    for what, fn in (("examination_nll_cuda", lambda: examination_nll_cuda(
                          *exam)),
                     ("bag_lookup", lambda: bag_lookup(cfg, params, ids))):
        lines, total = profile_kernels(fn)
        for line in lines:
            emit("profile", call=what, card=card, **line)
        out[what] = {**total, "call_ms": time_ms(fn, iters=200),
                     "graph_device_ms": graph_ms(fn)}
        emit("profile_total", call=what, card=card, **out[what])
    del exam, params, ids
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


def _step_breakdown(model, optimizer, batch, reps=3):
    """Host-clock ms of forward, backward and AdamW update of one step,
    each closed by a synchronize (taken after the counted run)."""
    import torch

    from repro_torch import optim

    params = list(model.parameters())
    state = optimizer.init(params)
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
        updates, state = optimizer.update([p.grad for p in params], state,
                                          params)
        optim.apply_updates(params, updates)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for p in params:
            p.grad = None
        parts["forward_ms"].append((t1 - t0) * 1e3)
        parts["backward_ms"].append((t2 - t1) * 1e3)
        parts["optimizer_ms"].append((t3 - t2) * 1e3)
    return {k: min(v) for k, v in parts.items()}


def _enqueue_ms(model, optimizer, batch, n=4, reps=2):
    """(host ms to enqueue one n-step engine chunk, ms until the device has
    run it): equal numbers mean the host cannot run ahead of the device."""
    import torch

    from repro_torch.train import TrainEngine

    engine = TrainEngine(model, optimizer, chunk_batches=n)
    state = engine.init_opt_state()
    chunk = {k: v.expand(n, *v.shape).contiguous() for k, v in batch.items()}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = engine.step(state, chunk)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return {"enqueue_ms": (t1 - t0) * 1e3, "run_ms": (t2 - t0) * 1e3,
            "steps": n}


def _train_spec(kind):
    """(model, optimizer factory, launches per step, dcn_cross launches per
    forward) of a training path: the paper-width ``dbn``, ``dctr`` and
    ``ubm``, and the Listing-4 pair ``two_tower_pbm`` / ``two_tower_dctr``."""
    from repro_torch import optim
    from repro_torch.configs.clax_baidu import make_model, make_two_tower

    if kind.startswith("two_tower_"):
        twin = kind[len("two_tower_"):]
        per_step = {"dcn_cross": 2}
        if twin == "dctr":
            per_step["session_nll"] = 1
        return (make_two_tower(twin, device="cuda"),
                lambda: optim.adamw(1e-2), per_step, 2)
    per_step = {"dbn": {"examination_nll": 1}, "dctr": {"session_nll": 1},
                "ubm": {}}[kind]
    return (make_model(kind, device="cuda"),
            lambda: optim.adamw(3e-3, weight_decay=1e-4), per_step, 0)


def phase_train(kind, data, steps, card, extra=None):
    """``steps`` optimizer steps through the Trainer on ``data``'s first
    batches, the last batch held out; exact launch counts in the counted
    epoch and in the held-out evaluation (two forwards per batch: the
    marginal and the conditional click predictions). ``extra(model,
    held_out)`` adds path-specific checks and numbers to the phase's line."""
    import torch

    from repro_torch.configs.clax_baidu import TRAIN_BATCH
    from repro_torch.data import ClickLogLoader, DevicePrefetcher
    from repro_torch.train import Trainer

    train = {k: v[:steps * TRAIN_BATCH] for k, v in data.items()}
    held_lo = len(data["clicks"]) - TRAIN_BATCH
    held_out = _device_batch(data, held_lo, held_lo + TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    model, make_optimizer, per_step, per_forward = _train_spec(kind)
    with torch.no_grad():
        loss_before = float(model.compute_loss(held_out))
    trainer = Trainer(make_optimizer(), epochs=1, chunk_batches=4,
                      device="cuda", log_fn=lambda s: None)
    loader = ClickLogLoader(train, batch_size=TRAIN_BATCH, seed=0)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.train(model, loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check_counts(f"train_{kind}", {
        k: n * steps for k, n in per_step.items()})
    train_loss = history[-1]["train_loss"]
    if not math.isfinite(train_loss):
        raise AssertionError(f"{kind}: non-finite train loss {train_loss}")
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        loss_after = float(model.compute_loss(held_out))
    if not loss_after < loss_before:
        raise AssertionError(f"{kind}: held-out loss {loss_before} -> "
                             f"{loss_after} did not fall")
    held_loader = ClickLogLoader({k: v[held_lo:] for k, v in data.items()},
                                 batch_size=TRAIN_BATCH, shuffle=False,
                                 drop_last=False)
    reset_counts()
    metrics = trainer.evaluate(model, held_loader)
    eval_launches = check_counts(f"evaluate_{kind}", {
        "dcn_cross": 2 * per_forward} if per_forward else {})
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{kind}: non-finite held-out metrics {metrics}")
    found = extra(model, held_out) if extra is not None else {}
    # A second epoch, after the counted run: the first one also pays the
    # process's one-time costs (lazy kernel loading, allocator growth).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(model, loader)
    torch.cuda.synchronize()
    warm_seconds = time.perf_counter() - t0
    # The input path alone: the same epoch's batches through the loader and
    # the prefetcher's pinned host-to-device copies, with no training.
    t0 = time.perf_counter()
    for _ in DevicePrefetcher(loader, device="cuda", chunk_batches=4):
        pass
    torch.cuda.synchronize()
    input_seconds = time.perf_counter() - t0
    breakdown = _step_breakdown(model, make_optimizer(), held_out)
    chunk_timing = _enqueue_ms(model, make_optimizer(), held_out)
    emit(f"train_{kind}", card=card, steps=steps, batch=TRAIN_BATCH,
         params=model.n_params(), seconds=seconds,
         steps_per_s=steps / seconds,
         sessions_per_s=steps * TRAIN_BATCH / seconds,
         warm_seconds=warm_seconds, warm_steps_per_s=steps / warm_seconds,
         warm_step_ms=warm_seconds / steps * 1e3,
         warm_sessions_per_s=steps * TRAIN_BATCH / warm_seconds,
         input_seconds=input_seconds,
         max_memory_allocated=peak, launches=launches,
         eval_launches=eval_launches,
         train_loss=train_loss, held_out_loss_before=loss_before,
         held_out_loss_after=loss_after, held_out_metrics=metrics,
         step_breakdown_ms=breakdown, chunk_timing=chunk_timing, **found)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
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
    exactly its path's kernels. Small hashed-table DBN, DCTR, CM and UBM on
    the DBN log; the reduced two-tower PBM and DCTR (8 features) and a
    mixture of PBM, DCTR and GCTR sharing one tower on a feature batch."""
    import numpy as np
    import torch

    from repro_torch.configs.clax_baidu import make_two_tower
    from repro_torch.convert import export_params, load_jax_params
    from repro_torch.core import (CascadeModel, Compression, DocumentCTR,
                                  DynamicBayesianNetwork,
                                  EmbeddingParameterConfig, GlobalCTR,
                                  MixtureModel, UserBrowsingModel)

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
    """Host-clock ms of forward, backward and AdamW update of one step,
    each closed by a synchronize (taken after the counted run)."""
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
        updates, state = optimizer.update(list(grads), state, params)
        optim.apply_updates(params, updates)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del grads, updates
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
        k: n * steps for k, n in per_forward(model).items()})
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
    # The four kernels this run's redesigns left untouched, as the
    # run-to-run control: their device ms beside the last run before it.
    emit("control", card=smi, device_ms={
        name: kernels[name]["device_ms"]["kernel"]
        for name in ("session_nll", "fm_interaction", "flash_attention",
                     "dcn_cross")}, earlier_device_ms=CONTROL_DEVICE_MS)
    data = _synthetic_log(17 * B_MAIN)  # 16 training batches + 1 held out
    dbn = phase_train("dbn", data, 16, smi)
    dctr = phase_train("dctr", data, 8, smi)
    phase_train("ubm", data, 8, smi, extra=ubm_marginal_check)
    phase_cpu_vs_gpu(data)
    del data
    tower_data, truth = _two_tower_log(9 * B_MAIN)  # 8 batches + 1 held out
    two_tower = phase_train_two_tower("pbm", tower_data, truth, 8, smi)
    phase_train_two_tower("dctr", tower_data, truth, 8, smi)
    del tower_data
    deepfm = phase_recsys("deepfm", smi)
    autoint = phase_recsys("autoint", smi)
    phase_recsys_cpu_vs_gpu()
    # Each kernel's launches in the training run of its path.
    for name, counts in (("examination_nll", dbn), ("session_nll", dctr),
                         ("embedding_bag", deepfm),
                         ("fm_interaction", deepfm),
                         ("flash_attention", autoint),
                         ("dcn_cross", two_tower)):
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
