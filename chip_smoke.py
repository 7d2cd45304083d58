#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device      the card's name, count, power limit (nvidia-smi).
2. build       nvcc builds the CUDA kernel into src/repro_torch/kernels/build/.
3. kernels     each hand-written kernel against its plain PyTorch version on
               the card, at the main-path shape (65,536 x 10) and at edge
               shapes; times of kernel, plain version, library call.
4. train_dbn   the paper-width DBN (2 x 214,748,672 hashed rows, batch
               65,536, AdamW 3e-3) takes 16 steps through the Trainer; the
               examination_nll kernel must be launched 16 times and a fixed
               held-out batch's loss must fall.
5. train_dctr  the same for DCTR, 8 steps, through the session_nll kernel.
6. cpu_vs_gpu  small DBN and DCTR batches: CPU (plain versions) and GPU
               (kernels) agree on loss and every gradient.

Then the kernel summary line, the card's name and power limit as nvidia-smi
prints them, and the final status line. Any mismatch raises, and the script
exits non-zero; it exits non-zero without a result when no GPU is visible.
It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
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


def phase_build():
    from repro_torch.kernels import build

    info = build.build("examination_nll")
    emit("build", kernel="examination_nll", seconds=info.seconds,
         library=os.path.relpath(info.path, ROOT),
         ptxas=[line for line in info.log.splitlines()
                if "registers" in line or "spill" in line])


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
    return results


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


def phase_train(kind, data, steps, card):
    import torch

    from repro_torch import optim
    from repro_torch.configs.clax_baidu import TRAIN_BATCH, make_model
    from repro_torch.data import ClickLogLoader, DevicePrefetcher
    from repro_torch.kernels import examination_nll_cuda, session_nll_triton
    from repro_torch.train import Trainer

    train = {k: v[:steps * TRAIN_BATCH] for k, v in data.items()}
    held_lo = len(data["clicks"]) - TRAIN_BATCH
    held_out = _device_batch(data, held_lo, held_lo + TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    model = make_model(kind, device="cuda")
    with torch.no_grad():
        loss_before = float(model.compute_loss(held_out))
    trainer = Trainer(optim.adamw(3e-3, weight_decay=1e-4), epochs=1,
                      chunk_batches=4, device="cuda", log_fn=lambda s: None)
    loader = ClickLogLoader(train, batch_size=TRAIN_BATCH, seed=0)

    examination_nll_cuda.launches = 0
    session_nll_triton.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = trainer.train(model, loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"examination_nll": examination_nll_cuda.launches,
                "session_nll": session_nll_triton.launches}

    expected = {"dbn": {"examination_nll": steps, "session_nll": 0},
                "dctr": {"examination_nll": 0, "session_nll": steps}}[kind]
    if launches != expected:
        raise AssertionError(f"{kind}: launches {launches} != {expected}")
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
    metrics = trainer.evaluate(model, held_loader)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{kind}: non-finite held-out metrics {metrics}")
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
    breakdown = _step_breakdown(model, optim.adamw(3e-3, weight_decay=1e-4),
                                held_out)
    chunk_timing = _enqueue_ms(model, optim.adamw(3e-3, weight_decay=1e-4),
                               held_out)
    emit(f"train_{kind}", card=card, steps=steps, batch=TRAIN_BATCH,
         params=model.n_params(), seconds=seconds,
         steps_per_s=steps / seconds,
         sessions_per_s=steps * TRAIN_BATCH / seconds,
         warm_seconds=warm_seconds, warm_steps_per_s=steps / warm_seconds,
         warm_sessions_per_s=steps * TRAIN_BATCH / warm_seconds,
         input_seconds=input_seconds,
         max_memory_allocated=peak, launches=launches,
         train_loss=train_loss, held_out_loss_before=loss_before,
         held_out_loss_after=loss_after, held_out_metrics=metrics,
         step_breakdown_ms=breakdown, chunk_timing=chunk_timing)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_cpu_vs_gpu(data):
    import numpy as np
    import torch

    from repro_torch.convert import export_params, load_jax_params
    from repro_torch.core import (Compression, DocumentCTR,
                                  DynamicBayesianNetwork,
                                  EmbeddingParameterConfig)
    from repro_torch.kernels import examination_nll_cuda, session_nll_triton

    cfg = EmbeddingParameterConfig(
        parameters=4000, compression=Compression.HASH, compression_ratio=2.0,
        baseline_correction=True, init_logit=-2.0)
    rows = {k: v[:512] for k, v in data.items()}
    out = {}
    for kind, cls, counter in (
            ("dbn", DynamicBayesianNetwork, examination_nll_cuda),
            ("dctr", DocumentCTR, session_nll_triton)):
        kw = dict(positions=K_MAIN, attraction=cfg)
        if kind == "dbn":
            kw["satisfaction"] = cfg
        cpu = cls(device="cpu", **kw)
        rng = np.random.default_rng(1)
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(torch.from_numpy(
                    rng.normal(scale=0.5, size=tuple(p.shape)).astype(
                        np.float32)))
        gpu = cls(device="cuda", **kw)
        load_jax_params(gpu, export_params(cpu))
        before = counter.launches
        losses = []
        for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
            loss = model.compute_loss(batch)
            loss.backward()
            losses.append(float(loss.detach()))
        if counter.launches != before + 1:
            raise AssertionError(f"{kind}: the GPU loss did not launch its "
                                 "kernel")
        check_close(f"cpu_vs_gpu {kind} loss", losses[1], losses[0],
                    rtol=1e-5, atol=1e-5)
        worst = 0.0
        for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
            torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=1e-5,
                                       atol=1e-5, msg=lambda m: f"{kind} "
                                       f"{name}: {m}")
            worst = max(worst, float((pg.grad.cpu() - pc.grad).abs().max()))
        out[kind] = {"loss_cpu": losses[0], "loss_gpu": losses[1],
                     "max_grad_abs_err": worst}
    emit("cpu_vs_gpu", **out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    kernels = phase_kernels(smi)
    data = _synthetic_log(17 * B_MAIN)  # 16 training batches + 1 held out
    dbn = phase_train("dbn", data, 16, smi)
    dctr = phase_train("dctr", data, 8, smi)
    phase_cpu_vs_gpu(data)
    kernels["examination_nll"]["launches"] = dbn["examination_nll"]
    kernels["session_nll"]["launches"] = dctr["session_nll"]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
