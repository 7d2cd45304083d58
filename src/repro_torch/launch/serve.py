"""Resilient click-prediction serving launcher (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --model pbm \\
        [--models pbm,dbn,dctr] [--ckpt-dir ckpts/pbm] [--requests 200] \\
        [--qps 200] [--deadline-ms 50] [--virtual-time] \\
        [--fault-slow-model pbm --fault-slow-fail --fault-slow-at 0:8] \\
        [--fault-poison-every 17] [--fault-sigterm-at 150] [--device cpu]

Builds a warm multi-model registry (on the card, one CUDA graph per model
x tier x bucket captured before the first request), then serves a seeded
Poisson arrival trace through the full resilience stack: bounded
admission queue with load shedding, deadline-aware bucket batcher,
per-model circuit breakers over the primary -> int8 -> prior degradation
ladder, fail-closed request validation, and SIGTERM drain. Fault flags
inject the chaos-drill failures (slow/failing model, poisoned requests,
mid-flight SIGTERM); ``--virtual-time`` runs the same drill on the
simulated clock so its counters are bit-deterministic. Telemetry
(per-request latency metrics, dispatch spans, breaker events, final
``serve_summary``) rides the standard Recorder sinks. ``--ckpt-dir``
restores a checkpoint written by either package's ``CheckpointManager``.
Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import obs
from repro_torch.convert import export_params
from repro_torch.core import (MODEL_REGISTRY, Compression,
                              EmbeddingParameterConfig)
from repro_torch.serve import (AdmissionQueue, ModelRegistry, ServeEngine,
                               ServiceModel, VirtualClock, WallClock,
                               poisson_trace)
from repro_torch.testing import PoisonTrace, ServeKillSwitch, SlowModel
from repro_torch.train import CheckpointManager


def _parse_ints(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def _parse_span(text):
    """"a:b" -> range(a, b); "a,b,c" -> those indices; None -> None."""
    if text is None:
        return None
    if ":" in text:
        lo, hi = text.split(":")
        return range(int(lo), int(hi))
    return _parse_ints(text)


def build_registry(args, log_fn=print) -> ModelRegistry:
    names = ([m for m in args.models.split(",") if m]
             if args.models else [args.model])
    buckets = (_parse_ints(args.buckets) if args.buckets
               else tuple(b for b in (1, 4, 16, 64, 256)
                          if b <= args.batch) + (args.batch,))
    buckets = tuple(sorted(set(buckets)))
    service_model = ServiceModel() if args.virtual_time else None
    registry = ModelRegistry(buckets=buckets, service_model=service_model)
    for name in names:
        attraction = EmbeddingParameterConfig(
            parameters=args.pairs, compression=Compression.HASH,
            compression_ratio=10.0, baseline_correction=True,
            init_logit=-2.0)
        # the tables and scalars start at JAX's init constants
        model = MODEL_REGISTRY[name](query_doc_pairs=args.pairs,
                                     positions=args.positions,
                                     attraction=attraction,
                                     device=args.device)
        params = None
        if args.ckpt_dir and len(names) == 1:
            ckpt = CheckpointManager(args.ckpt_dir)
            if ckpt.latest_step() is not None:
                tree, _, step = ckpt.restore(
                    like={"params": export_params(model)})
                params = tree["params"]
                log_fn(f"[serve] restored {name} step {step} "
                       f"from {args.ckpt_dir}")
        registry.add(name, model, params, n_pairs=args.pairs)
    return registry


def build_faults(args):
    faults = []
    if args.fault_slow_model:
        faults.append(SlowModel(
            model=args.fault_slow_model,
            delay_seconds=args.fault_slow_delay_ms * 1e-3,
            at_dispatches=_parse_span(args.fault_slow_at),
            fail=args.fault_slow_fail))
    if args.fault_sigterm_at is not None:
        faults.append(ServeKillSwitch(at_request=args.fault_sigterm_at))
    return faults


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="dbn", choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--models", default=None,
                    help="comma-separated list served by one process "
                         "(overrides --model)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--batch", type=int, default=512,
                    help="largest batching bucket")
    ap.add_argument("--positions", type=int, default=10)
    ap.add_argument("--buckets", default=None,
                    help="explicit comma-separated bucket sizes")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="Poisson arrival rate of the request trace")
    ap.add_argument("--deadline-ms", type=float, default=200.0)
    ap.add_argument("--queue-capacity", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--virtual-time", action="store_true",
                    help="simulated clock + modeled service times: "
                         "bit-deterministic counters (chaos drills)")
    ap.add_argument("--force-tier", default=None,
                    choices=["primary", "int8", "prior"])
    ap.add_argument("--fault-slow-model", default=None,
                    help="inject latency/failures into this model")
    ap.add_argument("--fault-slow-delay-ms", type=float, default=50.0)
    ap.add_argument("--fault-slow-at", default=None,
                    help="dispatch indices to hit: 'a:b' or 'i,j,k' "
                         "(default: every dispatch)")
    ap.add_argument("--fault-slow-fail", action="store_true",
                    help="raise instead of delaying (breaker trips)")
    ap.add_argument("--fault-poison-every", type=int, default=None,
                    help="poison every Nth request (validator drill)")
    ap.add_argument("--fault-sigterm-at", type=int, default=None,
                    help="SIGTERM this process when request N is admitted")
    ap.add_argument("--metrics-out", default=None,
                    help="write per-request latency metric events and the "
                         "final serve summary as JSONL telemetry")
    ap.add_argument("--trace-out", default=None,
                    help="export the span ring (per-dispatch serve_batch "
                         "spans and any detail spans, such as serve_bulk's "
                         "and param.lookup's) and the counters as "
                         "Chrome-trace JSON (Perfetto); the ring keeps the "
                         "newest 8192 spans, so its capacity bounds how far "
                         "back the detail spans reach")
    ap.add_argument("--summary-out", default=None,
                    help="write the final summary (plus health and "
                         "counters) as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    args = ap.parse_args(argv)

    recorder = obs.get_recorder()
    if args.metrics_out:
        recorder = obs.configure(sinks=[obs.JsonlSink(args.metrics_out)])

    registry = build_registry(args)
    with recorder.span("serve_warmup", buckets=str(registry.buckets)):
        registry.warmup(log_fn=print)

    models = list(registry.entries)
    trace = poisson_trace(args.requests, qps=args.qps, models=models,
                          positions_k=args.positions, n_pairs=args.pairs,
                          deadline_s=args.deadline_ms * 1e-3,
                          seed=args.seed)
    if args.fault_poison_every:
        trace = PoisonTrace(trace,
                            at=range(args.fault_poison_every - 1,
                                     args.requests,
                                     args.fault_poison_every),
                            seed=args.seed)

    clock = VirtualClock() if args.virtual_time else WallClock()
    engine = ServeEngine(
        registry,
        queue=AdmissionQueue(capacity=args.queue_capacity),
        clock=clock, recorder=recorder, faults=build_faults(args),
        force_tier=args.force_tier, log_fn=print)
    results = engine.run_trace(trace)

    summary = engine.summary(results)
    recorder.event("serve_summary", data=summary)
    recorder.flush_counters()
    if args.trace_out:
        n_events = recorder.export_chrome_trace(args.trace_out)
        print(f"[serve] {n_events} events -> {args.trace_out}")
    recorder.close()
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump({"summary": summary, "health": engine.health(),
                       "counters": dict(sorted(engine.stats.items()))},
                      f, indent=2, default=str)
    print(f"[serve] {summary['requests']} requests: "
          f"answered={summary['answered']} shed={summary['shed']} "
          f"rejected={summary['rejected']} degraded={summary['degraded']} "
          f"hit={summary['deadline_hit_rate']:.3f} "
          f"p50={summary['p50_ms'] if summary['p50_ms'] is None else round(summary['p50_ms'], 2)}ms "
          f"p99={summary['p99_ms'] if summary['p99_ms'] is None else round(summary['p99_ms'], 2)}ms")
    return summary


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
