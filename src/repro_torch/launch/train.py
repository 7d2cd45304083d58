"""Training launcher for the port's click models (port of
``repro.launch.train``).

In-memory path (the log must fit in host RAM):

    PYTHONPATH=src python -m repro_torch.launch.train --model ubm \\
        [--sessions 200000] [--epochs 20] [--batch 2048] \\
        [--compression hash --ratio 10] [--chunk-batches 8] \\
        [--sparse-tables] [--ckpt-dir ckpts/ubm] [--device cuda]

Out-of-core path: ingest once into a sharded on-disk session store, then
stream batches from it (peak data memory is O(chunk + shard), so the log
can be far larger than RAM):

    PYTHONPATH=src python -m repro_torch.launch.train --model ubm \\
        --store-dir /data/clicklog --ingest --sessions 100000000 \\
        [--chunk-sessions 1000000] [--shard-rows 1000000] \\
        [--ingest-workers 8] [--store-codec auto]

``--ingest-workers N`` fans chunk synthesis and shard writing over N
spawned worker processes (byte-identical output to one); ``--store-codec
auto`` compresses each column per shard (bitpack/zlib/raw, chosen from the
bytes). A directory that already holds ingested ``train/val/test`` stores
is reused when ``--ingest`` is omitted; the model is sized from the
``SyntheticConfig`` recorded in the store's manifest.

Synthesizes (or reads) a DBN-behaviour click log split 80/10/10, trains any
of the ten click models (UBM by default, as in ``repro.launch.train``) with
AdamW (with ``--sparse-tables``, sparse lazy AdamW for the embedding
tables) and prints the test metrics. Runs on the GPU unless ``--device
cpu``.

Sweeps: ``--replicas R`` trains R seed/lr variants in one engine, with
``--replica-seeds`` / ``--replica-lrs`` setting each replica's knobs.

Fault tolerance: ``--ckpt-dir`` checkpoints every 200 steps and at every
epoch's end and resumes from the newest valid checkpoint; SIGTERM/SIGINT
write a final checkpoint and stop. ``--max-restarts N`` supervises
training in a child process and relaunches it after crashes,
``--nonfinite-guard`` skips non-finite optimizer steps on the device,
``--step-budget-seconds`` counts slow steps, and ``--fault-kill-at-step``
arms a chaos-test kill switch; on the store path ``--verify-store``
crc-checks shards as they are read, ``--corrupt-shards raise|skip``
decides what a corrupt one does, and ``--io-retries`` retries transient
read errors.

Observability: ``--metrics-out`` writes telemetry events as JSONL (and
turns on the engine's per-step grad and parameter norms), ``--trace-out``
exports the span ring (the coarse spans and the per-chunk and per-item
detail spans, as far back as its 8192 spans reach) and the counters as a
Chrome trace at the end, ``--obs-every`` thins
per-step events, and ``--profile-steps A:B`` opens a ``torch.profiler``
window into ``--profile-dir``. ``--emit-roofline`` emits the chunk step's
per-device cost once as a ``roofline`` event (``TrainEngine.roofline``: a
fake run of one chunk, counted by ``launch/op_cost.py``).

JAX's ``--kernel-impl`` (``pallas`` / ``xla`` / ``ref``, resolved at trace
time by ``repro.kernels.dispatch``) has no counterpart, by design: in the
port the device picks, a CUDA tensor launching the hand-written kernel (or
raising) and a CPU tensor taking its plain version, with no registry and
no fallback; ``chip_smoke.py``'s ``conformance`` phase holds each kernel
route against its plain route on the card.

Data parallelism: ``--data-parallel`` trains on a ``(n, 1)`` mesh over
every rank of the world (``launch.mesh.make_data_parallel_mesh``; NCCL on
the card, gloo with ``--device cpu``): each rank trains on its rows of
every batch (``--batch`` must divide by n). Run alone it starts a world
of one; over several cards, one process each:

    torchrun --nproc-per-node=N -m repro_torch.launch.train \
        --data-parallel [--sparse-tables] ...

Only rank 0 prints and writes checkpoints.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys

from repro_torch import obs, optim
from repro_torch.core import (MODEL_REGISTRY, Compression,
                              EmbeddingParameterConfig)
from repro_torch.data import (ClickLogLoader, SessionStore,
                              StreamingClickLogLoader, SyntheticConfig,
                              generate_click_log, ingest_synthetic,
                              split_sessions)
from repro_torch.train import Trainer


def _synthetic_config(args) -> SyntheticConfig:
    return SyntheticConfig(n_sessions=args.sessions,
                           n_queries=max(args.sessions // 100, 1),
                           docs_per_query=20, positions=10, behavior="dbn",
                           seed=args.seed)


def make_loaders(args):
    """Returns (train_loader, val_loader, test_loader, data_cfg) where
    data_cfg is the SyntheticConfig describing the data (for the store path,
    rebuilt from the manifest's metadata, so models are sized against what
    was actually ingested)."""
    if args.store_dir:
        if args.ingest:
            cfg = _synthetic_config(args)
            chunk = args.chunk_sessions or max(args.sessions // 20, 1)
            print(f"[train] ingesting {cfg.n_sessions} sessions into "
                  f"{args.store_dir} (chunk={chunk}, "
                  f"shard_rows={args.shard_rows}, "
                  f"codec={args.store_codec}, "
                  f"workers={args.ingest_workers})", flush=True)
            ingest_synthetic(cfg, args.store_dir, chunk_sessions=chunk,
                             shard_rows=args.shard_rows,
                             splits={"train": 0.8, "val": 0.1, "test": 0.1},
                             codec=args.store_codec,
                             workers=args.ingest_workers)
        train_store = SessionStore(os.path.join(args.store_dir, "train"))
        syn = train_store.metadata.get("synthetic_config")
        if syn is None:
            raise SystemExit(
                f"{args.store_dir}/train has no synthetic_config metadata — "
                "was it ingested with --ingest / ingest_synthetic?")
        data_cfg = SyntheticConfig(**syn)
        train = StreamingClickLogLoader(train_store, batch_size=args.batch,
                                        seed=args.seed, host_id=args.host_id,
                                        host_count=args.host_count,
                                        window_rows=args.window_rows,
                                        verify_checksums=args.verify_store,
                                        corrupt_policy=args.corrupt_shards,
                                        io_retries=args.io_retries)
        val = StreamingClickLogLoader(os.path.join(args.store_dir, "val"),
                                      batch_size=8192, shuffle=False,
                                      drop_last=False)
        test = StreamingClickLogLoader(os.path.join(args.store_dir, "test"),
                                       batch_size=8192, shuffle=False,
                                       drop_last=False)
        return train, val, test, data_cfg

    cfg = _synthetic_config(args)
    data, _ = generate_click_log(cfg)
    train, val, test = split_sessions(data, (0.8, 0.1, 0.1), seed=args.seed)
    return (ClickLogLoader(train, batch_size=args.batch, seed=args.seed,
                           host_id=args.host_id, host_count=args.host_count),
            ClickLogLoader(val, batch_size=8192, shuffle=False,
                           drop_last=False),
            ClickLogLoader(test, batch_size=8192, shuffle=False,
                           drop_last=False),
            cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ubm", choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--sessions", type=int, default=200_000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compression", default="none",
                    choices=[c.value for c in Compression])
    ap.add_argument("--ratio", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--host-count", type=int, default=1)
    ap.add_argument("--store-dir", default=None,
                    help="session-store directory; train via the streaming "
                         "out-of-core loader instead of in-memory arrays")
    ap.add_argument("--ingest", action="store_true",
                    help="synthesize --sessions sessions chunk-by-chunk into "
                         "--store-dir/{train,val,test} before training")
    ap.add_argument("--chunk-sessions", type=int, default=None,
                    help="ingest chunk size in sessions (default: sessions/20)")
    ap.add_argument("--shard-rows", type=int, default=1_000_000,
                    help="rows per store shard (unit of shuffle/host placement)")
    ap.add_argument("--ingest-workers", type=int, default=1,
                    help="worker processes for --ingest; each owns a "
                         "disjoint shard block per split, byte-identical "
                         "output to --ingest-workers 1")
    ap.add_argument("--store-codec", default="auto", choices=["auto", "raw"],
                    help="per-column store codec for --ingest: 'auto' picks "
                         "bitpack/zlib/raw per column per shard; 'raw' pins "
                         "the v1-byte-compatible memmap layout")
    ap.add_argument("--window-rows", type=int, default=None,
                    help="streaming read window within a shard (default: full "
                         "shard)")
    ap.add_argument("--chunk-batches", type=int, default=8,
                    help="optimizer steps per engine chunk (losses are read "
                         "once per chunk)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard the batch axis over every rank of the world "
                         "(a world of one when run alone; requires --batch "
                         "divisible by the world's size)")
    ap.add_argument("--sparse-tables", action="store_true",
                    help="lazy-AdamW updates of the embedding tables: "
                         "optimizer state traffic O(unique batch rows) "
                         "instead of O(table rows)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: saves every 200 steps and "
                         "at every epoch's end, resumes from its newest "
                         "valid checkpoint")
    ap.add_argument("--replicas", type=int, default=None,
                    help="train R independent replicas in one engine "
                         "(R x params/opt-state memory, 1x data; one replay "
                         "advances all runs)")
    ap.add_argument("--replica-lrs", type=float, nargs="+", default=None,
                    help="one learning rate per replica (default: --lr for "
                         "all); switches the optimizer to inject_lr=True")
    ap.add_argument("--replica-seeds", type=int, nargs="+", default=None,
                    help="one init seed per replica (default: --seed + i)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="supervise training in a child process and relaunch "
                         "it after crashes up to N times; resumes from "
                         "--ckpt-dir (required)")
    ap.add_argument("--verify-store", action="store_true",
                    help="crc32-verify every store shard's columns at read "
                         "time (streaming path)")
    ap.add_argument("--corrupt-shards", default="raise",
                    choices=["raise", "skip"],
                    help="what a corrupt train shard does under "
                         "--verify-store: fail the run, or quarantine the "
                         "shard and keep training deterministically")
    ap.add_argument("--io-retries", type=int, default=2,
                    help="transient shard-read failures retried with "
                         "exponential backoff (streaming path)")
    ap.add_argument("--nonfinite-guard", action="store_true",
                    help="detect non-finite loss/grads on the device and "
                         "skip those optimizer steps (counted in history as "
                         "skipped_steps)")
    ap.add_argument("--step-budget-seconds", type=float, default=None,
                    help="flag steps slower than this wall-clock budget "
                         "(watchdog_violations in history)")
    ap.add_argument("--fault-kill-at-step", type=int, default=None,
                    help="CHAOS TESTING: kill this process when train batch "
                         "N is produced — armed only while --ckpt-dir has "
                         "no committed checkpoint, so a restarted run "
                         "completes")
    ap.add_argument("--fault-kill-signal", default="KILL",
                    choices=["TERM", "KILL"],
                    help="signal --fault-kill-at-step sends (TERM exercises "
                         "graceful preemption, KILL an instant crash)")
    ap.add_argument("--metrics-out", default=None,
                    help="write structured telemetry events (JSONL, one per "
                         "line) to this file; also turns on the engine's "
                         "on-device per-step grad/param-norm series")
    ap.add_argument("--trace-out", default=None,
                    help="export the span ring (epoch/eval/checkpoint/"
                         "shard_read/... and the detail spans: train.chunk "
                         "and its children, prefetch.*, param.lookup) and "
                         "the counters as a Chrome-trace JSON for Perfetto "
                         "at the end of the run; the ring keeps the newest "
                         "8192 spans, so its capacity bounds how far back "
                         "the detail spans reach")
    ap.add_argument("--obs-every", type=int, default=1,
                    help="emit every Nth per-step train metric event "
                         "(loss/grad-norm/...); skips and epoch records are "
                         "always emitted")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="open a torch.profiler trace window around the "
                         "chunks covering global steps A..B")
    ap.add_argument("--profile-dir", default="profile",
                    help="directory the --profile-steps trace is written to")
    ap.add_argument("--emit-roofline", action="store_true",
                    help="emit the chunk step's per-device cost (flops, "
                         "bytes, collective wire, peak; a fake run of one "
                         "chunk) once as a roofline telemetry event")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.ingest_workers < 1:
        ap.error(f"--ingest-workers must be >= 1, got {args.ingest_workers}")
    if (args.ingest_workers > 1 or args.store_codec != "auto") \
            and not args.store_dir:
        ap.error("--ingest-workers/--store-codec only apply to the store "
                 "path — pass --store-dir (and --ingest)")
    if args.max_restarts:
        if not args.ckpt_dir:
            ap.error("--max-restarts requires --ckpt-dir (the restarted "
                     "child resumes from it)")
        from repro_torch.train import run_with_restarts

        # Re-run this exact invocation as a supervised child, minus the
        # --max-restarts flag itself (the child must not recurse).
        child_args, skip = [], False
        for a in argv:
            if skip:
                skip = False
                continue
            if a == "--max-restarts":
                skip = True
                continue
            if a.startswith("--max-restarts="):
                continue
            child_args.append(a)
        raise SystemExit(run_with_restarts(
            [sys.executable, "-m", "repro_torch.launch.train"] + child_args,
            args.max_restarts))
    if args.ingest and not args.store_dir:
        ap.error("--ingest requires --store-dir")
    if args.sparse_tables and args.compression == "quotient_remainder":
        # fail before a potentially hours-long ingest, not inside train()
        ap.error("--sparse-tables does not support quotient_remainder "
                 "compression (two coupled tables, no single row-id stream)")
    if args.replicas is None and (args.replica_lrs or args.replica_seeds):
        ap.error("--replica-lrs/--replica-seeds require --replicas")
    for name, knob in (("--replica-lrs", args.replica_lrs),
                       ("--replica-seeds", args.replica_seeds)):
        if knob is not None and len(knob) != args.replicas:
            ap.error(f"{name} needs exactly --replicas {args.replicas} values")
    if args.replica_lrs and args.sparse_tables:
        ap.error("--replica-lrs is not supported with --sparse-tables (the "
                 "lazy-AdamW lr is a static hyperparameter shared by all "
                 "replicas); per-seed sweeps (--replica-seeds) are fine")

    # Observability: configure the process-global recorder before the
    # loaders exist, so the streaming data plane's spans and counters land
    # in the same stream. Spans always go to the host ring buffer (for
    # --trace-out); the JSONL sink is attached only under --metrics-out.
    previous = recorder = obs.get_recorder()
    if args.metrics_out:
        recorder = obs.configure(sinks=[obs.JsonlSink(args.metrics_out)])
        print(f"[train] telemetry -> {args.metrics_out}", flush=True)

    mesh, lead = None, True
    if args.data_parallel:
        from repro_torch.launch.mesh import make_data_parallel_mesh

        mesh = make_data_parallel_mesh(device=args.device)
        lead = mesh.get_rank() == 0
        if lead:
            print(f"[train] data-parallel mesh: "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)

    train_loader, val_loader, test_loader, cfg = make_loaders(args)
    if args.fault_kill_at_step is not None:
        from repro_torch.testing import KillSwitch

        ckpt = args.ckpt_dir
        has_ckpt = bool(ckpt) and os.path.isdir(ckpt) and any(
            n.startswith("step_")
            and os.path.exists(os.path.join(ckpt, n, "COMMIT"))
            for n in os.listdir(ckpt))
        if not has_ckpt:
            sig = (signal.SIGKILL if args.fault_kill_signal == "KILL"
                   else signal.SIGTERM)
            train_loader = KillSwitch(train_loader, args.fault_kill_at_step,
                                      sig=sig)
            print(f"[train] chaos: SIG{args.fault_kill_signal} armed at "
                  f"train batch {args.fault_kill_at_step}", flush=True)

    attraction = EmbeddingParameterConfig(
        parameters=cfg.n_query_doc_pairs,
        compression=Compression(args.compression),
        compression_ratio=args.ratio,
        baseline_correction=True, init_logit=-2.0)
    model = MODEL_REGISTRY[args.model](
        query_doc_pairs=cfg.n_query_doc_pairs, positions=cfg.positions,
        attraction=attraction, device=args.device)

    optimizer = optim.adamw(args.lr, weight_decay=1e-4,
                            inject_lr=args.replica_lrs is not None)
    trainer = Trainer(optimizer=optimizer, epochs=args.epochs, patience=1,
                      checkpoint_dir=args.ckpt_dir,
                      checkpoint_every_steps=200 if args.ckpt_dir else None,
                      handle_preemption=True,
                      chunk_batches=args.chunk_batches, device=args.device,
                      sparse_tables=args.sparse_tables,
                      # mirrors the dense optimizer above
                      sparse_table_kwargs=dict(lr=args.lr, weight_decay=1e-4),
                      replicas=args.replicas,
                      replica_lrs=args.replica_lrs,
                      replica_seeds=args.replica_seeds,
                      nonfinite_guard=args.nonfinite_guard,
                      step_budget_seconds=args.step_budget_seconds,
                      seed=args.seed,
                      telemetry=bool(args.metrics_out),
                      obs_every=args.obs_every,
                      profile_steps=args.profile_steps,
                      profile_dir=args.profile_dir, mesh=mesh,
                      emit_roofline=args.emit_roofline)
    try:
        trainer.train(model, train_loader, val_loader,
                      resume=bool(args.ckpt_dir))
        results = trainer.test(model, test_loader)
    finally:
        if args.trace_out:
            n_events = recorder.export_chrome_trace(args.trace_out)
            print(f"[train] {n_events} events -> {args.trace_out} "
                  "(open in Perfetto / chrome://tracing)", flush=True)
        recorder.flush_counters()
        recorder.close()
        obs.set_recorder(previous)
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    if not lead:
        pass
    elif args.replicas is None:
        print("[train] test:", {k: round(v, 4) for k, v in results.items()
                                if k != "per_rank"}, flush=True)
    else:
        for i in range(args.replicas):
            print(f"[train] test replica {i}:",
                  {k: round(v[i], 4) for k, v in results.items()
                   if k != "per_rank"}, flush=True)
    return results


if __name__ == "__main__":
    main()
