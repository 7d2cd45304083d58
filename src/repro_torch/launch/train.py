"""Training launcher for the port's click models (in-memory path).

    PYTHONPATH=src python -m repro_torch.launch.train --model ubm \\
        [--sessions 200000] [--epochs 20] [--batch 2048] \\
        [--compression hash --ratio 10] [--chunk-batches 8] \\
        [--sparse-tables] [--ckpt-dir ckpts/ubm] [--device cuda]

Synthesizes a DBN-behaviour click log, splits it 80/10/10, trains any of
the ten click models (UBM by default, as in ``repro.launch.train``) with
AdamW (with ``--sparse-tables``, sparse lazy AdamW for the embedding
tables) and prints the test metrics. Runs on the GPU unless ``--device
cpu``. Port of the in-memory path of ``repro.launch.train``.

Sweeps: ``--replicas R`` trains R seed/lr variants in one engine, with
``--replica-seeds`` / ``--replica-lrs`` setting each replica's knobs.

Fault tolerance: ``--ckpt-dir`` checkpoints every 200 steps and at every
epoch's end and resumes from the newest valid checkpoint; SIGTERM/SIGINT
write a final checkpoint and stop. ``--max-restarts N`` supervises
training in a child process and relaunches it after crashes,
``--nonfinite-guard`` skips non-finite optimizer steps on the device,
``--step-budget-seconds`` counts slow steps, and ``--fault-kill-at-step``
arms a chaos-test kill switch. The store, data-parallel and telemetry
flags wait for later slices.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys

from repro_torch import optim
from repro_torch.core import (MODEL_REGISTRY, Compression,
                              EmbeddingParameterConfig)
from repro_torch.data import (ClickLogLoader, SyntheticConfig,
                              generate_click_log, split_sessions)
from repro_torch.train import Trainer


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
    ap.add_argument("--chunk-batches", type=int, default=8,
                    help="optimizer steps per engine chunk (losses are read "
                         "once per chunk)")
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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
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
    if args.sparse_tables and args.compression == "quotient_remainder":
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

    cfg = SyntheticConfig(n_sessions=args.sessions,
                          n_queries=max(args.sessions // 100, 1),
                          docs_per_query=20, positions=10, behavior="dbn",
                          seed=args.seed)
    data, _ = generate_click_log(cfg)
    train, val, test = split_sessions(data, (0.8, 0.1, 0.1), seed=args.seed)
    train_loader = ClickLogLoader(train, batch_size=args.batch, seed=args.seed)
    val_loader = ClickLogLoader(val, batch_size=8192, shuffle=False,
                                drop_last=False)
    test_loader = ClickLogLoader(test, batch_size=8192, shuffle=False,
                                 drop_last=False)
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
                      seed=args.seed)
    trainer.train(model, train_loader, val_loader,
                  resume=bool(args.ckpt_dir))
    results = trainer.test(model, test_loader)
    if args.replicas is None:
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
