"""Training launcher for the port's click models (in-memory path).

    PYTHONPATH=src python -m repro_torch.launch.train --model dbn \\
        [--sessions 200000] [--epochs 20] [--batch 2048] \\
        [--compression hash --ratio 10] [--chunk-batches 8] [--device cuda]

Synthesizes a DBN-behaviour click log, splits it 80/10/10, trains with
AdamW and prints the test metrics. Runs on the GPU unless ``--device cpu``.
Port of the in-memory path of ``repro.launch.train``; the store, replica,
fault-tolerance and telemetry options wait for later slices.
"""
from __future__ import annotations

import argparse

from repro_torch import optim
from repro_torch.core import (MODEL_REGISTRY, Compression,
                              EmbeddingParameterConfig)
from repro_torch.data import (ClickLogLoader, SyntheticConfig,
                              generate_click_log, split_sessions)
from repro_torch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # The JAX launcher defaults to ubm; the port's default is dbn until UBM
    # is ported.
    ap.add_argument("--model", default="dbn", choices=sorted(MODEL_REGISTRY))
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    args = ap.parse_args(argv)

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

    attraction = EmbeddingParameterConfig(
        parameters=cfg.n_query_doc_pairs,
        compression=Compression(args.compression),
        compression_ratio=args.ratio,
        baseline_correction=True, init_logit=-2.0)
    model = MODEL_REGISTRY[args.model](
        query_doc_pairs=cfg.n_query_doc_pairs, positions=cfg.positions,
        attraction=attraction, device=args.device)

    trainer = Trainer(optimizer=optim.adamw(args.lr, weight_decay=1e-4),
                      epochs=args.epochs, patience=1,
                      chunk_batches=args.chunk_batches, device=args.device)
    trainer.train(model, train_loader, val_loader)
    results = trainer.test(model, test_loader)
    print("[train] test:", {k: round(v, 4) for k, v in results.items()
                            if k != "per_rank"})
    return results


if __name__ == "__main__":
    main()
