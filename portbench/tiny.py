"""The cells at a size a CPU test can hold: the configurations' models
with 2^14 ids hashed 10x (2,048-row tables), pools of 2,048 sessions,
batches of 64, chunks of 2. Everything else is the cells' own."""
from __future__ import annotations

from yardstick import spec

ROWS = 2048


def builder(kind, device):
    """The configuration's model as ``configs.clax_baidu.make_model``
    builds it, over 2^14 ids."""
    from repro_torch.core import (Compression, DynamicBayesianNetwork,
                                  EmbeddingParameterConfig,
                                  UserBrowsingModel)

    cfg = EmbeddingParameterConfig(
        parameters=1 << 14, compression=Compression.HASH,
        compression_ratio=10.0, baseline_correction=True, init_logit=-2.0)
    if kind == "dbn":
        return DynamicBayesianNetwork(positions=10, attraction=cfg,
                                      satisfaction=cfg, device=device)
    return UserBrowsingModel(positions=10, attraction=cfg, device=device)


def cell(workload: str) -> spec.Cell:
    c = spec.load_cell(workload)
    for leaf in c.config["leaves"].values():
        if leaf.get("hashed"):
            leaf["shape"] = [ROWS, 1]
    t = c.traffic
    t.update(sessions=2048, n_queries=60, batch=64)
    if t["loop"] == "train":
        t.update(chunk_batches=2, warmup_chunks=1)
    else:
        t.update(batches=4, warmup_calls=4)
    return c
