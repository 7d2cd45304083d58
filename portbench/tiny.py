"""The cells at a size a CPU test can hold.

A configuration may declare its own tiny form, an object ``tiny`` with
``builder`` (the program's entry that builds its CPU-sized model, a dotted
name called as ``yardstick.inputs.build`` calls the file's own),
``leaves`` (the shape that entry gives each of the configuration's
leaves), ``config`` (optional: the configuration's own keys at that size,
such as its heads, experts per token and vocabulary, which no shape tells
a loop or a reference) and ``traffic`` (by the name of each traffic mix it
runs, the keys that mix overrides; a mix it does not name has no tiny
form). A configuration without one is a hashed click model and gets the
click defaults: 2^14 ids hashed 10x (2,048-row tables), pools of 2,048
sessions, batches of 64, chunks of 2. Everything else is the cells' own."""
from __future__ import annotations

import copy
from typing import Dict

from yardstick import inputs, spec

ROWS = 2048


def builder(config: Dict, device):
    """The configuration's tiny model: its tiny form's entry, or the
    click model of its ``kind`` as ``configs.clax_baidu.make_model`` builds
    it, over 2^14 ids."""
    if "tiny" in config:
        return inputs.build(config["tiny"]["builder"], config.get("kind"),
                            device)
    from repro_torch.core import (Compression, DynamicBayesianNetwork,
                                  EmbeddingParameterConfig,
                                  UserBrowsingModel)

    cfg = EmbeddingParameterConfig(
        parameters=1 << 14, compression=Compression.HASH,
        compression_ratio=10.0, baseline_correction=True, init_logit=-2.0)
    if config["kind"] == "dbn":
        return DynamicBayesianNetwork(positions=10, attraction=cfg,
                                      satisfaction=cfg, device=device)
    return UserBrowsingModel(positions=10, attraction=cfg, device=device)


def config(full: Dict) -> Dict:
    """A copy of the configuration at its tiny form: its leaves at their
    tiny shapes, and the keys its tiny form's ``config`` gives."""
    small = copy.deepcopy(full)
    form = small.get("tiny")
    if form is not None:
        small.update(form.get("config", {}))
    for path, leaf in small["leaves"].items():
        if form is not None:
            leaf["shape"] = list(form["leaves"][path])
        elif leaf.get("hashed"):
            leaf["shape"] = [ROWS, 1]
    return small


def cell(workload: str, root: str = spec.ROOT) -> spec.Cell:
    """The cell at its tiny form. A configuration with a tiny form that
    does not name the cell's mix has none for it: that raises, and no
    mix runs at full size on the CPU."""
    c = spec.load_cell(workload, root)
    c.config = config(c.config)
    t = c.traffic
    if "tiny" in c.config:
        mixes = c.config["tiny"]["traffic"]
        if c.mix not in mixes:
            raise ValueError(f"{workload}: {c.config['name']}'s tiny form "
                             f"names no mix {c.mix!r} ({', '.join(mixes)})")
        t.update(mixes[c.mix])
        return c
    t.update(sessions=2048, n_queries=60, batch=64)
    if t["loop"] == "train":
        t.update(chunk_batches=2, warmup_chunks=1)
    else:
        t.update(batches=4, warmup_calls=4)
    return c
