"""What the benchmark makes from ``--seed`` and hands to the program: the
model, built through the configuration's entry and given its weights, and
the pool of sessions its traffic draws from."""
from __future__ import annotations

import importlib
from typing import Dict

import numpy as np

from yardstick import weights
from yardstick.synthetic import SyntheticConfig, generate_click_log

#: The session fields the click models read.
FIELDS = ("positions", "query_doc_ids", "clicks", "mask")


def leaf_params(model) -> Dict:
    """The model's parameters by their path (``attraction/table``)."""
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("parts."):
            name = name[len("parts."):]
        out[name.replace(".", "/")] = p
    return out


def build_model(config: Dict, seed: int, device, builder=None):
    """The configuration's model from its ``builder`` entry of the program
    (or ``builder(kind, device)`` where a test passes one), every leaf then
    overwritten with the seed's values. The leaves must be the
    configuration's, in path, shape and type."""
    if builder is None:
        module, attr = config["builder"].rsplit(".", 1)
        builder = getattr(importlib.import_module(module), attr)
    model = builder(config["kind"], device=device)
    params = leaf_params(model)
    table = weights.leaf_table(config)
    found = {p: list(t.shape) for p, t in params.items()}
    want = {p: list(leaf["shape"]) for p, leaf in table.items()}
    if found != want:
        raise ValueError(f"{config['name']}: the model's leaves {found} are "
                         f"not the configuration's {want}")
    for path, leaf in table.items():
        if str(params[path].dtype) != "torch." + config["dtype"]:
            raise ValueError(f"{path} is {params[path].dtype}, the "
                             f"configuration states {config['dtype']}")
        weights.fill_(params[path].data, seed, leaf["index"],
                      leaf["center"], leaf["spread"])
    return model


def make_pool(config: Dict, traffic: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The mix's pool of sessions, drawn from ``seed`` by the frozen
    generator; ids in the mix's ``ids_dtype``."""
    cfg = SyntheticConfig(
        n_sessions=traffic["sessions"], n_queries=traffic["n_queries"],
        docs_per_query=traffic["docs_per_query"],
        positions=config["positions"], behavior=traffic["behavior"],
        zipf_exponent=traffic["zipf_exponent"], seed=seed)
    data, _ = generate_click_log(cfg)
    pool = {k: data[k] for k in FIELDS}
    pool["query_doc_ids"] = pool["query_doc_ids"].astype(traffic["ids_dtype"])
    return pool
