"""What the benchmark makes from ``--seed`` and hands to the program: the
model, built through the configuration's entry and given its weights, and
the pool of sessions its traffic draws from."""
from __future__ import annotations

import importlib
from typing import Dict, List

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


def build(name: str, kind, device):
    """The model the program's entry ``name`` (``package.module.attr``)
    builds on ``device``, called as ``entry(kind, device=device)``."""
    module, attr = name.rsplit(".", 1)
    return getattr(importlib.import_module(module), attr)(kind, device=device)


def program_model(config: Dict, device):
    """The configuration's model through its ``builder`` entry."""
    return build(config["builder"], config.get("kind"), device)


def leaf_faults(config: Dict, model) -> List[str]:
    """Where the model's leaves are not the configuration's, in path,
    shape or dtype (a leaf's own, else the configuration's); empty where
    they are."""
    params = leaf_params(model)
    table = weights.leaf_table(config)
    found = {p: list(t.shape) for p, t in params.items()}
    want = {p: list(leaf["shape"]) for p, leaf in table.items()}
    if found != want:
        return [f"{config['name']}: the model's leaves {found} are not the "
                f"configuration's {want}"]
    return [f"{path} is {params[path].dtype}, the configuration states "
            f"{leaf['dtype']}" for path, leaf in table.items()
            if str(params[path].dtype) != "torch." + leaf["dtype"]]


def build_model(config: Dict, seed: int, device, builder=None):
    """The configuration's model from its ``builder`` entry of the program
    (or ``builder(config, device)`` where a test passes one), every leaf then
    overwritten with the seed's values rounded to the leaf's dtype. The
    leaves must be the configuration's, in path, shape and dtype."""
    model = (builder or program_model)(config, device)
    faults = leaf_faults(config, model)
    if faults:
        raise ValueError("; ".join(faults))
    params = leaf_params(model)
    for path, leaf in weights.leaf_table(config).items():
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
