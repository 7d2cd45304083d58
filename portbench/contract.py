"""The contract each configuration of ``BENCHMARK.json`` keeps, whatever
its model family, as checks that return what is wrong (an empty list where
nothing is): the spec's tests call them over every configuration, and the
contract's own test over configurations of other families and over faults
planted in a copy of the layout.

* :func:`configuration_faults`: the ``configs`` entry and its file. A
  hashed click model's tables have the rows its ids hashed give; each key
  the entry lists in ``reduced`` is in the file, beside its published value
  under ``published``; the file states the ``deployment`` it stands for;
  each leaf's dtype (its own ``dtype``, else the file's) is a floating
  type; a ``tiny`` form gives every leaf a shape, and a number only to
  keys whose number the file gives.
* :func:`build_faults`: what the program's builder gives, on the meta
  device, has the file's leaves in path, shape and dtype, and so has the
  tiny form's builder at the tiny shapes.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List

import tiny
from yardstick import inputs, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
ENTRY_KEYS = {"name", "source", "file", "reduced", "why"}
TINY_KEYS = {"builder", "leaves", "traffic"}
FLOATS = {"float64", "float32", "bfloat16", "float16"}


def one_line(s) -> bool:
    """1 to 200 characters on one line, with no tab."""
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _hashed_faults(config: Dict) -> List[str]:
    hashed = {p: leaf for p, leaf in config["leaves"].items()
              if leaf.get("hashed")}
    if not hashed:
        return []
    rows = -(-int(config["parameters"] / config["compression_ratio"])
             // 512) * 512
    out = [] if config["table_rows"] == rows else [
        f"table_rows {config['table_rows']} is not {rows}: "
        f"{config['parameters']} ids hashed {config['compression_ratio']}x, "
        "rounded up to 512"]
    return out + [f"{p} is {leaf['shape']}, not [{config['table_rows']}, 1]"
                  for p, leaf in hashed.items()
                  if leaf["shape"] != [config["table_rows"], 1]]


def _reduced_faults(reduced, config: Dict) -> List[str]:
    published = config.get("published", {})
    out = []
    for key in reduced:
        if not NAME.match(key):
            out.append(f"reduced key {key!r} is no name")
        elif key not in config:
            out.append(f"reduced key {key!r} is not in the file")
        elif key not in published:
            out.append(f"reduced key {key!r} has no published value")
        elif published[key] == config[key]:
            out.append(f"reduced key {key!r} is its published value")
    return out


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _tiny_faults(config: Dict) -> List[str]:
    form = config.get("tiny")
    if form is None:
        return []
    if not TINY_KEYS <= set(form) <= TINY_KEYS | {"config"}:
        return [f"tiny has {sorted(form)}, not {sorted(TINY_KEYS)} and "
                "optionally config"]
    if set(form["leaves"]) != set(config["leaves"]):
        return [f"tiny's leaves {sorted(form['leaves'])} are not the "
                f"configuration's {sorted(config['leaves'])}"]
    out = [f"tiny's config gives {key!r}, which the file has no number "
           "for" for key, value in form.get("config", {}).items()
           if not (_number(config.get(key)) and _number(value))]
    return out + [f"tiny overrides the mix {mix!r} with {keys!r}"
                  for mix, keys in form["traffic"].items()
                  if not (NAME.match(mix) and isinstance(keys, dict))]


def configuration_faults(entry: Dict, root: str = spec.ROOT) -> List[str]:
    """What keeps the ``configs`` entry and its file from the contract."""
    out = []
    if set(entry) != ENTRY_KEYS:
        return [f"the entry has {sorted(entry)}, not {sorted(ENTRY_KEYS)}"]
    if not (NAME.match(entry["name"]) and one_line(entry["why"])):
        out.append("the entry's name or why is malformed")
    if not entry["source"].startswith("https://"):
        out.append(f"source {entry['source']!r} is no https URL")
    if not entry["file"].startswith("portbench/configs/"):
        out.append(f"file {entry['file']!r} is not under portbench/configs/")
    if not (isinstance(entry["reduced"], list) and len(entry["reduced"]) <= 16):
        return out + ["reduced is not a list of at most 16 keys"]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    if config["name"] != entry["name"]:
        out.append(f"the file names {config['name']!r}")
    deployment = config.get("deployment")
    if not (isinstance(deployment, str) and deployment.strip()):
        out.append("the file states no deployment")
    out += [f"{p} is {leaf.get('dtype', config['dtype'])}, no floating "
            "type" for p, leaf in config["leaves"].items()
            if leaf.get("dtype", config["dtype"]) not in FLOATS]
    return (out + _hashed_faults(config)
            + _reduced_faults(entry["reduced"], config)
            + _tiny_faults(config))


def build_faults(config: Dict) -> List[str]:
    """Where the model the configuration's builder gives on the meta
    device, and that of its tiny form at the tiny shapes, are not the
    configuration's leaves."""
    faults = inputs.leaf_faults(config, inputs.program_model(config, "meta"))
    cut = tiny.config(config)
    return faults + inputs.leaf_faults(cut, tiny.builder(cut, "meta"))
