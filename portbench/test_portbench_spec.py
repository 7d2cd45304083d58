"""``BENCHMARK.json`` keeps to its contract and every name in it leads to
its files: configurations, traffic mixes, limits, loops and per-layer
readers."""
import json
import math
import os
import re

import numpy as np
import pytest

import contract
from contract import NAME
from yardstick import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]
HELD = spec.held()
HELD_METRICS = json.load(open(spec.file_of("held", "metrics")))


_text = contract.one_line


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert _text(metric["layer"])
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        # every cell the reader reads in reports the metric it moves
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))
        assert os.path.exists(spec.file_of("metrics", metric["name"], ".py"))
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS + [w["name"] for w in HELD])
def test_cell_resolves_and_reports_enough(cell):
    w = {x["name"]: x for x in BENCH["workloads"] + HELD}[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _text(w["why"])
    c = spec.load_cell(cell)
    names = [n for n, _ in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert os.path.exists(os.path.join(spec.HERE, "loops",
                                       c.traffic["loop"] + ".py"))
    assert c.limits and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(entry):
    assert contract.configuration_faults(entry) == []


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_is_what_the_program_builds(entry):
    """The program's builder on the meta device gives the configuration's
    leaves, in path, shape and dtype, and the tiny form's builder gives
    them at the tiny shapes."""
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    assert contract.build_faults(config) == []


def test_each_cell_uses_its_configuration_once_per_mix():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)


def test_cost_arithmetic_matches_the_known_bounds():
    """The frozen arithmetic gives the bounds the port's kernel table
    quotes: adamw over the DBN's two tables 3.590 ms, examination_nll over
    65,536 x 10 0.00489 ms, the DBN's whole step 10.31 GB."""
    from yardstick import cost

    n = 214748672
    assert math.isclose(cost.bound_s(cost.adamw([n, n])) * 1e3, 3.590,
                        rel_tol=1e-3)
    assert math.isclose(cost.bound_s(cost.examination_nll(65536, 10)) * 1e3,
                        0.00489, rel_tol=1e-2)
    step = cost.train_step([n, 1, n, 1, 1], 17 * 655360, 180 * 655360)
    assert math.isclose(step.bytes / 1e9, 10.318, rel_tol=1e-3)
    assert np.isclose(cost.bound_s(step) * 1e3, 3.08, rtol=1e-2)


@pytest.mark.parametrize("metric", HELD_METRICS["end_to_end"]
                         + HELD_METRICS["per_layer"], ids=lambda m: m["name"])
def test_held_metric_entry_is_ready_to_move_back(metric):
    """A held cell's metrics keep BENCHMARK.json's form and name only held
    cells, so that moving them back is all that adding the cells takes."""
    held = {w["name"] for w in HELD}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in SOURCES and set(metric["workloads"]) <= held
    assert metric["name"] not in {m["name"] for m in METRICS}
    if "moves" in metric:
        assert os.path.exists(spec.file_of("metrics", metric["name"], ".py"))
