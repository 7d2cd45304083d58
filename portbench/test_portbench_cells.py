"""Each cell, at a size the CPU holds, runs through the harness end to end
and agrees with the plain reference within the cells' limits; the frozen
generator and the reference's hashing are the program's."""
import numpy as np
import pytest
import torch

import run
import tiny
from yardstick import check, spec, weights
from yardstick.synthetic import SyntheticConfig, generate_click_log

CELLS = [w["name"] for w in spec.benchmark()["workloads"] + spec.held()]
SEED = 3_000_000_017  # more than 32 signed bits hold


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_is_correct_on_the_cpu(workload):
    result, lines = run.execute(tiny.cell(workload), SEED, 0.3, False,
                                device="cpu", builder=tiny.builder)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    names = [n for n, _ in spec.load_cell(workload).end_to_end]
    assert list(result["metrics"]) == names
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("behavior", ["dbn", "ubm"])
def test_frozen_generator_gives_the_sources_pool(behavior):
    from repro_torch.data.synthetic import SyntheticConfig as Source
    from repro_torch.data.synthetic import generate_click_log as source

    kw = dict(n_sessions=3000, n_queries=70, docs_per_query=20,
              positions=10, behavior=behavior, zipf_exponent=1.1,
              seed=SEED)
    ours, _ = generate_click_log(SyntheticConfig(**kw))
    theirs, _ = source(Source(**kw))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_reference_hashing_is_the_configurations():
    from repro_torch.core.parameterization import hash_ids

    ids = np.random.default_rng(0).integers(0, 1 << 31, 10000)
    rows = 214748672
    want = hash_ids(torch.from_numpy(ids), rows).numpy()
    np.testing.assert_array_equal(check.hashed_rows(ids, rows), want)


def test_weights_are_a_function_of_seed_leaf_and_index():
    idx = torch.arange(0, 5000, dtype=torch.int64)
    a = weights.values(SEED, 2, idx, 0.0, 1.0)
    perm = torch.randperm(5000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[perm], weights.values(SEED, 2, idx[perm], 0.0, 1.0))
    assert not torch.equal(a, weights.values(SEED + 1, 2, idx, 0.0, 1.0))
    assert not torch.equal(a, weights.values(SEED, 3, idx, 0.0, 1.0))
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0
    assert abs(float(a.mean())) < 0.05
    p = torch.empty(5000)
    weights.fill_(p, SEED, 2, 0.0, 1.0)
    assert torch.equal(p, a)
    assert weights.change_norm(p, SEED, 2, 0.0, 1.0) == 0.0
