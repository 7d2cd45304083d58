"""``correct`` comes out false when the timed path is broken underneath a
whole run (at a size the CPU holds), once for each fault a cell can have,
and for the control: the plain reference in bfloat16 in the program's
place."""
import numpy as np
import pytest
import torch

import run
import tiny
from loops import serve_bulk, train
from yardstick import check, inputs

SEED = 20_251_018


def _run(workload):
    result, lines = run.execute(tiny.cell(workload), SEED, 0.3, False,
                                device="cpu", builder=tiny.builder)
    return result, lines


@pytest.mark.parametrize("workload", ["clax-dbn-baidu.train",
                                      "clax-ubm-baidu.train"])
def test_a_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from repro_torch.train.engine import TrainEngine

    monkeypatch.setattr(TrainEngine, "_update",
                        lambda self, opt_state, *a, **k: opt_state)
    result, lines = _run(workload)
    assert not result["correct"], lines
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload,model", [
    ("clax-dbn-baidu.train", "DynamicBayesianNetwork"),
    ("clax-ubm-baidu.train", "UserBrowsingModel")])
def test_half_of_the_batch_left_out(workload, model, monkeypatch):
    import repro_torch.core as core

    cls = getattr(core, model)
    whole = cls.compute_loss

    def half(self, batch):
        n = batch["clicks"].shape[0] // 2
        return whole(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(cls, "compute_loss", half)
    result, lines = _run(workload)
    assert not result["correct"], lines


@pytest.mark.parametrize("workload,model", [
    ("clax-dbn-baidu.serve_bulk", "DynamicBayesianNetwork"),
    ("clax-ubm-baidu.serve_bulk", "UserBrowsingModel")])
def test_an_answer_altered_where_it_is_produced(workload, model,
                                                monkeypatch):
    import repro_torch.core as core

    cls = getattr(core, model)
    served = cls.predict_clicks

    def altered(self, batch):
        out = served(self, batch).clone()
        out[0, 0] += 1e-3
        return out

    monkeypatch.setattr(cls, "predict_clicks", altered)
    result, lines = _run(workload)
    assert not result["correct"], lines


@pytest.mark.parametrize("workload", ["clax-dbn-baidu.train",
                                      "clax-ubm-baidu.train",
                                      "clax-dbn-baidu.serve_bulk",
                                      "clax-ubm-baidu.serve_bulk"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_bfloat16_control_is_not_correct(workload, seed):
    cell = tiny.cell(workload)
    pool = inputs.make_pool(cell.config, cell.traffic, seed)
    if cell.traffic["loop"] == "train":
        batches = train.check_batches(pool, cell.traffic, seed)
        want = check.train_reference(cell.config, seed, batches)
        got = check.train_reference(cell.config, seed, batches,
                                    torch.bfloat16)
        gaps = check.train_gaps(got, want)
    else:
        batch = serve_bulk.served_batches(pool, cell.traffic)[0]
        want = check.serve_reference(cell.config, seed, batch)
        got = check.serve_reference(cell.config, seed, batch, torch.bfloat16)
        gaps = {"logp_gap": check.logp_gap(got.astype(np.float32), want)}
    correct, checks = check.judge(gaps, cell.limits)
    assert not correct, checks
