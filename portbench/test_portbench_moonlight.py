"""Moonlight-16B-A3B's scoring cell at its tiny form, on the CPU: the whole
``score_bulk`` path through ``run.execute`` against the plain reference on
three seeds; ``correct`` false under each fault the limits exist for (a
softmax router, the choice bias added to the weights, no 2.446 scale, a
capacity-dropping MoE, rope on halves, no latent norm) and for the float8
control; the reference's precision flags, the frozen arithmetic, the
token generator, the grouped products a call, the cut stack, the readers,
and a reason for each number ``correct`` is decided by.

The tiny form computes in float32 and its mix's ``tail_gap`` is 1e-6, so
``logp_tail_share`` counts the tokens a fault moves at that size; the
limits themselves are the cell's (``limits/``), set from full-size
readings on the card."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import run
import tiny
from loops import score_bulk_lm as loop
from repro_torch.models.lm import transformer as tf
from yardstick import lm_cost, spec

WORKLOAD = "moonlight-16b-a3b.score_4k"
SEEDS = [3_000_000_019, 11, 2_147_483_659]


def _run(seed=SEEDS[0]):
    return run.execute(tiny.cell(WORKLOAD), seed, 0.05, False, device="cpu",
                       builder=tiny.builder)


@pytest.mark.parametrize("seed", SEEDS)
def test_tiny_score_bulk_is_the_reference(seed):
    result, lines = _run(seed)
    assert result["correct"], lines
    checks = result["checks"]
    assert set(checks) == {"logp_mean_gap", "shallow_logp_mean_gap",
                           "shallow_logp_tail_share"}
    for name, c in checks.items():
        assert c["value"] < (1e-6 if name.endswith("mean_gap") else 1e-12), \
            lines
    assert result["attempted"] > 0 and result["failed"] == 0


# --------------------------------------------------------------------------
# Faults: each must read over a limit
# --------------------------------------------------------------------------

def _softmax_router(cfg, lp, xt):
    return ROUTE(dataclasses.replace(cfg, router="softmax"), lp, xt)


def _bias_in_the_weights(cfg, lp, xt):
    scores = torch.sigmoid(xt.float() @ lp["router"].float()) \
        + lp["router_bias"].float()
    top_p, top_i = torch.topk(scores, cfg.top_k, -1)
    return top_p / top_p.sum(-1, keepdim=True) * cfg.routed_scaling_factor, \
        top_i


def _no_scale(cfg, lp, xt):
    top_p, top_i = ROUTE(cfg, lp, xt)
    return top_p / cfg.routed_scaling_factor, top_i


def _capacity(cfg, lp, xt):
    """A capacity-bounded MoE: each expert takes its first T k / E slots,
    in token order; the rest are dropped (weight 0)."""
    top_p, top_i = ROUTE(cfg, lp, xt)
    T, k = top_i.shape
    onehot = torch.nn.functional.one_hot(top_i.reshape(-1), cfg.n_experts)
    place = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return top_p * (place < T * k // cfg.n_experts).view(T, k), top_i


ROUTE = tf._route
ROUTE_FAULTS = {"softmax_router": _softmax_router,
                "bias_in_the_weights": _bias_in_the_weights,
                "no_2_446_scale": _no_scale, "capacity_drop": _capacity}


def _over_a_limit(result):
    return [name for name, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]]


@pytest.mark.parametrize("fault", list(ROUTE_FAULTS))
def test_a_routing_fault_reads_over_a_limit(fault, monkeypatch):
    dispatched = tf._moe_ffn_dispatched
    monkeypatch.setattr(tf, "_moe_ffn_dispatched",
                        lambda cfg, lp, h, route=None: dispatched(
                            cfg, lp, h, ROUTE_FAULTS[fault]))
    result, lines = _run()
    assert not result["correct"] and _over_a_limit(result), lines


def test_rope_on_halves_reads_over_a_limit(monkeypatch):
    monkeypatch.setattr(tf, "_rope_pairs", tf._rope)
    result, lines = _run()
    assert not result["correct"] and _over_a_limit(result), lines


def test_no_latent_norm_reads_over_a_limit(monkeypatch):
    block, norm = tf._mla_attention_block, tf._rmsnorm

    def without(cfg, lp, h, positions):
        latent = lp["kv_norm"]
        monkeypatch.setattr(tf, "_rmsnorm", lambda x, w, eps=1e-6: x
                            if w is latent else norm(x, w, eps))
        try:
            return block(cfg, lp, h, positions)
        finally:
            monkeypatch.setattr(tf, "_rmsnorm", norm)

    monkeypatch.setattr(tf, "_mla_attention_block", without)
    result, lines = _run()
    assert not result["correct"] and _over_a_limit(result), lines


@pytest.mark.parametrize("seed", SEEDS)
def test_the_float8_control_is_not_correct(seed):
    from yardstick import check

    cell = tiny.cell(WORKLOAD)
    gaps = loop.control(cell, seed, "cpu")
    correct, checks = check.judge(gaps, cell.limits)
    assert not correct, checks


# --------------------------------------------------------------------------
# The reference, the arithmetic, the inputs, the counters and the readers
# --------------------------------------------------------------------------

def test_the_reference_turns_tf32_off(monkeypatch):
    from references import moonlight

    cell = tiny.cell(WORKLOAD)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tokens = np.zeros((1, 4), dtype=np.int32)
    loop.reference_logp(cell.config, 1, tokens, "cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert "repro_torch" not in moonlight.__dict__


def test_the_frozen_arithmetic_of_the_call():
    cell = spec.load_cell(WORKLOAD)
    c = cell.config
    call = lm_cost.score_call(c, 8, 4096)
    assert lm_cost.params(c) == 15_960_110_208
    assert call.flops / 8 / 4096 == pytest.approx(5.724e9, rel=1e-3)
    assert lm_cost.bound_s(call) == pytest.approx(0.1897, rel=1e-3)
    launches = lm_cost.grouped_mm(c, 8 * 4096)
    assert len(launches) == 3 * 26
    assert sum(lm_cost.bound_s(x) for x in launches) == pytest.approx(
        0.08943, rel=1e-3)


def test_tokens_are_seeded_zipf_over_the_vocabulary():
    cell = spec.load_cell(WORKLOAD)
    a = loop.token_batches(cell.config, cell.traffic, SEEDS[2])
    b = loop.token_batches(cell.config, cell.traffic, SEEDS[2])
    c = loop.token_batches(cell.config, cell.traffic, SEEDS[2] + 1)
    assert len(a) == 4 and a[0].shape == (8, 4096) and a[0].dtype == np.int32
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    ids = np.concatenate([x.reshape(-1) for x in a])
    assert ids.min() >= 0 and ids.max() < 163840
    _, counts = np.unique(ids, return_counts=True)
    top = np.sort(counts)[::-1]
    # Zipf(1) over 163,840 ranks: the top id about 1 / H(163840) = 7.9%
    assert 0.07 < top[0] / ids.size < 0.09
    assert 1.7 < top[0] / top[1] < 2.3


def test_a_call_routes_every_token_through_three_grouped_products_a_layer(
        monkeypatch):
    """Every call (warm-up, window and the cut stack's) makes a gate, an up
    and a down product in each MoE layer, each over every routed slot,
    tokens x top_k rows."""
    from repro_torch.kernels import grouped_mm as gmm

    made = []
    real = gmm.grouped_mm

    def counted(a, b, ends):
        made.append((a.shape[0], int(ends[-1])))
        return real(a, b, ends)

    monkeypatch.setattr(gmm, "grouped_mm", counted)
    cell = tiny.cell(WORKLOAD)
    result, lines = run.execute(cell, SEEDS[1], 0.05, False, device="cpu",
                                builder=tiny.builder)
    moe_layers, slots = 2, 2 * 16 * 2  # two MoE layers, 2 x 16 tokens, top-2
    assert set(made) == {(slots, slots)}
    assert len(made) % (3 * moe_layers) == 0
    timed = result["attempted"] + cell.traffic["warmup_calls"]
    cut_calls = len(made) // (3 * moe_layers) - timed  # one a checked batch
    assert 1 <= cut_calls <= cell.traffic["check_rows"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_cut_stack_is_the_first_layers(seed):
    """``cut`` zeroes the named leaves of every layer from
    ``shallow_layers`` on and nothing else, and the cut program is the
    reference through as many layers."""
    from repro_torch.configs.lm_common import score_bulk
    from yardstick import inputs

    cell = tiny.cell(WORKLOAD)
    config, traffic = cell.config, cell.traffic
    model = inputs.build_model(config, seed, "cpu", tiny.builder)
    before = {p: t.detach().clone()
              for p, t in inputs.leaf_params(model).items()}
    loop.cut(model, config, traffic)
    after = inputs.leaf_params(model)
    first = traffic["shallow_layers"] - config["first_k_dense_replace"]
    assert first == 1
    for path, was in before.items():
        if path in traffic["shallow_zero"]:
            assert torch.equal(after[path][:first], was[:first])
            assert not after[path][first:].any() and was[first:].any()
        else:
            assert torch.equal(after[path], was), path
    tokens = loop.token_batches(config, traffic, seed)[0]
    got = score_bulk(model, tokens)
    want = loop.reference_logp(config, seed, tokens, "cpu",
                               layers=traffic["shallow_layers"])
    whole = loop.reference_logp(config, seed, tokens, "cpu")
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(got - whole).max() > 1e-3


def test_the_readers_read_the_loops_context():
    from run import _reader

    class Trace:
        window_s = 2.0
        device = [("x", 0.0, 1.0, False)]

        def busy_s(self):
            return 1.5

        def kernels(self, pattern):
            return (156, 0.5)

    ctx = {"calls": 10, "window_s": 20.0, "overhead_s": 0.5,
           "calls_traced": 2, "trace": Trace(),
           "bound_s": {"call": 0.19, "grouped_mm": 0.0894},
           "span_device_s": {"lm.attention": 2.0, "lm.moe": 0.6}}
    assert _reader("score_mfu")(ctx) == pytest.approx(100 * 0.19 / 1.95)
    assert _reader("moe_grouped_mm_roofline")(ctx) == pytest.approx(
        100 * 0.0894 / (0.5 / 2))
    assert _reader("mla_attention_ms_per_call")(ctx) == pytest.approx(1000)
    assert _reader("moe_ms_per_call")(ctx) == pytest.approx(300)
    assert _reader("device_idle_pct.score")(ctx) == pytest.approx(25.0)
    for name in ("score_mfu", "moe_grouped_mm_roofline",
                 "mla_attention_ms_per_call", "moe_ms_per_call",
                 "device_idle_pct.score"):
        assert _reader(name)({"calls": 3, "calls_traced": 0}) is None


@pytest.mark.parametrize("name, grouped", [
    ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9x"
     "INS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5tuple",
     True),
    ("void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t>",
     True),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>",
     False),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "index_copy_kernel_impl", False)])
def test_the_roofline_finds_the_grouped_gemms_kernels_by_name(name, grouped):
    """The reader counts the library's grouped GEMM (its CUTLASS kernel
    over a ``GroupProblemShape``) and its setup, and no other product."""
    from run import _reader
    from yardstick.trace import Trace

    trace = Trace([(name, 0.0, 0.002, False)], [], (0.0, 1.0), 1)
    ctx = {"trace": trace, "calls_traced": 1,
           "bound_s": {"call": 0.19, "grouped_mm": 0.001}}
    got = _reader("moe_grouped_mm_roofline")(ctx)
    assert got == (pytest.approx(50.0) if grouped else None)


def test_every_number_that_decides_correct_has_its_reason():
    cell = spec.load_cell(WORKLOAD)
    path = spec.file_of("limits", WORKLOAD, ".why.json")
    with open(path) as f:
        why = json.load(f)
    assert set(why) == set(cell.limits) | {"tail_gap"}
    assert all(isinstance(v, str) and len(v) > 40 for v in why.values())
    assert os.path.basename(path) == WORKLOAD + ".why.json"


def test_span_device_time_is_the_work_inside_each_spans_shadow():
    """A span's shadow on the device bounds the work it launched: the
    kernels and copies inside it count, the rest not, overlaps once."""
    from torch.autograd import DeviceType

    class Range:
        def __init__(self, s, t):
            self.start, self.end = s * 1e6, t * 1e6

    class Event:
        def __init__(self, name, s, t, device="cuda", annotation=False):
            self.name, self.time_range = name, Range(s, t)
            self.device_type = (DeviceType.CUDA if device == "cuda"
                                else DeviceType.CPU)
            self.is_user_annotation = annotation
            self.device_time_total = 0.0

    class Prof:
        def events(self):
            return [Event("lm.attention", 0.0, 1.0, annotation=True),
                    Event("k1", 0.0, 0.4), Event("Memcpy DtoD", 0.3, 0.6),
                    Event("lm.moe", 1.0, 1.5, annotation=True),
                    Event("k2", 1.1, 1.3), Event("k3", 1.6, 2.0),
                    Event("lm.attention", 1.5, 2.5, annotation=True),
                    Event("k4", 2.2, 2.3),
                    Event("lm.attention", 0.0, 9.0, device="cpu")]

    got = loop.span_device_s(Prof())
    assert got["lm.attention"] == pytest.approx(0.6 + 0.4 + 0.1)
    assert got["lm.moe"] == pytest.approx(0.2)
