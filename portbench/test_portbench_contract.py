"""A configuration of another model family enters the benchmark as new
files: written into a copy of the layout, the port's granite-moe LM (cut
in depth, bfloat16 leaves, a ``tiny`` form at ``configs/granite_moe_1b.py``
``reduced()`` with its heads, experts per token and vocabulary) passes the
checks every configuration is held to, ``inputs.build_model`` builds and
fills its tiny form on the CPU, and its tiny cell runs through
``run.execute`` with a stand-in scoring loop whose plain reference reads
the model's sizes from the cell's configuration and agrees with the
program. The same checks refuse the faults they exist for; the click
configurations' tiny cells are what they were; a 16-bit leaf holds the
seed's values rounded once."""
import copy
import dataclasses
import json
import os
import sys
import types

import pytest
import torch
import torch.nn.functional as F

import contract
import run
import tiny
from repro_torch.configs import granite_moe_1b
from repro_torch.models.lm import transformer
from yardstick import inputs, spec, weights
from yardstick.outcome import Outcome

SEED = 3_000_000_023  # more than 32 signed bits hold
NAME = "granite-moe-1b-a400m"
WORKLOAD = NAME + ".score_4k"
LOOP = "witness_score"
ENTRY = {
    "name": NAME,
    "source": "https://huggingface.co/ibm-granite/granite-3.0-1b-a400m-base",
    "file": f"portbench/configs/{NAME}.json",
    "reduced": ["num_hidden_layers"],
    "why": "The contract's witness: a decoder LM with sparse experts, "
           "bfloat16 leaves, cut in depth"}
LAYERS = 12
#: The witness cell's limit on the widest gap of a scored token's log P,
#: the program against the float64 reference: the sound tiny cell reads
#: 5.9e-7 to 1.26e-6 over six seeds and both router dtypes; a reference
#: that reads the full-size heads, top-k or rope theta reads 0.21 or more.
LIMIT = 1e-4


def _granite(cfg, router=None):
    """A builder ``(kind, device)`` of the program's LM at ``cfg``, its
    routers' leaf in ``router`` where given (a float32 leaf beside
    bfloat16 ones); the model carries ``cfg`` for the scoring entry. It
    computes in float32 over its bfloat16 leaves, so that the witness's
    gap is the harness's and not bfloat16's, which flips near-tied
    experts."""
    cfg = dataclasses.replace(cfg, dtype=torch.float32)

    def build(kind, device):
        model = transformer.init_params(cfg, device=device)
        if router is not None:
            model.moe["router"] = torch.nn.Parameter(
                model.moe["router"].detach().to(router))
        model.lm_config = cfg
        return model
    return build


full_model = _granite(dataclasses.replace(granite_moe_1b.FULL,
                                          n_layers=LAYERS))
tiny_model = _granite(granite_moe_1b.reduced())
full_model_router_f32 = _granite(dataclasses.replace(
    granite_moe_1b.FULL, n_layers=LAYERS), torch.float32)
tiny_model_router_f32 = _granite(granite_moe_1b.reduced(), torch.float32)


def _stack(U, D, kv, E, F_, vocab):
    return {"embed": [vocab, D], "ln_f": [D], "lm_head": [D, vocab],
            "moe/ln1": [U, D], "moe/ln2": [U, D], "moe/wq": [U, D, D],
            "moe/wk": [U, D, kv], "moe/wv": [U, D, kv], "moe/wo": [U, D, D],
            "moe/router": [U, D, E], "moe/we_gate": [U, E, D, F_],
            "moe/we_up": [U, E, D, F_], "moe/we_down": [U, E, F_, D]}


def _start(path):
    """A leaf's center and spread: norms about 1, the embedding about
    unit size, the router decisive, the other matrices about
    1 / sqrt(64), so that heads and routing shape the answer."""
    if "ln" in path:
        return 1.0, 0.1
    return 0.0, {"embed": 1.0, "moe/router": 0.5}.get(path, 0.2)


def _witness(router="bfloat16"):
    """The configuration file as its author would write it."""
    leaves = {}
    for p, s in _stack(LAYERS, 1024, 512, 32, 512, 49168).items():
        center, spread = _start(p)
        leaves[p] = {"shape": s, "center": center, "spread": spread}
    suffix = "" if router == "bfloat16" else "_router_f32"
    if router != "bfloat16":
        leaves["moe/router"]["dtype"] = router
    return {
        "name": NAME, "source": ENTRY["source"],
        "deployment": "granite-moe-1b-a400m scoring on one card, the other "
                      "12 layers on a second card as a pipeline stage",
        "builder": f"{__name__}.full_model{suffix}",
        "kind": "lm", "reference": "witness_lm", "dtype": "bfloat16",
        "hidden_size": 1024, "num_attention_heads": 16,
        "num_key_value_heads": 8, "num_local_experts": 32,
        "num_experts_per_tok": 8, "intermediate_size": 512,
        "vocab_size": 49155, "num_hidden_layers": LAYERS,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "published": {"num_hidden_layers": 24},
        "leaves": leaves,
        "tiny": {
            "builder": f"{__name__}.tiny_model{suffix}",
            "leaves": _stack(2, 64, 32, 8, 64, 224),
            "config": {"hidden_size": 64, "num_attention_heads": 4,
                       "num_key_value_heads": 2, "num_local_experts": 8,
                       "num_experts_per_tok": 2, "intermediate_size": 64,
                       "vocab_size": 211, "num_hidden_layers": 2,
                       "rope_theta": 500000.0},
            "traffic": {"score-4k": {"batch": 2, "seq": 16}}}}


def _layout(root, entries, configs):
    """``BENCHMARK.json`` and portbench's folders under ``root``: the
    entries and their files, the witness's cells, mixes and limits."""
    for sub in ("configs", "traffic", "limits", "held"):
        os.makedirs(os.path.join(root, "portbench", sub), exist_ok=True)
    for entry, config in zip(entries, configs):
        with open(os.path.join(root, entry["file"]), "w") as f:
            json.dump(config, f)
    mixes = {"score-4k": {"loop": LOOP, "batch": 8, "seq": 4096},
             "train-4k": {"loop": "train", "batch": 256, "seq": 4096}}
    for mix, traffic in mixes.items():
        with open(spec.file_of("traffic", mix, root=str(root)), "w") as f:
            json.dump(traffic, f)
    cells = [{"name": f"{NAME}.{m.replace('-', '_')}", "config": NAME,
              "traffic": m, "chips": 1, "why": "the witness"} for m in mixes]
    for cell in cells:
        with open(spec.file_of("limits", cell["name"], root=str(root)),
                  "w") as f:
            json.dump({"logp_gap": LIMIT}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump({"configs": entries, "workloads": cells, "end_to_end": [],
                   "per_layer": []}, f)


# --------------------------------------------------------------------------
# The stand-in scoring loop and its plain reference
# --------------------------------------------------------------------------

def _tokens(config, traffic, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, config["vocab_size"],
                         (traffic["batch"], traffic["seq"]), generator=g)


def _program_logp(model, tokens):
    """The program's log P of each next token, ``(B, S - 1)``."""
    cfg = model.lm_config
    logits = transformer.forward(cfg, model, tokens)[..., :cfg.vocab]
    logp = torch.log_softmax(logits.float(), -1)
    return logp[:, :-1].gather(-1, tokens[:, 1:, None])[..., 0]


def _reference_logp(config, seed, tokens):
    """The same log Ps in float64, from the configuration's numbers and
    each leaf's start as ``weights.rounded`` gives it: nothing of the
    program's."""
    table = weights.leaf_table(config)

    def leaf(path):
        t = table[path]
        n = int(torch.tensor(t["shape"]).prod())
        return weights.rounded(seed, t["index"], torch.arange(n),
                               t["center"], t["spread"],
                               getattr(torch, t["dtype"])
                               ).double().reshape(t["shape"])

    D, H = config["hidden_size"], config["num_attention_heads"]
    Hkv, Dh = config["num_key_value_heads"], D // H
    E, k = config["num_local_experts"], config["num_experts_per_tok"]
    eps, B, S = config["rms_norm_eps"], *tokens.shape
    half = Dh // 2
    freqs = config["rope_theta"] ** (-torch.arange(
        half, dtype=torch.float64) / half)
    angles = torch.arange(S, dtype=torch.float64)[:, None] * freqs
    cos, sin = angles.cos()[None, :, None], angles.sin()[None, :, None]

    def norm(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w

    def rope(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    st = {p.split("/")[1]: leaf(p) for p in table if p.startswith("moe/")}
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    h = leaf("embed")[tokens]
    for u in range(config["num_hidden_layers"]):
        x = norm(h, st["ln1"][u])
        q = rope((x @ st["wq"][u]).view(B, S, H, Dh))
        kk = rope((x @ st["wk"][u]).view(B, S, Hkv, Dh))
        v = (x @ st["wv"][u]).view(B, S, Hkv, Dh)
        kk, v = (t.repeat_interleave(H // Hkv, 2) for t in (kk, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / Dh ** 0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        h = h + torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, D) \
            @ st["wo"][u]
        x = norm(h, st["ln2"][u])
        top_p, top_i = torch.softmax(x @ st["router"][u], -1).topk(k, -1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        for e in range(E):
            w = (top_p * (top_i == e)).sum(-1, keepdim=True)
            h = h + w * ((F.silu(x @ st["we_gate"][u, e])
                          * (x @ st["we_up"][u, e])) @ st["we_down"][u, e])
    logits = norm(h, leaf("ln_f")) @ leaf("lm_head")[:, :config["vocab_size"]]
    logp = torch.log_softmax(logits, -1)
    return logp[:, :-1].gather(-1, tokens[:, 1:, None])[..., 0]


def _score_run(cell, seed, seconds, trace, device="cpu", builder=None,
               t_process=None):
    """A loop as a scoring cell's would be, at the cell's sizes: the
    model built and filled from the seed, tokens drawn below the
    configuration's vocabulary, the program's log Ps held to the
    reference's."""
    model = inputs.build_model(cell.config, seed, device, builder)
    tokens = _tokens(cell.config, cell.traffic, seed)
    with torch.no_grad():
        got = _program_logp(model, tokens).double()
    gap = float((got - _reference_logp(cell.config, seed, tokens)).abs()
                .max())
    return Outcome(e2e={}, ctx={}, gaps={"logp_gap": gap},
                   attempted=tokens.shape[0], failed=0, memory_peak_bytes=0)


@pytest.fixture()
def witness_loop(monkeypatch):
    """The stand-in loop, where ``run.execute`` looks for the mix's
    ``loop``."""
    loop = types.ModuleType(f"loops.{LOOP}")
    loop.run = _score_run
    monkeypatch.setitem(sys.modules, f"loops.{LOOP}", loop)


# --------------------------------------------------------------------------
# The witness
# --------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _holds_the_seeds_values(model, config):
    params = inputs.leaf_params(model)
    for path, leaf in weights.leaf_table(config).items():
        p = params[path].detach().reshape(-1)
        assert str(p.dtype) == "torch." + leaf["dtype"], path
        want = weights.rounded(SEED, leaf["index"], torch.arange(p.numel()),
                               leaf["center"], leaf["spread"], p.dtype)
        assert torch.equal(_bits(p), _bits(want)), path


@pytest.mark.parametrize("router", ["bfloat16", "float32"])
def test_another_family_enters_as_new_files(tmp_path, router, witness_loop):
    config = _witness(router)
    _layout(tmp_path, [ENTRY], [config])
    assert contract.configuration_faults(ENTRY, str(tmp_path)) == []
    assert contract.build_faults(config) == []

    cell = tiny.cell(WORKLOAD, str(tmp_path))
    assert cell.traffic == {"loop": LOOP, "batch": 2, "seq": 16}
    assert cell.config["leaves"]["embed"]["shape"] == [224, 64]
    small = config["tiny"]["config"]
    assert {k: cell.config[k] for k in small} == small
    model = inputs.build_model(cell.config, SEED, "cpu", tiny.builder)
    _holds_the_seeds_values(model, cell.config)
    dtypes = {str(p.dtype) for p in model.parameters()}
    assert dtypes == {"torch.bfloat16", "torch." + router}

    result, lines = run.execute(cell, SEED, 0.3, False, device="cpu",
                                builder=tiny.builder)
    assert result["correct"], lines
    assert 0 < result["checks"]["logp_gap"]["value"] <= LIMIT / 10, lines


def test_a_tiny_form_runs_only_the_mixes_it_names(tmp_path):
    """A mix the tiny form does not name has no tiny form: ``tiny.cell``
    refuses it rather than hand a CPU test its full size."""
    _layout(tmp_path, [ENTRY], [_witness()])
    with pytest.raises(ValueError, match="names no mix 'train-4k'"):
        tiny.cell(NAME + ".train_4k", str(tmp_path))


@pytest.mark.parametrize("keys", [
    ("num_attention_heads", "num_key_value_heads"),
    ("num_experts_per_tok",), ("rope_theta",)])
def test_the_witness_fails_with_a_full_size_key(tmp_path, keys,
                                                witness_loop):
    """Shapes do not tell the reference the heads, the top-k or the rope's
    theta: where the tiny form leaves them at their full size, the
    reference computes another model and the cell comes out not
    correct."""
    config = _witness()
    for key in keys:
        del config["tiny"]["config"][key]
    _layout(tmp_path, [ENTRY], [config])
    result, lines = run.execute(tiny.cell(WORKLOAD, str(tmp_path)), SEED,
                                0.3, False, device="cpu",
                                builder=tiny.builder)
    assert not result["correct"], lines
    assert result["checks"]["logp_gap"]["value"] > 1000 * LIMIT, lines


def test_the_witness_fails_with_the_full_vocabulary(tmp_path, witness_loop):
    """Tokens drawn below the full vocabulary lie past the tiny embedding's
    rows: the run raises, and prints no result."""
    config = _witness()
    del config["tiny"]["config"]["vocab_size"]
    _layout(tmp_path, [ENTRY], [config])
    with pytest.raises(IndexError):
        run.execute(tiny.cell(WORKLOAD, str(tmp_path)), SEED, 0.3, False,
                    device="cpu", builder=tiny.builder)


# --------------------------------------------------------------------------
# The faults the checks refuse
# --------------------------------------------------------------------------

def _click_entry_and_file():
    entry = next(e for e in spec.benchmark()["configs"]
                 if e["name"] == "clax-dbn-baidu")
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        return dict(entry), json.load(f)


def test_the_contract_refuses_a_hashed_table_of_the_wrong_rows(tmp_path):
    entry, config = _click_entry_and_file()
    _layout(tmp_path, [entry], [config])
    assert contract.configuration_faults(entry, str(tmp_path)) == []
    config["leaves"]["satisfaction/table"]["shape"] = [214748160, 1]
    _layout(tmp_path, [entry], [config])
    faults = contract.configuration_faults(entry, str(tmp_path))
    assert len(faults) == 1 and "satisfaction/table" in faults[0], faults


@pytest.mark.parametrize("fault", ["no_published_value", "not_in_the_file",
                                   "the_published_value"])
def test_the_contract_refuses_a_reduced_key_unwritten(tmp_path, fault):
    entry, config = copy.deepcopy(ENTRY), _witness()
    if fault == "no_published_value":
        del config["published"]
    elif fault == "not_in_the_file":
        entry["reduced"] = ["num_layers"]
    else:
        config["num_hidden_layers"] = 24
    _layout(tmp_path, [entry], [config])
    faults = contract.configuration_faults(entry, str(tmp_path))
    assert len(faults) == 1 and "reduced key" in faults[0], faults


@pytest.mark.parametrize("value", [{"n_heads": 4}, {"leaves": 4},
                                   {"num_attention_heads": "4"}])
def test_the_contract_refuses_a_tiny_config_key_unwritten(tmp_path, value):
    """A tiny form gives a number only to a key whose number the file
    gives: no key of its own, no group, no text."""
    config = _witness()
    config["tiny"]["config"].update(value)
    _layout(tmp_path, [ENTRY], [config])
    faults = contract.configuration_faults(ENTRY, str(tmp_path))
    assert len(faults) == 1 and "tiny's config" in faults[0], faults


def test_the_contract_refuses_a_leaf_of_the_wrong_dtype(tmp_path):
    config = _witness()
    config["leaves"]["moe/router"]["dtype"] = "float32"
    _layout(tmp_path, [ENTRY], [config])
    assert contract.configuration_faults(ENTRY, str(tmp_path)) == []
    faults = contract.build_faults(config)
    assert len(faults) == 2 and all("moe/router" in f for f in faults)
    cell = tiny.cell(WORKLOAD, str(tmp_path))
    with pytest.raises(ValueError, match="moe/router"):
        inputs.build_model(cell.config, SEED, "cpu", tiny.builder)


# --------------------------------------------------------------------------
# The click cells, and the rounding of a 16-bit leaf
# --------------------------------------------------------------------------

CLICK = {
    "dbn": {"attraction/table": [2048, 1], "attraction/baseline": [1],
            "satisfaction/table": [2048, 1], "satisfaction/baseline": [1],
            "continuation/value": []},
    "ubm": {"attraction/table": [2048, 1], "attraction/baseline": [1],
            "examination/table": [10, 10]}}


@pytest.mark.parametrize("workload", [
    "clax-dbn-baidu.serve_bulk", "clax-ubm-baidu.serve_bulk",
    "clax-dbn-baidu.train", "clax-ubm-baidu.train"])
def test_tiny_click_cells_are_what_they_were(workload):
    """Without a tiny form a configuration gets the click defaults: its
    hashed tables at 2,048 rows and the mix cut by its loop."""
    full = spec.load_cell(workload)
    cell = tiny.cell(workload)
    want = dict(full.traffic, sessions=2048, n_queries=60, batch=64)
    if full.traffic["loop"] == "train":
        want.update(chunk_batches=2, warmup_chunks=1)
    else:
        want.update(batches=4, warmup_calls=4)
    assert cell.traffic == want
    shapes = {p: leaf["shape"] for p, leaf in cell.config["leaves"].items()}
    assert shapes == CLICK[full.config["kind"]]
    for path, leaf in cell.config["leaves"].items():
        assert {**leaf, "shape": None} == {**full.config["leaves"][path],
                                           "shape": None}
    assert {k: v for k, v in cell.config.items() if k != "leaves"} == {
        k: v for k, v in full.config.items() if k != "leaves"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_a_16_bit_leaf_holds_the_seeds_values_rounded_once(dtype):
    """``build_model`` fills a 16-bit leaf with the float32 values rounded
    to its type, bit for bit what ``weights.rounded`` gives a reference;
    not the float32 values cut short."""
    config = tiny.config(_witness())
    for leaf in config["leaves"].values():
        leaf["dtype"] = str(dtype).split(".")[1]

    def builder(cfg, device):
        return tiny.builder(cfg, device).to(dtype)

    model = inputs.build_model(config, SEED, "cpu", builder)
    _holds_the_seeds_values(model, config)
    if dtype == torch.bfloat16:  # rounded, not the float32 bits cut short
        leaf = weights.leaf_table(config)["moe/we_gate"]
        got = inputs.leaf_params(model)["moe/we_gate"].detach().reshape(-1)
        exact = weights.values(SEED, leaf["index"], torch.arange(
            got.numel()), leaf["center"], leaf["spread"])
        cut = (exact.view(torch.int32) & ~0xFFFF).view(torch.float32)
        assert not torch.equal(got, cut.to(dtype))
