"""Serving: the port against JAX on the CPU.

Every test of ``tests/test_serve.py`` is mirrored here on the port
(``repro_torch.serve``, ``repro_torch.testing``'s serving faults) under
the same name, and the port is held against ``repro.serve`` on the same
numpy inputs:

* ``make_request`` / ``poisson_trace`` equal, and every poison mode
  rejected with JAX's reason;
* ``quantize_int8`` / ``quantize_tree``'s ``q`` and ``scale`` equal to the
  bit, ``tree_nbytes`` equal;
* each tier's ``log_ctr`` within 1e-5 of JAX's ``ModelEntry.run`` for PBM,
  DBN and the reduced two-tower PBM (its feature tower through
  ``dcn_cross``'s plain form);
* the int8 tier's gather-first lookup equal to the bit to
  dequantize-then-gather;
* the virtual-clock chaos drill's full signature and counters equal to
  JAX's;
* ``launch/serve.py --virtual-time`` against ``repro.launch.serve`` with
  the same flags: summaries and counters equal.

The module's registry captures through a stand-in graph backend (a replay
runs the captured body over the static buffers, as in
``test_torch_train.py``), so the capture discipline runs here: one capture
per (tier, bucket) at warmup, none under traffic, the static buffers
reused, no reference cycle through an entry.
"""
import gc
import json
import signal
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import core as jcore
from repro import obs as jobs
from repro import serve as jserve
from repro import testing as jtesting
from repro.distrib import compression as jcomp
from repro.launch import serve as jax_launch
from repro_torch import core as tcore
from repro_torch import obs
from repro_torch.configs import clax_baidu
from repro_torch.convert import load_jax_params
from repro_torch.core.parameterization import (EmbeddingParameter,
                                               EmbeddingParameterConfig,
                                               int8_lookups)
from repro_torch.distrib import (QuantizedTensor, dequantize_int8,
                                 dequantize_tree, quantize_int8,
                                 quantize_tree, tree_nbytes)
from repro_torch.launch import serve as torch_launch
from repro_torch.serve import (ADMIT, ADMIT_BACKPRESSURE, CLOSED, HALF_OPEN,
                               OPEN, SHED_OVERLOAD, SHED_QUEUE_FULL, TIERS,
                               AdmissionQueue, CircuitBreaker,
                               DeadlineBatcher, DegradationLadder,
                               ModelRegistry, ServeEngine, ServiceModel,
                               VirtualClock, make_request, pad_batch,
                               poisson_trace, validate_request)
from repro_torch.testing import (POISON_MODES, PoisonTrace, ServeKillSwitch,
                                 SlowModel, poison_request)
from repro_torch.train.engine import call_with

N_PAIRS = 500
K = 10
BUCKETS = (1, 4, 16)
MODELS = ("pbm", "dbn")
REL, ABS = 1e-5, 1e-6
FEATURES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandIn:
    """Stand-in graphs: a capture keeps the body, a replay runs it over the
    static buffers; counts captures and replays."""

    class Graph:
        def __init__(self, fn, owner):
            self.fn, self.owner = fn, owner

        def replay(self):
            self.owner.replays += 1
            self.fn()

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.captures += 1
        return self.Graph(fn, self)


def _perturbed_params(model, seed=0):
    """Fresh-init params are constant per leaf (quantization would be
    exact); perturb so the int8 tier has a real error to measure (JAX's
    tests' helper)."""
    params = model.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    out = [l + 0.5 * jax.random.normal(k, l.shape, l.dtype)
           if jnp.issubdtype(l.dtype, jnp.floating) else l
           for l, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, out)


def _jax_model(name):
    if name == "two_tower":
        return jcore.PositionBasedModel(
            positions=K, attraction=jcore.DeepCrossParameterConfig(
                features=FEATURES, cross_layers=2, deep_layers=2))
    return jcore.MODEL_REGISTRY[name](query_doc_pairs=N_PAIRS, positions=K)


def _torch_model(name):
    if name == "two_tower":
        return clax_baidu.make_two_tower("pbm", features=FEATURES,
                                         device="cpu")
    return tcore.MODEL_REGISTRY[name](query_doc_pairs=N_PAIRS, positions=K,
                                      device="cpu")


def _pair(name, jreg, treg):
    """The same perturbed parameters served by JAX's and the port's
    registries."""
    jm = _jax_model(name)
    params = _perturbed_params(jm)
    feature_dim = FEATURES if name == "two_tower" else None
    jreg.add(name, jm, params, n_pairs=N_PAIRS, quantize_min_size=64,
             feature_dim=feature_dim)
    treg.add(name, _torch_model(name), jax.device_get(params),
             n_pairs=N_PAIRS, quantize_min_size=64, feature_dim=feature_dim)


@pytest.fixture(scope="module")
def registries():
    """JAX's registry and the port's (through the stand-in graphs), with
    JAX's test models and parameters, warmed up."""
    jreg = jserve.ModelRegistry(buckets=BUCKETS,
                                service_model=jserve.ServiceModel())
    treg = ModelRegistry(buckets=BUCKETS, service_model=ServiceModel(),
                         backend=StandIn())
    for name in MODELS:
        _pair(name, jreg, treg)
    jreg.warmup()
    treg.warmup()
    return jreg, treg


@pytest.fixture(scope="module")
def registry(registries):
    return registries[1]


def _engine(registry, **kw):
    kw.setdefault("clock", VirtualClock())
    return ServeEngine(registry, **kw)


def _req(request_id=0, model="pbm", deadline_s=0.2, arrival_s=0.0, seed=0):
    return make_request(request_id, model, K, np.random.default_rng(seed),
                        N_PAIRS, deadline_s=deadline_s, arrival_s=arrival_s)


def _trace(n, qps=300.0, deadline_s=0.05, seed=1, models=MODELS):
    return poisson_trace(n, qps=qps, models=list(models), positions_k=K,
                         n_pairs=N_PAIRS, deadline_s=deadline_s, seed=seed)


def _signature(results):
    return [(r.request_id, r.status, r.tier, r.reason) for r in results]


# -- requests and traces against JAX -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_request_and_poisson_trace_equal_jax(seed):
    a = make_request(3, "pbm", K, np.random.default_rng(seed), N_PAIRS,
                     deadline_s=0.1, arrival_s=0.5)
    b = jserve.make_request(3, "pbm", K, np.random.default_rng(seed),
                            N_PAIRS, deadline_s=0.1, arrival_s=0.5)
    for field in ("positions", "query_doc_ids", "mask"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.deadline_s, a.arrival_s) == (b.deadline_s, b.arrival_s)
    ours = poisson_trace(50, qps=200.0, models=list(MODELS), positions_k=K,
                         n_pairs=N_PAIRS, deadline_s=0.05, seed=seed)
    theirs = jserve.poisson_trace(50, qps=200.0, models=list(MODELS),
                                  positions_k=K, n_pairs=N_PAIRS,
                                  deadline_s=0.05, seed=seed)
    assert [(r.request_id, r.model, r.arrival_s, r.deadline_s,
             r.query_doc_ids.tolist()) for r in ours] == [
        (r.request_id, r.model, r.arrival_s, r.deadline_s,
         r.query_doc_ids.tolist()) for r in theirs]


@pytest.mark.parametrize("mode", POISON_MODES)
def test_poison_mode_rejected_with_jax_reason(mode):
    i = POISON_MODES.index(mode)
    ours = validate_request(poison_request(_req(seed=i), mode, seed=i),
                            positions=K, n_pairs=N_PAIRS, feature_dim=None)
    theirs = jserve.validate_request(
        jtesting.poison_request(jserve.make_request(
            0, "pbm", K, np.random.default_rng(i), N_PAIRS), mode, seed=i),
        positions=K, n_pairs=N_PAIRS, feature_dim=None)
    assert ours is not None and ours == theirs


# -- int8 quantization against JAX ---------------------------------------------

@pytest.mark.parametrize("shape,scale", [((1000, 1), 1.0), ((37,), 1e-3),
                                         ((64, 8), 40.0), ((5,), 0.0)])
def test_quantize_int8_equals_jax_to_the_bit(shape, scale):
    x = (np.random.default_rng(3).normal(size=shape) * scale).astype(
        np.float32)
    if x.size >= 3 and scale:  # ties, which both round half to even
        x.flat[:3] = np.float32(np.abs(x).max()) / 127 * np.float32(
            [0.5, -1.5, 2.5])
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.float32(s).tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))


@pytest.mark.parametrize("min_size", [64, 512])
def test_quantize_tree_and_nbytes_equal_jax(min_size):
    params = jax.device_get(_perturbed_params(_jax_model("dbn")))
    ours = quantize_tree(params, min_size=min_size)
    theirs = jcomp.quantize_tree(params, min_size=min_size)
    assert tree_nbytes(ours) == jcomp.tree_nbytes(theirs)
    assert tree_nbytes(params) == jcomp.tree_nbytes(params)
    for part, leaves in theirs.items():
        for name, leaf in leaves.items():
            mine = ours[part][name]
            if isinstance(leaf, jcomp.QuantizedTensor):
                assert isinstance(mine, QuantizedTensor)
                np.testing.assert_array_equal(mine.q.numpy(),
                                              np.asarray(leaf.q))
                assert np.float32(mine.scale).tobytes() == np.asarray(
                    leaf.scale).tobytes()
            else:
                assert not isinstance(mine, QuantizedTensor)
    back = dequantize_tree(ours)
    jback = jax.device_get(jcomp.dequantize_tree(theirs))
    for part, leaves in jback.items():
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(np.asarray(back[part][name]), leaf)


# -- the tiers against JAX -------------------------------------------------------

def _requests(name, n, seed):
    rng = np.random.default_rng(seed)
    reqs = [make_request(i, name, K, rng, N_PAIRS) for i in range(n)]
    if name == "two_tower":
        for r in reqs:
            r.features = rng.normal(size=(K, FEATURES)).astype(np.float32)
    return reqs


@pytest.mark.parametrize("eager", [False, True], ids=["captured", "eager"])
@pytest.mark.parametrize("name", ["pbm", "dbn", "two_tower"])
def test_each_tier_log_ctr_matches_jax(name, eager):
    """Every tier and bucket, the port's entry (captured through the
    stand-in graphs, or eager as on the CPU) against JAX's ModelEntry.run
    on the same padded batch: 1e-5."""
    jreg = jserve.ModelRegistry(buckets=BUCKETS)
    treg = ModelRegistry(buckets=BUCKETS,
                         backend=None if eager else StandIn())
    _pair(name, jreg, treg)
    jentry, tentry = jreg[name], treg[name]
    assert (tentry.primary_nbytes, tentry.int8_nbytes) == (
        jentry.primary_nbytes, jentry.int8_nbytes)
    assert tentry.int8_nbytes < tentry.primary_nbytes
    for bucket in BUCKETS:
        reqs = _requests(name, min(bucket, 3), seed=bucket)
        batch = pad_batch(reqs, bucket, tentry)
        jbatch = jserve.pad_batch(reqs, bucket, jentry)
        for k in jbatch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        for tier in TIERS:
            ours = tentry.run(tier, batch)
            assert ours.shape == (bucket, K) and ours.dtype == np.float32
            np.testing.assert_allclose(ours, jentry.run(tier, jbatch),
                                       rtol=REL, atol=ABS, err_msg=tier)
    assert tentry.trace_counts == ({"primary": 0, "int8": 0} if eager else
                                   {"primary": 3, "int8": 3})


@pytest.mark.parametrize("compression", ["none", "hash"])
def test_int8_gather_first_equals_dequantize_then_gather(compression):
    """The int8 lookup gathers int8 rows and widens them: equal to the bit
    to widening the table first, for the part and the whole model."""
    cfg = EmbeddingParameterConfig(
        parameters=4096, compression=compression, compression_ratio=4.0,
        baseline_correction=True, init_logit=-1.0)
    part = EmbeddingParameter(cfg, device="cpu")
    with torch.no_grad():
        part.table.copy_(torch.from_numpy(np.random.default_rng(0).normal(
            size=tuple(part.table.shape)).astype(np.float32)))
    batch = {"query_doc_ids": torch.from_numpy(np.random.default_rng(1)
                                               .integers(0, 4096, (64, K)))}
    q, s = quantize_int8(part.table.detach())
    with int8_lookups([(part, {"table": (q, s)})]):
        gathered = part(batch)
    assert part.int8 is None
    widened = call_with(part, ["table"], [dequantize_int8(q, s)], "forward",
                        batch)
    assert torch.equal(gathered, widened)

    reg = ModelRegistry(buckets=(4,))
    model = _torch_model("dbn")
    reg.add("dbn", model, jax.device_get(_perturbed_params(_jax_model(
        "dbn"))), n_pairs=N_PAIRS, quantize_min_size=64)
    entry = reg["dbn"]
    batch = pad_batch(_requests("dbn", 3, seed=2), 4, entry)
    names = list(entry.qparams)
    whole = call_with(model, names, [dequantize_tree(entry.qparams)[n]
                                     for n in names], "predict_clicks",
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(entry.run("int8", batch),
                                  whole.detach().numpy())


def test_capture_discipline_one_graph_per_tier_and_bucket(registry):
    """Warmup captured one graph per (model, tier, bucket); traffic
    captures none, replays with one copy per input into the same static
    buffers; a dropped registry frees its entries with the collector
    off."""
    backend = registry.backend
    assert backend.captures == len(MODELS) * 2 * len(BUCKETS)
    buffers = {name: {key: (tuple(v.data_ptr() for v in r.host.values()),
                            tuple(v.data_ptr() for v in r.device.values()),
                            r.out.data_ptr())
                      for key, r in registry[name]._replays.items()}
               for name in MODELS}
    assert all(len(b) == 2 * len(BUCKETS) for b in buffers.values())
    replays = backend.replays
    dispatches = sum(registry[m].dispatches for m in MODELS)
    eng = _engine(registry)
    results = eng.run_trace(_trace(40, seed=11), handle_signals=False)
    assert all(r.answered and r.tier == "primary" for r in results)
    assert backend.captures == len(MODELS) * 2 * len(BUCKETS)
    # one replay per dispatch, into the buffers warmup made
    assert backend.replays - replays == sum(
        registry[m].dispatches for m in MODELS) - dispatches > 0
    assert {name: {key: (tuple(v.data_ptr() for v in r.host.values()),
                         tuple(v.data_ptr() for v in r.device.values()),
                         r.out.data_ptr())
                   for key, r in registry[name]._replays.items()}
            for name in MODELS} == buffers

    reg = ModelRegistry(buckets=(1,), backend=StandIn())
    reg.add("pbm", _torch_model("pbm"), None, n_pairs=N_PAIRS)
    reg.warmup()
    entry = weakref.ref(reg["pbm"])
    collecting = gc.isenabled()
    gc.disable()
    try:
        del reg
        assert entry() is None
    finally:
        if collecting:
            gc.enable()


def test_serve_bulk_equals_predict_clicks():
    model = _torch_model("dbn")
    load_jax_params(model, jax.device_get(_perturbed_params(
        _jax_model("dbn"))))
    rng = np.random.default_rng(0)
    batch = {"positions": np.tile(np.arange(1, K + 1, dtype=np.int32),
                                  (64, 1)),
             "query_doc_ids": rng.integers(0, N_PAIRS, (64, K)).astype(
                 np.int32),
             "mask": rng.random((64, K)) < 0.9}
    out = clax_baidu.serve_bulk(model, batch)
    with torch.no_grad():
        want = model.predict_clicks({k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    np.testing.assert_array_equal(out, want.numpy())
    assert clax_baidu.SHAPES["serve_bulk"] == dict(batch=262144,
                                                   kind="serve")


# -- validation (tests/test_serve.py, mirrored) --------------------------------

def test_validator_accepts_wellformed():
    assert validate_request(_req(), positions=K, n_pairs=N_PAIRS) is None


def test_validator_rejects_every_poison_mode():
    for i, mode in enumerate(POISON_MODES):
        bad = poison_request(_req(seed=i), mode, seed=i)
        reason = validate_request(bad, positions=K, n_pairs=N_PAIRS)
        assert reason is not None, f"mode {mode} slipped through"
        assert isinstance(reason, str)


def test_validator_feature_dim_contract():
    req = _req()
    assert validate_request(req, positions=K, n_pairs=N_PAIRS,
                            feature_dim=4) is not None
    req.features = np.zeros((K, 4), np.float32)
    assert validate_request(req, positions=K, n_pairs=N_PAIRS,
                            feature_dim=4) is None
    req.features = np.zeros((K, 3), np.float32)
    assert validate_request(req, positions=K, n_pairs=N_PAIRS,
                            feature_dim=4) is not None


@settings(max_examples=60)
@given(st.lists(st.integers(min_value=-10 ** 12, max_value=10 ** 12),
                min_size=0, max_size=2 * K),
       st.floats(min_value=-1e6, max_value=1e6),
       st.integers(min_value=0, max_value=len(POISON_MODES) - 1))
def test_validator_fuzz_total_function(ids, deadline, mode_i):
    """The validator is total, and gives JAX's answer on the same junk."""
    req = _req()
    req.query_doc_ids = np.asarray(ids)
    req.deadline_s = deadline
    out = validate_request(req, positions=K, n_pairs=N_PAIRS)
    assert out == jserve.validate_request(req, positions=K, n_pairs=N_PAIRS)
    assert out is None or isinstance(out, str)
    if len(ids) != K:
        assert out is not None
    elif any(i < 0 or i >= N_PAIRS for i in ids):
        assert out is not None
    mutated = poison_request(_req(), POISON_MODES[mode_i], seed=abs(int(
        deadline)) % 997)
    out2 = validate_request(mutated, positions=K, n_pairs=N_PAIRS)
    assert out2 is not None and isinstance(out2, str)


# -- admission queue -------------------------------------------------------------

def test_queue_watermark_ladder():
    q = AdmissionQueue(capacity=8, shed_watermark=6, backpressure_watermark=4)
    outcomes = [q.offer(_req(i), now=0.0) for i in range(8)]
    assert outcomes == [ADMIT] * 4 + [ADMIT_BACKPRESSURE] * 2 + \
        [SHED_OVERLOAD] * 2
    assert q.depth == 6


def test_queue_full_when_watermark_equals_capacity():
    q = AdmissionQueue(capacity=4, shed_watermark=4, backpressure_watermark=2)
    outcomes = [q.offer(_req(i), now=0.0) for i in range(5)]
    assert outcomes[-1] == SHED_QUEUE_FULL
    assert q.depth == 4


def test_queue_admit_stamps_time_and_pops_fifo():
    q = AdmissionQueue(capacity=8)
    for i in range(3):
        q.offer(_req(i), now=float(i))
    assert q.peek("pbm").admit_s == 0.0
    popped = q.pop("pbm", 2)
    assert [r.request_id for r in popped] == [0, 1]
    assert q.depth == 1


def test_queue_remove_if_preserves_survivor_order():
    q = AdmissionQueue(capacity=8)
    for i in range(4):
        q.offer(_req(i), now=0.0)
    removed = q.remove_if("pbm", lambda r: r.request_id % 2 == 0)
    assert [r.request_id for r in removed] == [0, 2]
    assert [r.request_id for r in q.pop("pbm", 4)] == [1, 3]


# -- circuit breaker -------------------------------------------------------------

def test_breaker_full_lifecycle():
    b = CircuitBreaker("m/primary", window=8, threshold=0.5, min_samples=2,
                       cooldown=3)
    assert b.state == CLOSED and b.available()
    b.record(False)
    b.record(False)
    assert b.state == OPEN and not b.available()
    for _ in range(3):
        b.note_skipped()
    assert b.state == HALF_OPEN and b.available()
    b.begin()
    assert not b.available()
    b.record(False)
    assert b.state == OPEN
    for _ in range(3):
        b.note_skipped()
    b.begin()
    b.record(True)
    assert b.state == CLOSED and b.available()
    assert b.transitions == 5


def test_breaker_available_is_pure():
    b = CircuitBreaker("m/primary", min_samples=2, cooldown=2)
    b.record(False)
    b.record(False)
    assert b.state == OPEN
    for _ in range(10):
        assert not b.available()
    assert b.state == OPEN


def test_ladder_select_walk_and_skip_ticks():
    lad = DegradationLadder("m", breaker_kwargs=dict(min_samples=2,
                                                     cooldown=2))
    assert lad.select() == "primary"
    assert lad.walk_from("primary") == ["primary", "int8", "prior"]
    lad.record("primary", False)
    lad.record("primary", False)
    assert lad.select() == "int8"
    assert lad.walk_from("int8") == ["int8", "prior"]
    lad.finish_dispatch("int8", {"int8"})
    lad.finish_dispatch("int8", {"int8"})
    assert lad.breakers["primary"].state == HALF_OPEN
    assert lad.select() == "primary"


# -- deadline batcher ------------------------------------------------------------

def _queued(registry, reqs, now=0.0):
    q = AdmissionQueue(capacity=64)
    for r in reqs:
        q.offer(r, now=now)
    return q


def test_batcher_waits_then_fires_on_max_wait(registry):
    b = DeadlineBatcher(registry, max_wait_s=0.005)
    q = _queued(registry, [_req(0, deadline_s=1.0)])
    assert b.plan(q, "pbm", "primary", now=0.0) is None
    t = b.next_decision_time(q, "pbm", "primary", now=0.0)
    assert t == pytest.approx(0.005)
    plan = b.plan(q, "pbm", "primary", now=t)
    assert plan is not None and plan.bucket == 1


def test_batcher_fires_full_batch_immediately(registry):
    b = DeadlineBatcher(registry)
    q = _queued(registry, [_req(i, deadline_s=1.0) for i in
                           range(registry.max_bucket)])
    plan = b.plan(q, "pbm", "primary", now=0.0)
    assert plan is not None
    assert plan.bucket == registry.max_bucket
    assert len(plan.requests) == registry.max_bucket


def test_batcher_slack_trigger_protects_oldest(registry):
    est = registry["pbm"].estimate("primary", 1)
    b = DeadlineBatcher(registry, max_wait_s=10.0, slack_margin_s=0.001)
    q = _queued(registry, [_req(0, deadline_s=est + 0.002)])
    assert b.plan(q, "pbm", "primary", now=0.0) is None
    t = b.next_decision_time(q, "pbm", "primary", now=0.0)
    assert b.plan(q, "pbm", "primary", now=t) is not None


def test_batcher_plan_fires_exactly_at_decision_time(registry):
    b = DeadlineBatcher(registry, max_wait_s=0.005)
    req = _req(0, deadline_s=1.0, arrival_s=0.02649782139617092)
    q = AdmissionQueue(capacity=8)
    q.offer(req, now=0.027641919546832948)
    t = b.next_decision_time(q, "pbm", "primary",
                             now=0.027641919546832948)
    assert b.plan(q, "pbm", "primary", now=t) is not None


def test_batcher_reaps_unmeetable(registry):
    b = DeadlineBatcher(registry)
    floor = registry["pbm"].estimate("primary", BUCKETS[0])
    q = _queued(registry, [_req(0, deadline_s=floor / 2),
                           _req(1, deadline_s=1.0)])
    reaped = b.reap_unmeetable(q, "pbm", "primary", now=0.0)
    assert [r.request_id for r in reaped] == [0]
    assert q.depth == 1


def test_batcher_flush_drains_partial(registry):
    b = DeadlineBatcher(registry, max_wait_s=10.0)
    q = _queued(registry, [_req(0, deadline_s=10.0)])
    assert b.plan(q, "pbm", "primary", now=0.0) is None
    assert b.plan(q, "pbm", "primary", now=0.0, flush=True) is not None


# -- engine: healthy path --------------------------------------------------------

def test_every_request_answered_exactly_once(registry):
    eng = _engine(registry)
    results = eng.run_trace(_trace(40), handle_signals=False)
    assert sorted(r.request_id for r in results) == list(range(40))
    assert all(r.status == "ok" for r in results)
    assert eng.stats["serve.answered"] == 40
    s = eng.summary(results)
    assert s["deadline_hit_rate"] == 1.0
    assert s["p99_ms"] >= s["p50_ms"] > 0


def test_warm_traffic_never_retraces(registry):
    """After warmup every (tier, bucket) graph is captured: a fresh burst
    of traffic must not bump any capture counter."""
    before = {m: dict(registry[m].trace_counts) for m in MODELS}
    for m in MODELS:
        assert before[m]["primary"] == len(BUCKETS)
        assert before[m]["int8"] == len(BUCKETS)
    eng = _engine(registry)
    eng.run_trace(_trace(60, seed=7), handle_signals=False)
    after = {m: dict(registry[m].trace_counts) for m in MODELS}
    assert after == before


def test_overload_sheds_with_reason(registry):
    eng = _engine(registry, queue=AdmissionQueue(capacity=8))
    results = eng.run_trace(_trace(60, qps=100000.0, deadline_s=0.5),
                            handle_signals=False)
    assert len(results) == 60
    shed = [r for r in results if r.status == "shed"]
    assert shed and all(r.reason in ("shed_overload", "shed_queue_full")
                        for r in shed)
    assert [r for r in results if r.answered]
    assert eng.stats["serve.shed"] == len(shed)


def test_unmeetable_deadline_is_shed_not_late(registry):
    eng = _engine(registry)
    floor = registry["pbm"].estimate("primary", BUCKETS[0])
    results = eng.run_trace([_req(0, deadline_s=floor / 3, arrival_s=0.001)],
                            handle_signals=False)
    assert results[0].status == "shed"
    assert results[0].reason == "deadline_unmeetable"
    assert eng.stats["serve.deadline_miss"] == 1


def test_unknown_model_rejected(registry):
    eng = _engine(registry)
    results = eng.run_trace([_req(0, model="nope", arrival_s=0.001)],
                            handle_signals=False)
    assert results[0].status == "rejected"
    assert results[0].reason == "unknown_model"


def test_force_tier_paths_and_int8_tolerance(registry):
    """Forcing each tier serves; int8 predictions match primary within the
    quantization tolerance (scale/2 per table read)."""
    out = {}
    for tier in TIERS:
        eng = _engine(registry, force_tier=tier)
        results = eng.run_trace(_trace(20, seed=3, models=("pbm",)),
                                handle_signals=False)
        assert all(r.answered and r.tier == tier for r in results)
        out[tier] = {r.request_id: r.log_ctr for r in results}
    for rid, primary in out["primary"].items():
        dprob = np.abs(np.exp(primary) - np.exp(out["int8"][rid])).max()
        assert dprob < 0.01, f"int8 drifted {dprob} from primary"
    prior = registry["pbm"].prior_log_ctr
    assert all(np.allclose(v, prior) for v in out["prior"].values())


def test_poison_rejected_alone_batchmates_answered(registry):
    burst = [_req(i, deadline_s=0.5, arrival_s=0.001, seed=i)
             for i in range(8)]
    trace = list(PoisonTrace(burst, at=[3], modes=("nan_ids",)))
    eng = _engine(registry)
    results = {r.request_id: r for r in
               eng.run_trace(trace, handle_signals=False)}
    assert results[3].status == "rejected"
    assert results[3].reason.startswith("nonfinite_values")
    for i in set(range(8)) - {3}:
        assert results[i].answered and results[i].deadline_hit


# -- engine: degradation ---------------------------------------------------------

def test_model_failure_degrades_and_breaker_trips(registry):
    eng = _engine(registry,
                  faults=[SlowModel(model="pbm", fail=True,
                                    at_dispatches=range(0, 4))],
                  breaker_kwargs=dict(window=8, min_samples=2,
                                      threshold=0.5, cooldown=2))
    results = eng.run_trace(_trace(30, seed=5, models=("pbm",)),
                            handle_signals=False)
    assert all(r.answered for r in results)
    degraded = [r for r in results if r.degraded]
    assert degraded
    assert eng.stats["serve.model_errors"] >= 2
    assert eng.stats["serve.degraded"] == len(degraded)
    primary = eng.ladders["pbm"].breakers["primary"]
    assert primary.transitions >= 2
    assert primary.state == CLOSED


def test_slow_model_misses_trip_breaker(registry):
    eng = _engine(registry,
                  faults=[SlowModel(model="pbm", delay_seconds=0.1,
                                    at_dispatches=range(0, 3))],
                  breaker_kwargs=dict(min_samples=2, threshold=0.5,
                                      cooldown=50))
    results = eng.run_trace(_trace(30, seed=5, models=("pbm",), qps=100.0,
                                   deadline_s=0.12),
                            handle_signals=False)
    assert len(results) == 30
    assert eng.stats["serve.deadline_miss"] >= 2
    primary = eng.ladders["pbm"].breakers["primary"]
    assert primary.transitions >= 1 and primary.state == OPEN
    assert any(r.degraded for r in results)


def test_prior_injected_failure_fails_closed(registry):
    eng = _engine(registry,
                  faults=[SlowModel(model="pbm", fail=True, tiers=TIERS)])
    results = eng.run_trace(_trace(10, seed=2, models=("pbm",)),
                            handle_signals=False)
    assert len(results) == 10
    assert all(r.status == "shed" and r.reason == "model_failure"
               for r in results)


def test_multi_model_isolation(registry):
    eng = _engine(registry,
                  faults=[SlowModel(model="pbm", fail=True,
                                    at_dispatches=range(100))],
                  breaker_kwargs=dict(min_samples=2, cooldown=1000))
    results = eng.run_trace(_trace(40, seed=9), handle_signals=False)
    by_model = {}
    for r in results:
        by_model.setdefault(r.model, []).append(r)
    assert all(not r.degraded for r in by_model["dbn"])
    assert any(r.degraded for r in by_model["pbm"])
    health = eng.health()
    assert health["pbm"]["breakers"]["primary"] == OPEN
    assert health["dbn"]["breakers"]["primary"] == CLOSED
    assert health["dbn"]["tier"] == "primary"
    assert health["pbm"]["tier"] == "int8"


# -- engine: drain ---------------------------------------------------------------

def test_sigterm_drain_zero_drops(registry):
    eng = _engine(registry, faults=[ServeKillSwitch(at_request=20)])
    results = eng.run_trace(_trace(50, seed=4), handle_signals=True)
    assert sorted(r.request_id for r in results) == list(range(50))
    draining = [r for r in results if r.reason == "draining"]
    answered = [r for r in results if r.answered]
    assert draining and answered
    assert eng.stats["serve.drains"] == 1
    assert len(answered) + len(draining) == 50
    assert signal.getsignal(signal.SIGTERM) is not None


def test_disarmed_serve_killswitch_is_inert(registry):
    ks = ServeKillSwitch(at_request=5, armed=False)
    eng = _engine(registry, faults=[ks])
    results = eng.run_trace(_trace(12, seed=4), handle_signals=True)
    assert not ks.fired
    assert all(r.answered for r in results)


# -- the pinned chaos drill ------------------------------------------------------

def _chaos_drill(registry, pkg_serve=None, pkg_testing=None, seed=1):
    """tests/test_serve.py's drill, on the port (default) or on JAX's
    package (``pkg_serve=repro.serve, pkg_testing=repro.testing``)."""
    srv = pkg_serve
    tst = pkg_testing
    slow = (tst.SlowModel if tst else SlowModel)(
        model="pbm", fail=True, at_dispatches=range(0, 6))
    kill = (tst.ServeKillSwitch if tst else ServeKillSwitch)(at_request=70)
    trace = (tst.PoisonTrace if tst else PoisonTrace)(
        (srv.poisson_trace if srv else poisson_trace)(
            90, qps=500.0, models=list(MODELS), positions_k=K,
            n_pairs=N_PAIRS, deadline_s=0.05, seed=seed),
        at=[5, 12, 19, 26, 33], seed=0)
    engine_cls = srv.ServeEngine if srv else ServeEngine
    clock = (srv.VirtualClock if srv else VirtualClock)()
    eng = engine_cls(registry, clock=clock, faults=[slow, kill],
                     breaker_kwargs=dict(window=8, min_samples=2,
                                         threshold=0.5, cooldown=4))
    return eng, eng.run_trace(trace, handle_signals=True)


def test_chaos_drill_guarantees_and_determinism(registry):
    eng1, res1 = _chaos_drill(registry)
    eng2, res2 = _chaos_drill(registry)
    assert sorted(r.request_id for r in res1) == list(range(90))
    by_id = {r.request_id: r for r in res1}
    for rid in (5, 12, 19, 26, 33):
        assert by_id[rid].status == "rejected"
    neighbors = [by_id[i] for i in (4, 6, 11, 13)]
    assert all(r.answered or r.reason == "draining" for r in neighbors)
    assert any(r.degraded for r in res1)
    assert eng1.ladders["pbm"].breakers["primary"].transitions >= 1
    assert eng1.stats["serve.drains"] == 1
    assert eng1.stats["serve.rejected_draining"] > 0
    assert eng1.stats["serve.model_errors"] > 0
    assert dict(eng1.stats) == dict(eng2.stats)
    assert _signature(res1) == _signature(res2)


def test_chaos_drill_signature_and_counters_equal_jax(registries):
    jreg, treg = registries
    jeng, jres = _chaos_drill(jreg, jserve, jtesting)
    teng, tres = _chaos_drill(treg)
    assert _signature(tres) == _signature(jres)
    assert dict(teng.stats) == dict(jeng.stats)
    assert teng.summary(tres) == jeng.summary(jres)
    for a, b in zip(tres, jres):
        if a.answered:
            np.testing.assert_allclose(a.log_ctr, b.log_ctr, rtol=REL,
                                       atol=ABS)


def test_chaos_drill_counters_flow_to_recorder(registry, tmp_path):
    path = str(tmp_path / "serve_metrics.jsonl")
    rec = obs.Recorder(sinks=[obs.JsonlSink(path)])
    faults = [SlowModel(model="pbm", fail=True, at_dispatches=range(0, 4))]
    eng = _engine(registry, recorder=rec, faults=faults,
                  breaker_kwargs=dict(min_samples=2, cooldown=4))
    eng.run_trace(_trace(30, seed=5, models=("pbm",)), handle_signals=False)
    rec.close()
    events = obs.read_jsonl(path, validate=True)
    names = {e["name"] for e in events}
    assert "serve_latency_ms" in names
    assert "model_error" in names
    assert "breaker_transition" in names
    snapshots = [e for e in events if e.get("kind") == "counters"]
    assert snapshots
    snap = snapshots[-1]["data"]
    assert snap.get("serve.model_errors", 0) > 0
    assert snap.get("serve.degraded", 0) > 0
    assert snap.get("serve.breaker_transitions", 0) > 0
    assert "serve.queue_depth:gauge" in snap


# -- the launcher ----------------------------------------------------------------

LAUNCH_CASES = {
    "drill": ["--models", "pbm,dbn", "--fault-poison-every", "17",
              "--fault-sigterm-at", "150", "--requests", "300"],
    "slow_fail": ["--models", "pbm,dbn,dctr", "--fault-slow-model", "pbm",
                  "--fault-slow-fail", "--fault-slow-at", "0:8",
                  "--requests", "200", "--qps", "400"],
    "forced_int8": ["--model", "ubm", "--force-tier", "int8",
                    "--requests", "120", "--buckets", "1,4,16"],
}


@pytest.mark.parametrize("case", list(LAUNCH_CASES))
def test_launcher_virtual_time_equals_jax_launcher(tmp_path, case):
    argv = LAUNCH_CASES[case] + ["--virtual-time", "--pairs", "20000"]
    before, jbefore = obs.get_recorder(), jobs.get_recorder()
    try:
        torch_launch.main(argv + ["--device", "cpu", "--summary-out",
                                  str(tmp_path / "port.json"),
                                  "--metrics-out",
                                  str(tmp_path / "port.jsonl")])
        jax_launch.main(argv + ["--summary-out",
                                str(tmp_path / "jax.json")])
    finally:
        obs.set_recorder(before)
        jobs.set_recorder(jbefore)
    ours = json.loads((tmp_path / "port.json").read_text())
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert ours["summary"] == theirs["summary"]
    assert ours["counters"] == theirs["counters"]
    for name, health in ours["health"].items():
        assert health["breakers"] == theirs["health"][name]["breakers"]
        assert health["trace_counts"] == {"primary": 0, "int8": 0}
        assert (health["primary_nbytes"], health["int8_nbytes"]) == (
            theirs["health"][name]["primary_nbytes"],
            theirs["health"][name]["int8_nbytes"])
    events = obs.read_jsonl(str(tmp_path / "port.jsonl"), validate=True)
    assert [e for e in events if e["name"] == "serve_summary"]
