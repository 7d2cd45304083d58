"""The EM / MLE baselines (``repro_torch.core.em``) and the rest of the
ranking metrics (``average_precision_metric``, ``RaxMetric``) against the
JAX package, on the CPU.

The same synthetic logs, made from a seed with numpy, go through JAX's
``repro.core.em`` and the port's: the counting (MLE) fits agree at 1e-6,
PBM and UBM EM at 1e-5 after 30 iterations from 1/9 (the start of the
Figure-1 benchmark), and each injector's tree equals JAX's and, loaded into
a port model with ``convert.load_jax_params``, predicts JAX's clicks at
1e-5. AP and the Listing-7 adapter agree with JAX on scores with ties,
masks and ``top_n``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import em as jem
from repro.core import metrics as jmetrics
from repro.data import SyntheticConfig as JaxConfig
from repro.data import generate_click_log as jax_generate
from repro_torch import core as tcore
from repro_torch.convert import load_jax_params
from repro_torch.core import em as tem
from repro_torch.core import metrics as tmetrics

POSITIONS = 6
ITERS = 30
INIT = 1.0 / 9


@pytest.fixture(scope="module")
def log():
    cfg = JaxConfig(n_sessions=1500, n_queries=40, docs_per_query=12,
                    positions=POSITIONS, behavior="dbn", seed=17)
    data, _ = jax_generate(cfg)
    batch = {k: data[k] for k in ("positions", "query_doc_ids", "clicks",
                                  "mask")}
    return cfg, batch


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_mle_fits_match_jax(log):
    cfg, batch = log
    n = cfg.n_query_doc_pairs
    _close(tem.fit_gctr(batch), jem.fit_gctr(batch), 1e-6)
    _close(tem.fit_rctr(batch, POSITIONS), jem.fit_rctr(batch, POSITIONS),
           1e-6)
    _close(tem.fit_dctr(batch, n), jem.fit_dctr(batch, n), 1e-6)
    _close(tem.fit_dctr(batch, n, prior=0.3, prior_weight=2.0),
           jem.fit_dctr(batch, n, prior=0.3, prior_weight=2.0), 1e-6)
    for got, want in zip(tem.fit_sdbn_mle(batch, n),
                         jem.fit_sdbn_mle(batch, n)):
        _close(got, want, 1e-6)


@pytest.mark.parametrize("kind", ["pbm", "ubm"])
def test_em_fits_match_jax_after_30_iterations(log, kind):
    cfg, batch = log
    fit_t = getattr(tem, f"fit_{kind}_em")
    fit_j = getattr(jem, f"fit_{kind}_em")
    got = fit_t(batch, POSITIONS, cfg.n_query_doc_pairs, n_iters=ITERS,
                init=INIT)
    want = fit_j(batch, POSITIONS, cfg.n_query_doc_pairs, n_iters=ITERS,
                 init=INIT)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, 1e-5)


def test_em_reads_tensors_on_their_device(log):
    """Tensors in, tensors out on the same device; numpy in, CPU out."""
    cfg, batch = log
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    a = tem.fit_pbm_em(tensors, POSITIONS, cfg.n_query_doc_pairs, n_iters=3)
    b = tem.fit_pbm_em(batch, POSITIONS, cfg.n_query_doc_pairs, n_iters=3)
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and torch.equal(x, y)


def _sigmoid(logits):
    return 1 / (1 + np.exp(-np.asarray(logits, np.float64)))


def _models(kind, cfg):
    kw = dict(query_doc_pairs=cfg.n_query_doc_pairs, positions=POSITIONS)
    return (jcore.MODEL_REGISTRY[kind](**kw),
            tcore.MODEL_REGISTRY[kind](device="cpu", **kw))


def _fits(kind, cfg, batch, em):
    n = cfg.n_query_doc_pairs
    if kind == "gctr":
        return em.gctr_params_from_mle(em.fit_gctr(batch))
    if kind == "rctr":
        return em.rctr_params_from_mle(em.fit_rctr(batch, POSITIONS))
    if kind == "dctr":
        return em.dctr_params_from_mle(em.fit_dctr(batch, n))
    if kind == "sdbn":
        return em.sdbn_params_from_mle(*em.fit_sdbn_mle(batch, n))
    fit = getattr(em, f"fit_{kind}_em")(batch, POSITIONS, n, n_iters=ITERS,
                                        init=INIT)
    return getattr(em, f"{kind}_params_from_em")(*fit)


@pytest.mark.parametrize("kind", ["gctr", "rctr", "dctr", "sdbn", "pbm",
                                  "ubm"])
def test_injected_fits_predict_jax_clicks(log, kind):
    cfg, batch = log
    jtree = _fits(kind, cfg, batch, jem)
    ttree = _fits(kind, cfg, batch, tem)
    tol = 1e-6 if kind in ("gctr", "rctr", "dctr", "sdbn") else 1e-5
    jflat = jax.tree_util.tree_leaves_with_path(jtree)
    tflat = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), ttree))
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        # the logits map back to the fits' probabilities (a probability
        # that rounds to 1 in float32 has an infinite logit in both)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(_sigmoid(a), _sigmoid(b), atol=tol)
    jm, tm = _models(kind, cfg)
    load_jax_params(tm, ttree)
    jparams = jm.init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda _, v: jnp.asarray(v), jparams,
                                     jtree)
    sl = slice(0, 256)
    jb = {k: jnp.asarray(v[sl]) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v[sl]) for k, v in batch.items()}
    with torch.no_grad():
        got = tm.predict_clicks(tb).numpy()
    want = np.asarray(jm.predict_clicks(jparams, jb))
    np.testing.assert_allclose(got, want, atol=1e-4)


# -- ranking metrics -----------------------------------------------------------

def _ranking_inputs(seed=3, rows=64, k=8):
    rng = np.random.default_rng(seed)
    # scores on a coarse grid, so many lists hold ties
    scores = rng.integers(0, 4, (rows, k)).astype(np.float32) / 4
    labels = rng.integers(0, 3, (rows, k)).astype(np.int32)
    where = rng.random((rows, k)) < 0.8
    return scores, labels, where


@pytest.mark.parametrize("top_n", [None, 1, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_average_precision_matches_jax_with_ties(top_n, masked):
    scores, labels, where = _ranking_inputs()
    kw_t = {"where": torch.from_numpy(where)} if masked else {}
    kw_j = {"where": jnp.asarray(where)} if masked else {}
    got = tmetrics.average_precision_metric(
        torch.from_numpy(scores), torch.from_numpy(labels), top_n=top_n,
        **kw_t)
    want = jmetrics.average_precision_metric(
        jnp.asarray(scores), jnp.asarray(labels), top_n=top_n, **kw_j)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_average_precision_of_an_all_tied_list_is_index_order():
    scores = torch.full((1, 4), 0.5)
    labels = torch.tensor([[0, 1, 0, 1]])
    # stable order (0, 1, 2, 3): precision 1/2 at rank 2 and 2/4 at rank 4
    np.testing.assert_allclose(
        float(tmetrics.average_precision_metric(scores, labels)), 0.5)


@pytest.mark.parametrize("fn", ["ndcg_metric", "dcg_metric", "mrr_metric",
                                "average_precision_metric"])
def test_rax_metric_streams_as_jax_does(fn):
    scores, labels, where = _ranking_inputs(seed=5)
    tm = tmetrics.RaxMetric(getattr(tmetrics, fn), top_n=3)
    jm = jmetrics.RaxMetric(getattr(jmetrics, fn), top_n=3)
    ts, js = tm.init_state(8), jm.init_state(8)
    for lo in range(0, 64, 16):
        sl = slice(lo, lo + 16)
        ts = tm.update(ts, scores=torch.from_numpy(scores[sl]),
                       labels=torch.from_numpy(labels[sl]),
                       where=torch.from_numpy(where[sl]))
        js = jm.update(js, scores=jnp.asarray(scores[sl]),
                       labels=jnp.asarray(labels[sl]),
                       where=jnp.asarray(where[sl]))
    assert float(ts["count"]) == float(js["count"]) == 4.0
    np.testing.assert_allclose(float(tm.compute(ts)), float(jm.compute(js)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm.compute_per_rank(ts)),
                               float(tm.compute(ts)))


def test_rax_metric_rides_in_a_multi_metric():
    m = tmetrics.MultiMetric({"ndcg": tmetrics.RaxMetric(
        tmetrics.ndcg_metric, top_n=2)})
    state = m.init_state(3)
    state = m.update(state, scores=torch.tensor([[3.0, 2.0, 1.0]]),
                     labels=torch.tensor([[2, 1, 0]]),
                     where=torch.ones((1, 3), dtype=torch.bool),
                     log_probs=None)
    np.testing.assert_allclose(float(m.compute(state)["ndcg"]), 1.0,
                               rtol=1e-6)
