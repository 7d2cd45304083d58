"""The port's GraphSAGE against ``repro.models.gnn`` on the CPU: the copied
sampler's arrays bit for bit; the full-graph forward (with and without
``edge_weight``, and with its edges summed in several chunks), the sampled
forward (with and without ``mask_hop_*``), the loss with labels < 0, and one
``adam`` step of each train step and of the molecule step, at 1e-5, from
JAX's init tree loaded through ``convert``. Also ``FULL``, ``reduced()``
and ``SHAPES`` against JAX's config, and ``_flops_full``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as jopt
from repro.configs import graphsage_reddit as jconf
from repro.models import gnn as jgnn
from repro.models.gnn import graphsage as jsage
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.configs import graphsage_reddit as tconf
from repro_torch.models import gnn as tgnn
from repro_torch.models.gnn import graphsage as tsage

TOL = 1e-5
N_NODES, N_EDGES = 150, 600


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _graph(cfg, weighted, seed=3):
    g = jgnn.random_graph(N_NODES, N_EDGES, cfg.d_in, cfg.n_classes,
                          seed=seed)
    if weighted:
        g["edge_weight"] = np.random.default_rng(seed).uniform(
            0.1, 2.0, N_EDGES).astype(np.float32)
    g["labels"] = np.where(np.arange(N_NODES) % 7 == 0, -1, g["labels"]
                           ).astype(np.int32)  # some unlabelled nodes
    return g


def _port_fields(cfg):
    """JAX config ``cfg``'s fields, every one of which the port's
    SAGEConfig has (``partitioned_edges`` too, since the sharded forms)."""
    return dataclasses.asdict(cfg)


def _pair(cfg, seed=0):
    jp = jgnn.init_params(cfg, jax.random.PRNGKey(seed))
    tcfg = tsage.SAGEConfig(**{**_port_fields(cfg),
                               "dtype": torch.float32})
    tp = tgnn.init_params(tcfg, device="cpu")
    convert.load_jax_params(tp, jax.device_get(jp))
    return jp, tcfg, tp


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _params_close(jparams, tparams):
    for name, p in tparams.named_parameters():
        layer, leaf = convert.param_path(name)
        _close(p, jparams[layer][leaf], name)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_graph_and_sampler_arrays_bit_equal(seed):
    jg = jgnn.random_graph(500, 3000, 8, 5, seed=seed)
    tg = tgnn.random_graph(500, 3000, 8, 5, seed=seed)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        assert jg[k].dtype == tg[k].dtype
        np.testing.assert_array_equal(jg[k], tg[k])
    js = jgnn.NeighborSampler(jg["src"], jg["dst"], 500, seed=seed)
    ts = tgnn.NeighborSampler(tg["src"], tg["dst"], 500, seed=seed)
    for fanouts in ((5, 3), (15, 10)):
        nodes = np.arange(0, 500, 9)
        jb = js.sample_batch(nodes, fanouts, jg["features"], jg["labels"])
        tb = ts.sample_batch(nodes, fanouts, tg["features"], tg["labels"])
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


@pytest.mark.parametrize("weighted", [False, True])
def test_full_graph_forward_matches_jax(weighted):
    cfg = jconf.reduced()
    jp, tcfg, tp = _pair(cfg)
    g = _graph(cfg, weighted)
    want = jsage.full_graph_forward(cfg, jp, _j(g))
    _close(tsage.full_graph_forward(tcfg, tp, _t(g)), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_edges_summed_in_chunks_equal_one_chunk(weighted, monkeypatch):
    """The edge chunks change only the order of the sums: values and
    gradients against JAX and against the one-chunk run."""
    cfg = jconf.reduced()
    _, tcfg, tp = _pair(cfg)
    g = _t(_graph(cfg, weighted))
    runs = []
    for chunk_bytes in (1 << 30, 37 * cfg.d_hidden * 4):  # 1 and 17 chunks
        monkeypatch.setattr(tsage, "EDGE_CHUNK_BYTES", chunk_bytes)
        loss = tsage.node_classification_loss(
            tsage.full_graph_forward(tcfg, tp, g), g["labels"])
        runs.append([loss] + list(torch.autograd.grad(
            loss, list(tp.parameters()))))
    for a, b in zip(*runs):
        _close(a, b.detach().numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_sampled_forward_matches_jax(masked):
    cfg = jconf.reduced()
    jp, tcfg, tp = _pair(cfg)
    g = jgnn.random_graph(N_NODES, N_EDGES, cfg.d_in, cfg.n_classes, seed=1)
    batch = jgnn.NeighborSampler(g["src"], g["dst"], N_NODES, seed=0
                                 ).sample_batch(np.arange(16),
                                                cfg.sample_sizes,
                                                g["features"], g["labels"])
    if masked:
        rng = np.random.default_rng(2)
        for i, f in ((1, (16, 5)), (2, (16, 5, 3))):
            batch[f"mask_hop_{i}"] = rng.random(f) < 0.7
        batch["mask_hop_2"][0] = False  # a neighbour with no valid ones
    want = jsage.sampled_forward(cfg, jp, _j(batch))
    _close(tsage.sampled_forward(tcfg, tp, _t(batch)), want)


def test_loss_masks_negative_labels_like_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(40, 6)) * 3).astype(np.float32)
    labels = rng.integers(-1, 6, 40).astype(np.int32)
    mask = rng.random(40) < 0.5
    for m in (None, mask):
        want = jsage.node_classification_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = tsage.node_classification_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        _close(got, want)
    none = np.full(40, -1, np.int32)
    assert float(tsage.node_classification_loss(
        torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


def _step_both(jstep, tstep, jp, tp, jdata, tdata):
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    jp2, _, jloss = jax.jit(jstep)(jp, jo.init(jp), jdata)
    _, state, tloss = tstep(tp, to.init(list(tp.parameters())), tdata)
    _close(tloss, jloss, "loss")
    _params_close(jp2, tp)
    assert int(state[0].count) == 1


@pytest.mark.parametrize("weighted", [False, True])
def test_full_graph_train_step_matches_jax(weighted):
    cfg = jconf.reduced()
    jp, tcfg, tp = _pair(cfg)
    g = _graph(cfg, weighted)
    _step_both(jsage.make_full_graph_train_step(cfg),
               tsage.make_full_graph_train_step(tcfg), jp, tp, _j(g), _t(g))


def test_sampled_train_step_matches_jax():
    cfg = jconf.reduced()
    jp, tcfg, tp = _pair(cfg)
    g = jgnn.random_graph(N_NODES, N_EDGES, cfg.d_in, cfg.n_classes, seed=4)
    batch = jgnn.NeighborSampler(g["src"], g["dst"], N_NODES, seed=1
                                 ).sample_batch(np.arange(32),
                                                cfg.sample_sizes,
                                                g["features"], g["labels"])
    _step_both(jsage.make_sampled_train_step(cfg),
               tsage.make_sampled_train_step(tcfg), jp, tp, _j(batch),
               _t(batch))


def test_molecule_step_matches_jax():
    """JAX's ``_make_molecule_step`` (segment_sum pooling over graph_ids,
    every n // n_graphs-th label) on 6 graphs of 30 nodes, without a
    mesh."""
    info = tconf.SHAPES["molecule"]
    n_graphs, n = 6, info["n_nodes"]
    cfg = dataclasses.replace(jconf.reduced(), d_in=info["d_feat"],
                              n_classes=info["n_classes"])
    jp, tcfg, tp = _pair(cfg)
    rng = np.random.default_rng(6)
    offsets = np.repeat(np.arange(n_graphs) * n, info["n_edges"])
    src = rng.integers(0, n, n_graphs * info["n_edges"]) + offsets
    dst = rng.integers(0, n, n_graphs * info["n_edges"]) + offsets
    deg = np.bincount(dst, minlength=n_graphs * n).astype(np.float32)
    g = {"features": rng.normal(size=(n_graphs * n, info["d_feat"])
                                ).astype(np.float32),
         "src": src.astype(np.int32), "dst": dst.astype(np.int32),
         "degree_inv": (1.0 / np.maximum(deg, 1.0)).astype(np.float32),
         "labels": rng.integers(0, 2, n_graphs * n).astype(np.int32),
         "graph_ids": np.repeat(np.arange(n_graphs), n).astype(np.int32)}
    _step_both(jconf._make_molecule_step(cfg, jopt.adam(1e-2), None,
                                         n_graphs),
               tconf._make_molecule_step(tcfg, topt.adam(1e-2), n_graphs),
               jp, tp, _j(g), _t(g))


def test_configs_equal_jax():
    def fields(c, port):
        f = dataclasses.asdict(c) if port else _port_fields(c)
        return {k: v for k, v in f.items() if k != "dtype"}

    assert fields(tconf.FULL, True) == fields(jconf.FULL, False)
    assert fields(tconf.reduced(), True) == fields(jconf.reduced(), False)
    assert tconf.SHAPES == jconf.SHAPES
    for shape, info in jconf.SHAPES.items():
        assert tconf._flops_full(tconf.FULL, info["n_nodes"],
                                 info["n_edges"], info["d_feat"]) == \
            jconf._flops_full(jconf.FULL, info["n_nodes"], info["n_edges"],
                              info["d_feat"])
        cfg = tconf.shape_config(shape)
        assert (cfg.d_in, cfg.n_classes, cfg.d_hidden) == \
            (info["d_feat"], info["n_classes"], jconf.FULL.d_hidden)


def test_init_draws_jax_scales_from_its_generator():
    cfg = tconf.shape_config("minibatch_lg")
    a = tgnn.init_params(cfg, device="cpu", seed=1)
    b = tgnn.init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu")
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    w = a.layer_0["w_self"]
    assert w.shape == (602, 128)
    assert abs(float(w.detach().std()) - (1 / 602) ** 0.5) < 2e-3
    assert not a.layer_1["bias"].any()
