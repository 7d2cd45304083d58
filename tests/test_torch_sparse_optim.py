"""Sparse lazy AdamW, port against JAX on the CPU: the fixed-size dedupe,
the per-row gradients and update, the engine's sparse route, the
fully-lazy train step, the error paths and the launcher's
``--sparse-tables``.

Inputs come from numpy seeds and go to both packages. Tolerances: the
dedupe is compared to the bit; values, moments and losses at 1e-6 for one
update and 1e-5 through the engine (the conformance tolerance); bfloat16
moments at 2e-2. Rows no batch touched keep their bits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as jcore
from repro import optim as jopt
from repro.optim import sparse as jsparse
from repro.train import TrainEngine as JaxEngine
from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch.convert import _named, export_params, load_jax_params
from repro_torch.launch import train as launch_train
from repro_torch.optim import sparse as tsparse
from repro_torch.train import TrainEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# unique_rows_with_sentinel
# ---------------------------------------------------------------------------

R_DEDUPE = 50
DEDUPE_CASES = {
    "random": lambda r: r.integers(0, R_DEDUPE, (8, 5)),
    "all_distinct": lambda r: r.permutation(R_DEDUPE)[:40].reshape(8, 5),
    "all_equal": lambda r: np.full((6, 4), 17),
    "first_and_last_rows": lambda r: r.choice([0, R_DEDUPE - 1, 3], (7, 3)),
    "one_id": lambda r: np.array([R_DEDUPE - 1]),
}


@pytest.mark.parametrize("return_inverse", [False, True])
@pytest.mark.parametrize("case", sorted(DEDUPE_CASES))
def test_unique_rows_with_sentinel_is_bit_equal_to_jax(case, return_inverse):
    ids = DEDUPE_CASES[case](np.random.default_rng(0)).astype(np.int64)
    want = jsparse.unique_rows_with_sentinel(
        jnp.asarray(ids), R_DEDUPE, return_inverse=return_inverse)
    got = tsparse.unique_rows_with_sentinel(
        torch.from_numpy(ids), R_DEDUPE, return_inverse=return_inverse)
    if not return_inverse:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))


def test_unique_rows_with_sentinel_at_a_larger_fixed_size_matches_jax():
    ids = np.random.default_rng(1).integers(0, 30, (20,))
    want = jsparse.unique_rows_with_sentinel(jnp.asarray(ids), 30,
                                             max_unique=64)
    got = tsparse.unique_rows_with_sentinel(torch.from_numpy(ids), 30,
                                            max_unique=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# sparse_row_grads and sparse_adamw_update
# ---------------------------------------------------------------------------

R, D = 16, 3


def _lookups(rng, n=12):
    """Ids over rows 1..R-1 (row 0 never looked up), row R-1 always; with
    duplicates, so the dedupe pads with the sentinel."""
    ids = rng.integers(1, R - 1, n)
    ids[rng.integers(0, n)] = R - 1
    return ids.astype(np.int64), rng.normal(size=(n, D)).astype(np.float32)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_sparse_row_grads_and_update_match_jax_over_five_steps(moments):
    tol = 2e-2 if moments == "bfloat16" else 1e-6
    rng = np.random.default_rng(2)
    table0 = rng.normal(size=(R, D)).astype(np.float32)
    jtable = jnp.asarray(table0)
    jstate = jsparse.init_sparse_table_state(jtable, getattr(jnp, moments))
    ttable = torch.tensor(table0)
    tstate = tsparse.init_sparse_table_state(ttable, getattr(torch, moments))
    touched = np.zeros(R, bool)
    for _ in range(5):
        ids, row_grads = _lookups(rng)
        touched[ids] = True
        juids, jgrads = jsparse.sparse_row_grads(jnp.asarray(row_grads),
                                                 jnp.asarray(ids), R)
        tuids, tgrads = tsparse.sparse_row_grads(torch.tensor(row_grads),
                                                 torch.tensor(ids), R)
        np.testing.assert_array_equal(tuids.numpy(), np.asarray(juids))
        assert (tuids.numpy() == R).sum() > 0   # sentinel pads present
        np.testing.assert_allclose(tgrads.numpy(), np.asarray(jgrads),
                                   rtol=1e-6, atol=1e-6)
        jtable, jstate = jsparse.sparse_adamw_update(
            jtable, jstate, juids, jgrads, lr=0.05, weight_decay=1e-3)
        out, tstate = tsparse.sparse_adamw_update(
            ttable, tstate, tuids, tgrads, lr=0.05, weight_decay=1e-3)
        assert out.data_ptr() == ttable.data_ptr()   # in place
        np.testing.assert_allclose(ttable.numpy(), np.asarray(jtable),
                                   rtol=1e-6, atol=1e-6)
        for t, j in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32),
                                       rtol=tol, atol=tol)
    assert int(tstate.count) == int(jstate.count) == 5
    # untouched rows keep their bits and zero moments; row 0 among them
    assert not touched[0] and touched[R - 1]
    np.testing.assert_array_equal(ttable.numpy()[~touched], table0[~touched])
    assert (tstate.mu.float().numpy()[~touched] == 0).all()
    assert (tstate.nu.float().numpy()[~touched] == 0).all()
    assert not np.array_equal(ttable.numpy()[R - 1], table0[R - 1])


def test_sentinel_slots_are_no_ops_and_row_r_minus_1_gets_only_its_update():
    """Padding slots beside row R-1 must neither alias row 0 (the old
    fill_value=0) nor row R-1 (a clamp): row R-1 moves exactly as when it
    is the only slot."""
    table = torch.ones(8, 3)
    state = tsparse.init_sparse_table_state(table)
    uids, grads = tsparse.sparse_row_grads(torch.ones(4, 3),
                                           torch.tensor([7, 6, 7, 6]), 8)
    assert uids.tolist() == [6, 7, 8, 8]
    tsparse.sparse_adamw_update(table, state, uids, grads, lr=0.1)
    alone = torch.ones(8, 3)
    alone_state = tsparse.init_sparse_table_state(alone)
    tsparse.sparse_adamw_update(alone, alone_state, torch.tensor([7]),
                                torch.full((1, 3), 2.0), lr=0.1)
    assert torch.equal(table[7], alone[7])
    assert torch.equal(state.mu[7], alone_state.mu[7])
    assert (table[:6] == 1.0).all() and (state.mu[:6] == 0).all()


# ---------------------------------------------------------------------------
# The engine's sparse route
# ---------------------------------------------------------------------------

K = 4


def _batch(rng, n_rows, b=6, mask_p=0.8):
    return {"positions": np.tile(np.arange(1, K + 1, dtype=np.int32), (b, 1)),
            "query_doc_ids": rng.integers(0, n_rows, (b, K)).astype(np.int64),
            "clicks": (rng.random((b, K)) < 0.3).astype(np.float32),
            "mask": rng.random((b, K)) < mask_p}


def _all_rows_batch(n_rows, b, seed):
    r = np.random.default_rng(seed)
    return {"positions": np.tile(np.arange(1, K + 1, dtype=np.int32), (b, 1)),
            "query_doc_ids": r.permutation(n_rows).reshape(b, K),
            "clicks": (r.random((b, K)) < 0.3).astype(np.float32),
            "mask": np.ones((b, K), bool)}


def _pair(name, n_rows):
    kw = dict(query_doc_pairs=n_rows, positions=K, init_prob=0.2)
    return (jcore.MODEL_REGISTRY[name](**kw),
            tcore.MODEL_REGISTRY[name](device="cpu", **kw))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("name,n_rows", [("pbm", 24), ("dbn", 40)])
def test_engine_sparse_route_matches_jax(name, n_rows, chunk):
    """Losses, every parameter and the tables' moments at 1e-5. DBN's
    batches have no masked items: a masked item leaves a rounding residue
    of about 1e-10 in its attraction gradient, in JAX and in the port,
    whose sign can differ between them, and Adam's first steps turn a sign
    into a step of about lr, in the dense route as in the sparse one
    (ROADMAP C, reference fact 5)."""
    jm, tm = _pair(name, n_rows)
    mask_p = 1.1 if name == "dbn" else 0.8
    lr, wd = 0.05, 1e-3
    kwargs = dict(sparse_tables=True, chunk_batches=chunk,
                  sparse_table_kwargs=dict(lr=lr, weight_decay=wd))
    jengine = JaxEngine(jm, jopt.adamw(lr, weight_decay=wd), **kwargs)
    tengine = TrainEngine(tm, topt.adamw(lr, weight_decay=wd), **kwargs)
    params = jm.init(jax.random.PRNGKey(1))
    load_jax_params(tm, jax.device_get(params))
    jstate, tstate = jengine.init_opt_state(params), tengine.init_opt_state()
    assert sorted(tstate["sparse"]) == sorted(jstate["sparse"])
    assert len(tstate["dense"][0].mu) == len(tengine.dense_params)
    rng = np.random.default_rng(5)
    for _ in range(6 // chunk):
        batches = [_batch(rng, n_rows, mask_p=mask_p) for _ in range(chunk)]
        chunk_np = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        params, jstate, jl = jengine.step(params, jstate, chunk_np)
        tstate, tl = tengine.step(
            tstate, {k: torch.from_numpy(v) for k, v in chunk_np.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    want, got = _flat(jax.device_get(params)), _flat(export_params(tm))
    assert sorted(want) == sorted(got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))
    for key, st in jstate["sparse"].items():
        tst = tstate["sparse"][key]
        assert int(tst.count) == int(st.count) == 6
        np.testing.assert_allclose(tst.mu.numpy(), np.asarray(st.mu),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tst.nu.numpy(), np.asarray(st.nu),
                                   rtol=1e-5, atol=1e-9)


def _load_jax_state(engine, model, params, jstate):
    """The port's engine state equal to JAX's ``jstate`` and its model's
    parameters to ``params``: the dense Adam moments by parameter path, the
    sparse tables' states by key."""
    load_jax_params(model, jax.device_get(params))
    tstate = engine.init_opt_state()
    sparse = bool(engine.sparse_parts)
    jadam = (jstate["dense"] if sparse else jstate)[0]
    tadam = (tstate["dense"] if sparse else tstate)[0]
    path_of = {id(p): path for path, p in _named(model).items()}
    for moments, jtree in ((tadam.mu, jadam.mu), (tadam.nu, jadam.nu)):
        leaves = _flat(jax.device_get(jtree))
        for moment, p in zip(moments, engine.dense_params):
            moment.copy_(torch.from_numpy(np.array(leaves[path_of[id(p)]])))
    tadam.count.fill_(int(jadam.count))
    for key, st in (jstate["sparse"].items() if sparse else ()):
        tst = tstate["sparse"][key]
        tst.mu.copy_(torch.from_numpy(np.array(st.mu)))
        tst.nu.copy_(torch.from_numpy(np.array(st.nu)))
        tst.count.fill_(int(st.count))
    return tstate


def _moments(engine, model, tstate, jstate):
    """Every first and second moment of both packages, by (kind, path):
    numpy copies, port then JAX (the port updates its moments in place, and
    JAX's step may reuse the buffers it was given)."""
    sparse = bool(engine.sparse_parts)
    jadam = (jstate["dense"] if sparse else jstate)[0]
    tadam = (tstate["dense"] if sparse else tstate)[0]
    path_of = {id(p): path for path, p in _named(model).items()}
    out = {}
    for kind in ("mu", "nu"):
        leaves = _flat(jax.device_get(getattr(jadam, kind)))
        for moment, p in zip(getattr(tadam, kind), engine.dense_params):
            path = path_of[id(p)]
            out[kind, path] = (moment.float().numpy().copy(),
                               leaves[path].copy())
        for key, part in engine.sparse_parts.items():
            path = path_of[id(part.table)]
            out[kind, path] = (
                getattr(tstate["sparse"][key], kind).float().numpy().copy(),
                np.array(getattr(jstate["sparse"][key], kind)))
    return out


def _residue_rows(batch, before, after, table_paths, n_rows, b1):
    """Per table, the rows the batch looks up where a gradient under 1e-8
    reached the first moment in either package: a masked item that feeds no
    live one adds a rounding residue of about 1e-10 to its row, where the
    true gradient is 0. The gradient is read back from the moments, m =
    b1 m_old + (1 - b1) g, in float32 (a zero gradient leaves b1 m_old to
    the bit)."""
    looked_up = np.zeros(n_rows, bool)
    looked_up[batch["query_doc_ids"]] = True
    out = {}
    for path in table_paths:
        grads = [((m - np.float32(b1) * m_old) / np.float32(1 - b1))
                 .reshape(n_rows, -1)
                 for m, m_old in zip(after["mu", path], before["mu", path])]
        small = np.logical_and.reduce([np.abs(g).max(axis=1) < 1e-8
                                       for g in grads])
        nonzero = np.logical_or.reduce([(g != 0).any(axis=1)
                                        for g in grads])
        out[path] = looked_up & small & nonzero
    return out


@pytest.mark.parametrize("sparse_tables", [True, False])
def test_engine_matches_jax_on_masked_dbn_batches_step_by_step(sparse_tables):
    """DBN batches with 20% of items masked, each step from the same state
    in both packages (the port's loaded from JAX's): the loss, and every
    parameter and moment at 1e-5, apart from the residue rows. A residue
    row is one the batch looks up whose gradient should be 0, and is a
    rounding residue under 1e-8 in either package, whose sign can differ;
    Adam then turns the sign into a step of about lr (ROADMAP C, reference
    fact 5). At most 5 such rows a step; some must occur."""
    n_rows, lr, wd, b1 = 40, 0.05, 1e-3, 0.9
    jm, tm = _pair("dbn", n_rows)
    kwargs = dict(sparse_tables=sparse_tables)
    if sparse_tables:
        kwargs["sparse_table_kwargs"] = dict(lr=lr, weight_decay=wd)
    jengine = JaxEngine(jm, jopt.adamw(lr, weight_decay=wd), **kwargs)
    tengine = TrainEngine(tm, topt.adamw(lr, weight_decay=wd), **kwargs)
    params = jm.init(jax.random.PRNGKey(1))
    jstate = jengine.init_opt_state(params)
    table_paths = {path for path, p in _named(tm).items()
                   if p.dim() >= 1 and p.shape[0] == n_rows}
    assert len(table_paths) == 2   # attraction and satisfaction
    rng = np.random.default_rng(5)
    residue_rows_seen = 0
    for _ in range(6):
        batch = _batch(rng, n_rows)
        tstate = _load_jax_state(tengine, tm, params, jstate)
        before = _moments(tengine, tm, tstate, jstate)
        chunk_np = {k: v[None] for k, v in batch.items()}
        params, jstate, jl = jengine.step(params, jstate, chunk_np)
        tstate, tl = tengine.step(
            tstate, {k: torch.from_numpy(v) for k, v in chunk_np.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        got = dict(_flat(export_params(tm)))
        want = _flat(jax.device_get(params))
        pairs = {("param", path): (got[path], want[path]) for path in want}
        pairs.update(_moments(tengine, tm, tstate, jstate))
        residue = _residue_rows(batch, before, pairs, table_paths, n_rows,
                                b1)
        n_residue = sum(int(r.sum()) for r in residue.values())
        assert n_residue <= 5
        residue_rows_seen += n_residue
        for (kind, path), (t, j) in pairs.items():
            if path in table_paths:
                t, j = t[~residue[path]], j[~residue[path]]
            np.testing.assert_allclose(
                t, j, rtol=1e-5,
                atol={"param": 1e-5, "mu": 1e-7, "nu": 1e-9}[kind],
                err_msg=f"{kind} {path}")
    assert residue_rows_seen > 0


def test_port_sparse_matches_port_dense_when_every_row_is_touched():
    """On a table whose every row is in every batch, lazy AdamW is dense
    AdamW: params, moments and losses at 1e-5 (JAX's own two forms differ
    by one ulp in the moments on this tree)."""
    n_rows, lr, wd = 24, 0.05, 1e-3
    _, dense_model = _pair("pbm", n_rows)
    _, sparse_model = _pair("pbm", n_rows)
    dense = TrainEngine(dense_model, topt.adamw(lr, weight_decay=wd))
    sparse = TrainEngine(sparse_model, topt.adamw(lr, weight_decay=wd),
                         sparse_tables=True,
                         sparse_table_kwargs=dict(lr=lr, weight_decay=wd))
    sd, ss = dense.init_opt_state(), sparse.init_opt_state()
    for step in range(5):
        chunk = {k: torch.from_numpy(v[None])
                 for k, v in _all_rows_batch(n_rows, 6, step).items()}
        sd, ld = dense.step(sd, chunk)
        ss, ls = sparse.step(ss, chunk)
        np.testing.assert_allclose(ls.numpy(), ld.numpy(), rtol=1e-5)
    for (name, pd), ps in zip(dense_model.named_parameters(),
                              sparse_model.parameters()):
        np.testing.assert_allclose(ps.detach().numpy(), pd.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    table = dict(dense_model.named_parameters())["parts.attraction.table"]
    i = [p is table for p in dense.params].index(True)
    st = ss["sparse"]["attraction/table"]
    np.testing.assert_allclose(st.mu.numpy(), sd[0].mu[i].numpy(),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(st.nu.numpy(), sd[0].nu[i].numpy(),
                               rtol=1e-5, atol=1e-9)


def test_engine_leaves_untouched_rows_undecayed():
    n_rows = 24
    _, tm = _pair("pbm", n_rows)
    engine = TrainEngine(tm, topt.adamw(0.05, weight_decay=0.0),
                         sparse_tables=True,
                         sparse_table_kwargs=dict(lr=0.05, weight_decay=0.0))
    state = engine.init_opt_state()
    table = tm.parts["attraction"].table
    table0 = table.detach().clone()
    r = np.random.default_rng(9)
    batch = _batch(r, 8, mask_p=1.1)
    for _ in range(4):
        state, _ = engine.step(state, {k: torch.from_numpy(v[None])
                                       for k, v in batch.items()})
    st = state["sparse"]["attraction/table"]
    assert torch.equal(table[8:], table0[8:])
    assert (st.mu[8:] == 0).all() and (st.nu[8:] == 0).all()
    assert not torch.equal(table[:8], table0[:8])
    assert int(st.count) == 4


# ---------------------------------------------------------------------------
# make_sparse_embedding_train_step
# ---------------------------------------------------------------------------

def test_make_sparse_embedding_train_step_matches_jax():
    """A tiny model: rows gathered from an (R, 3) table, a dense (3,)
    weight and bias, squared error against targets; AdamW on the dense
    side, lazy AdamW on the table, five steps."""
    n_rows, lr = 20, 0.05
    rng = np.random.default_rng(6)
    table0 = rng.normal(size=(n_rows, D)).astype(np.float32)
    w0 = rng.normal(size=(D,)).astype(np.float32)

    def j_gather(table, batch):
        return jnp.take(table, batch["ids"], axis=0), batch["ids"]

    def j_forward(dense, rows, batch):
        pred = rows @ dense["w"] + dense["b"]
        return jnp.mean(jnp.square(pred - batch["y"]))

    def t_gather(table, batch):
        return table[batch["ids"]], batch["ids"]

    def t_forward(dense, rows, batch):
        w, b = dense
        pred = rows @ w + b
        return torch.mean(torch.square(pred - batch["y"]))

    jinit, jstep = jsparse.make_sparse_embedding_train_step(
        j_forward, j_gather, lr=lr, n_rows=n_rows, weight_decay=1e-3,
        dense_optimizer=jopt.adamw(lr, weight_decay=1e-3))
    tinit, tstep = tsparse.make_sparse_embedding_train_step(
        t_forward, t_gather, lr=lr, n_rows=n_rows, weight_decay=1e-3,
        dense_optimizer=topt.adamw(lr, weight_decay=1e-3))
    jtable = jnp.asarray(table0)
    jdense = {"b": jnp.zeros(()), "w": jnp.asarray(w0)}
    ttable = torch.tensor(table0)
    tdense = [torch.tensor(w0, requires_grad=True),
              torch.zeros((), requires_grad=True)]
    js, jo = jinit(jtable, jdense)
    ts, to = tinit(ttable, tdense)
    for _ in range(5):
        ids = rng.integers(0, n_rows, (7, 2))
        y = rng.normal(size=(7, 2)).astype(np.float32)
        jtable, js, jdense, jo, jl = jstep(
            jtable, js, jdense, jo, {"ids": jnp.asarray(ids),
                                     "y": jnp.asarray(y)})
        ttable, ts, tdense, to, tl = tstep(
            ttable, ts, tdense, to, {"ids": torch.from_numpy(ids),
                                     "y": torch.from_numpy(y)})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ttable.numpy(), np.asarray(jtable), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tdense[0].detach().numpy(),
                               np.asarray(jdense["w"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tdense[1].detach()), float(jdense["b"]),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Error paths and the launcher
# ---------------------------------------------------------------------------

def test_sparse_tables_refuse_qr_compression():
    model = tcore.PositionBasedModel(
        query_doc_pairs=1024, positions=4, device="cpu",
        attraction=tcore.EmbeddingParameterConfig(
            parameters=1024, compression=tcore.Compression.QR,
            compression_ratio=4))
    with pytest.raises(NotImplementedError, match="quotient-remainder"):
        TrainEngine(model, topt.adamw(0.05), sparse_tables=True,
                    sparse_table_kwargs=dict(lr=0.05, weight_decay=0.0))


def test_sparse_tables_refuse_a_model_without_tables():
    model = tcore.MODEL_REGISTRY["gctr"](query_doc_pairs=10, positions=4,
                                         device="cpu")
    with pytest.raises(ValueError, match="no EmbeddingParameter"):
        TrainEngine(model, topt.adamw(0.05), sparse_tables=True,
                    sparse_table_kwargs=dict(lr=0.05, weight_decay=0.0))


@pytest.mark.parametrize("kwargs,missing", [
    (dict(lr=0.05), "weight_decay"), (dict(weight_decay=0.0), "lr"),
    (None, "lr")])
def test_sparse_tables_require_explicit_hyperparams(kwargs, missing):
    model = tcore.PositionBasedModel(query_doc_pairs=64, positions=4,
                                     device="cpu")
    with pytest.raises(ValueError, match=missing):
        TrainEngine(model, topt.adamw(0.05), sparse_tables=True,
                    sparse_table_kwargs=kwargs)


def test_launcher_refuses_sparse_tables_with_qr(capsys):
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--sparse-tables", "--compression",
                           "quotient_remainder", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--sparse-tables does not support" in capsys.readouterr().err


def test_launcher_trains_with_sparse_tables_on_cpu(capsys):
    results = launch_train.main([
        "--model", "dbn", "--sessions", "1500", "--epochs", "2",
        "--batch", "128", "--compression", "hash", "--ratio", "2",
        "--chunk-batches", "4", "--sparse-tables", "--device", "cpu"])
    assert "[train] test:" in capsys.readouterr().out
    assert all(np.isfinite(results[k]) for k in ("ll", "ppl", "cond_ppl"))
    assert 1.0 < results["ppl"] < 2.0
