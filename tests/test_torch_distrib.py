"""The port's distributed layer against ``repro.distrib`` on the CPU.

In the test process: the sharding rules and specs against JAX's (on
stand-in meshes), the int8 and error-feedback tests of
``tests/test_distrib.py`` on the port, ``compress_correct`` to the bit,
the package's exports, and the mesh constructors' refusals (no card here:
a mesh that needs one raises, and nothing falls back to gloo).

On a spawned gloo world of 8 ranks, a ``(2, 4)`` ``("data", "model")``
mesh (one world for every check below, see ``tests/_dist_worlds.py``),
against JAX's 8-device run of the same numpy inputs (a subprocess with
``--xla_force_host_platform_device_count=8``, as JAX's own tests run it):
``masked_psum_lookup``'s value (1e-6) and table gradient (1e-5); the same
lookup with ``torch.distributed.nn``'s all-reduce, whose backward sums
over ``model``, must miss the gradient by the model axis's size; the
pjit-style ``sharded_embedding_lookup``; ``compressed_psum`` over
``data`` to the bit; the mesh constructors; the rules' specs and blocks on
a real mesh; GraphSAGE's edge-sharded and dst-partitioned forward, loss
and gradients against JAX's dense and sharded forms at 1e-5.
"""
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _dist_worlds
from repro import distrib as jdistrib
from repro.distrib import compression as jcomp
from repro.distrib import shardings as jshard
from repro_torch import distrib as tdistrib
from repro_torch.distrib import compression as tcomp
from repro_torch.distrib import shardings as tshard
from repro_torch.launch import mesh as tmesh

N_SAGE, E_SAGE = 160, 800

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.compat import make_auto_mesh, set_mesh, shard_map
from repro.distrib import masked_psum_lookup
from repro.distrib.compression import compressed_psum, CompressedAllReduce
from repro.models.gnn import SAGEConfig
from repro.models.gnn.graphsage import (full_graph_forward,
                                        node_classification_loss)

inp = dict(np.load(sys.argv[1]))
mesh = make_auto_mesh((2, 4), ("data", "model"))
out = {}
table, ids = jnp.asarray(inp["table"]), jnp.asarray(inp["ids"])
with set_mesh(mesh):
    lookup = masked_psum_lookup(mesh, batch_dims=2)
    tsh = jax.device_put(table, NamedSharding(mesh, P("model", None)))
    out["lookup"] = np.asarray(jax.jit(lookup)(
        tsh, jax.device_put(ids, NamedSharding(mesh, P("data", None)))))
    out["lookup_grad"] = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(lookup(t, ids) ** 2)))(tsh))

    def body(g):
        red, st = compressed_psum(g, "data", CompressedAllReduce.init(g))
        return red, st.error

    f = shard_map(body, mesh=mesh, in_specs=P("data", None),
                  out_specs=(P("data", None), P("data", None)))
    red, err = jax.jit(f)(jnp.asarray(inp["grads"]))
    out["compressed"], out["compressed_error"] = np.asarray(red), \
        np.asarray(err)

params = {f"layer_{l}": {k: jnp.asarray(inp[f"layer_{l}/{k}"])
                         for k in ("w_self", "w_neigh", "bias")}
          for l in range(2)}
cfg0 = SAGEConfig(n_layers=2, d_in=12, d_hidden=16, n_classes=4)
cfg1 = dataclasses.replace(cfg0, partitioned_edges=True)
keys = ("features", "src", "dst", "degree_inv", "labels")
graphs = {"graph": {k: jnp.asarray(inp["g/" + k]) for k in keys},
          "graph_dst": {**{k: jnp.asarray(inp["g/" + k]) for k in keys},
                        **{k: jnp.asarray(inp["gp/" + k])
                           for k in ("src", "dst", "edge_weight")}}}

def run(name, cfg, graph, m):
    def loss_fn(p):
        logits = full_graph_forward(cfg, p, graph, m)
        return node_classification_loss(logits, graph["labels"]), logits
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    out[name] = np.asarray(logits)
    out[name + "_loss"] = np.asarray(loss)
    for l, layer in grads.items():
        for k, v in layer.items():
            out[f"{name}_grads/{l}.{k}"] = np.asarray(v)

run("sage_dense", cfg0, graphs["graph"], None)
run("sage_dense_797", cfg0, {**graphs["graph"],
                             "src": graphs["graph"]["src"][:797],
                             "dst": graphs["graph"]["dst"][:797]}, None)
with set_mesh(mesh):
    run("sage_sharded", cfg0, graphs["graph"], mesh)
    run("sage_dst_partitioned", cfg1, graphs["graph_dst"], mesh)
np.savez(sys.argv[2], **out)
print("JAX_DISTRIB_OK")
"""


def _inputs():
    from repro_torch.models.gnn import random_graph

    rng = np.random.default_rng(0)
    lookup = {"table": rng.normal(size=(64, 4)).astype(np.float32),
              "ids": rng.integers(0, 64, size=(8, 5)).astype(np.int64)}
    compress = {"grads": rng.normal(size=(8, 16)).astype(np.float32)}
    g = random_graph(N_SAGE, E_SAGE, 12, 4, seed=0)
    n_local = N_SAGE // 8
    buckets = [[] for _ in range(8)]
    for e in range(E_SAGE):
        buckets[g["dst"][e] // n_local].append(e)
    cap = max(len(b) for b in buckets)
    src, dst, w = [], [], []
    for i, b in enumerate(buckets):
        idx = np.asarray(b, np.int64)
        src.extend(g["src"][idx])
        dst.extend(g["dst"][idx])
        w.extend([1.0] * len(b))
        for _ in range(cap - len(b)):
            src.append(0)
            dst.append(i * n_local)
            w.append(0.0)
    gp = {"src": np.asarray(src, np.int32), "dst": np.asarray(dst, np.int32),
          "edge_weight": np.asarray(w, np.float32)}
    dims = [12, 16, 4]
    params = {f"layer_{l}": {
        "w_self": rng.normal(size=(dims[l], dims[l + 1])).astype(
            np.float32) / np.sqrt(dims[l]),
        "w_neigh": rng.normal(size=(dims[l], dims[l + 1])).astype(
            np.float32) / np.sqrt(dims[l]),
        "bias": rng.normal(size=(dims[l + 1],)).astype(np.float32) * 0.1}
        for l in range(2)}
    keys = ("features", "src", "dst", "degree_inv", "labels")
    graph = {k: g[k] for k in keys}
    sage = {"params": params, "graph": graph,
            "graph_dst": {**graph, **gp}}
    flat = {**lookup, **compress,
            **{f"g/{k}": v for k, v in graph.items()},
            **{f"gp/{k}": v for k, v in gp.items()},
            **{f"{l}/{k}": v for l, layer in params.items()
               for k, v in layer.items()}}
    return lookup, compress, sage, flat


@pytest.fixture(scope="module")
def worlds():
    """JAX's 8-device run and the port's 8-rank world, side by side."""
    lookup, compress, sage, flat = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **flat)
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
            os.path.dirname(__file__), "..", "src"))
        proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, src, dst],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        try:
            ranks = _dist_worlds.spawn("distrib", 8, lookup=lookup,
                                       compress=compress, sage=sage)
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        assert "JAX_DISTRIB_OK" in out
        jax_out = dict(np.load(dst))
    return SimpleNamespace(ranks=ranks, jax=jax_out, lookup=lookup)


def _blocks(worlds, key, axis):
    """The ranks' ``key`` arrays as JAX's global array: blocks along dim
    0 by ``axis`` ("data" or "model"), one rank per block."""
    at = 0 if axis == "data" else 1
    first = {}
    for r in worlds.ranks:
        first.setdefault(r["coords"][at], r[key])
    return np.concatenate([first[i] for i in sorted(first)])


# ---------------------------------------------------------------------------
# the world's checks
# ---------------------------------------------------------------------------

def test_mesh_coordinates_are_row_major(worlds):
    assert [r["coords"] for r in worlds.ranks] == \
        [(d, m) for d in range(2) for m in range(4)]
    assert [r["data_index"] for r in worlds.ranks] == \
        [d for d in range(2) for _ in range(4)]


def test_masked_psum_lookup_matches_jax(worlds):
    """Each data rank's rows, the same on its four model ranks, at 1e-6;
    the table shards' gradient of the global batch at 1e-5."""
    for r in worlds.ranks:
        d = r["coords"][0]
        np.testing.assert_allclose(r["lookup"],
                                   worlds.jax["lookup"][4 * d:4 * d + 4],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_blocks(worlds, "lookup_grad", "model"),
                               worlds.jax["lookup_grad"], rtol=1e-5,
                               atol=1e-5)
    table, ids = worlds.lookup["table"], worlds.lookup["ids"]
    ref = np.zeros_like(table)
    np.add.at(ref, ids.reshape(-1), 2 * table[ids].reshape(-1, 4))
    np.testing.assert_allclose(_blocks(worlds, "lookup_grad", "model"), ref,
                               rtol=1e-5, atol=1e-5)


def test_all_reduce_with_summing_backward_misses_by_the_model_size(worlds):
    """torch.distributed.nn's all_reduce sums the gradients over 'model'
    in its backward: the table gradient comes out 4 times JAX's."""
    trap = _blocks(worlds, "trap_grad", "model")
    want = worlds.jax["lookup_grad"]
    assert not np.allclose(trap, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trap, 4 * want, rtol=1e-5, atol=1e-5)


def test_sharded_embedding_lookup_matches_jax(worlds):
    for r in worlds.ranks:
        d = r["coords"][0]
        np.testing.assert_allclose(r["sharded"],
                                   worlds.jax["lookup"][4 * d:4 * d + 4],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_blocks(worlds, "sharded_grad", "model"),
                               worlds.jax["lookup_grad"], rtol=1e-5,
                               atol=1e-5)


def test_lookup_refuses_other_batch_dims_and_moe_dispatch_raises(worlds):
    for r in worlds.ranks:
        assert "batch_dims=2" in r["bad_batch_dims"]
        assert "MoELayer" in r["moe"]


def test_compressed_psum_equals_jax_to_the_bit(worlds):
    """The reduced means equal JAX's to the bit. The residual the error
    feedback carries does not: jitted, XLA contracts ``g - q * scale`` into
    one fused multiply-add, where the port (and JAX un-jitted, see
    ``test_compress_correct_equals_jax_over_steps``) rounds the product
    first, so the two differ by at most one rounding of ``q * scale``."""
    grads = _inputs()[1]["grads"]
    ulp = np.spacing(np.float32(np.abs(grads).max()))
    for r in worlds.ranks:
        d = r["coords"][0]
        np.testing.assert_array_equal(
            r["compressed"], worlds.jax["compressed"][4 * d:4 * d + 4])
        gap = np.abs(r["compressed_error"]
                     - worlds.jax["compressed_error"][4 * d:4 * d + 4])
        assert gap.max() <= ulp, (gap.max(), ulp)
    np.testing.assert_allclose(worlds.ranks[0]["compressed"],
                               (grads[:4] + grads[4:]) / 2, atol=0.05)


def test_mesh_constructors_on_a_world_of_8(worlds):
    for r in worlds.ranks:
        assert r["smoke_shape"] == (1, 8)
        assert r["dp_shape"] == (8, 1)
        assert r["dp_names"] == ("data", "model")
        assert "256 ranks" in r["production"]
        assert "512 ranks" in r["production_pods"]
        assert "9 ranks" in r["wrong_shape"]


def test_rules_and_blocks_on_the_mesh(worlds):
    full = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    for r in worlds.ranks:
        d, m = r["coords"]
        assert r["specs"] == {"table": ("model", None), "small": (),
                              "stacked": ()}
        assert r["replica_specs"] == {"table": (), "small": (),
                                      "stacked": (None, "model")}
        np.testing.assert_array_equal(r["table_block"],
                                      full[16 * m:16 * m + 16])
        i = 4 * d + m
        np.testing.assert_array_equal(r["batch_block"], full[8 * i:8 * i + 8])


def test_pod_and_data_axes_make_one_group(worlds):
    """On a (2, 2, 2) ("pod", "data", "model") mesh the data-parallel
    group spans both data axes: the ranks of one model coordinate, and
    the rank's batch block is its row-major (pod, data) index."""
    for rank, r in enumerate(worlds.ranks):
        assert r["pod_data_ranks"] == [q for q in range(8)
                                       if q % 2 == rank % 2]
        assert r["cube_data_index"] == rank // 2


@pytest.mark.parametrize("form", ["sharded", "dst_partitioned",
                                  "sharded_797"])
def test_graphsage_sharded_forms_match_jax(worlds, form):
    """Logits against JAX's dense and its own sharded form, the loss, and
    every parameter's gradient (the same on every rank) at 1e-5. With 797
    edges the edge-sharded form pads 3 weight-0 edges (JAX's shard_map
    takes only a multiple of the ranks: its dense form is the
    reference)."""
    wants = (("sage_dense_797",) if form == "sharded_797"
             else ("sage_dense", f"sage_{form}"))
    for want in wants:
        for r in worlds.ranks:
            np.testing.assert_allclose(r[f"sage_{form}"], worlds.jax[want],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r[f"sage_{form}_loss"],
                                       worlds.jax[want + "_loss"], rtol=1e-5)
            for name, g in r[f"sage_{form}_grads"].items():
                np.testing.assert_allclose(
                    g, worlds.jax[f"{want}_grads/{name}"], rtol=1e-5,
                    atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# in the test process
# ---------------------------------------------------------------------------

class _StubMesh:
    """The parts of a mesh the rules read, JAX's and the port's."""

    def __init__(self, names, sizes):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self._sizes = tuple(sizes)

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("names,sizes", [
    (("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)),
    (("data", "model"), (8, 1)), (("data", "model"), (1, 4))])
def test_specs_match_jax(names, sizes):
    mesh = _StubMesh(names, sizes)
    assert tshard.DATA_AXES(mesh) == jshard.DATA_AXES(mesh)
    assert tshard.data_parallel_size(mesh) == jshard.data_parallel_size(mesh)
    for fn in ("batch_spec", "table_spec"):
        for extra in (0, 1, 2):
            assert tuple(getattr(tshard, fn)(mesh, extra)) == \
                tuple(getattr(jshard, fn)(mesh, extra))
    assert tuple(tshard.chunked_batch_spec(mesh)) == \
        tuple(jshard.chunked_batch_spec(mesh))
    assert tuple(tshard.replicated_spec()) == tuple(jshard.replicated_spec())


@pytest.mark.parametrize("min_rows,leading", [(1 << 16, 0), (1 << 16, 1),
                                              (10, 0), (1_000_000, 0)])
def test_clax_param_rule_matches_jax(min_rows, leading):
    mesh = _StubMesh(("data", "model"), (2, 4))
    shapes = [(1 << 16, 1), (1 << 16,), (3, 1 << 16, 2), (65_538, 4), (10,),
              (), (1_000_000, 1), (40, 12)]
    jrule = jshard.clax_param_rule(mesh, min_rows, leading)
    trule = tshard.clax_param_rule(mesh, min_rows, leading)
    for shape in shapes:
        assert tuple(trule("x", np.zeros(shape))) == \
            tuple(jrule(None, jnp.zeros(shape))), shape


def test_exports_match_jax():
    assert set(tdistrib.__all__) == set(jdistrib.__all__)
    for name in tdistrib.__all__:
        assert hasattr(tdistrib, name)


def test_int8_quantization_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)) * 3.0
    q, scale = tcomp.quantize_int8(x)
    assert q.dtype == torch.int8
    err = (tcomp.dequantize_int8(q, scale) - x).abs().max()
    assert float(err) <= float(scale) / 2 + 1e-6


def _quadratic(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(16, 16)).astype(np.float32)
    A = A @ A.T / 16 + np.eye(16, dtype=np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(b)


def test_error_feedback_converges_on_quadratic():
    A, b = _quadratic(1)
    x_star = torch.linalg.solve(A, b)
    x = torch.zeros(16)
    state = tcomp.CompressedAllReduce.init(x)
    for _ in range(400):
        payload, state = state.compress_correct(A @ x - b)
        x = x - 0.1 * tcomp.dequantize_int8(*payload)
    np.testing.assert_allclose(x.numpy(), x_star.numpy(), atol=1e-2)


def test_compression_without_error_feedback_is_worse():
    A, b = _quadratic(2)
    x_star = torch.linalg.solve(A, b)

    def run(use_ef):
        x = torch.zeros(16)
        state = tcomp.CompressedAllReduce.init(x)
        for _ in range(200):
            g = A @ x - b
            if use_ef:
                payload, state = state.compress_correct(g)
            else:
                payload = tcomp.quantize_int8(g)
            x = x - 0.1 * tcomp.dequantize_int8(*payload)
        return float(torch.linalg.norm(x - x_star))

    assert run(True) <= run(False) + 1e-6


def test_compress_correct_equals_jax_over_steps():
    """Five error-feedback steps over a tree: payloads, residuals and
    decompressed gradients equal to JAX's to the bit."""
    rng = np.random.default_rng(4)
    grads = [{"a": rng.normal(size=(7, 3)).astype(np.float32) * 10.0 ** k,
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
             for k in range(5)]
    tstate = tcomp.CompressedAllReduce.init(
        {"a": torch.zeros(7, 3), "b": [torch.zeros(5)]})
    jstate = jcomp.CompressedAllReduce.init(
        {"a": jnp.zeros((7, 3)), "b": [jnp.zeros(5)]})
    for g in grads:
        tp, tstate = tstate.compress_correct(
            {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(
                g["b"][0])]})
        jp, jstate = jstate.compress_correct(
            {"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]})
        for t, j in ((tp["a"], jp["a"]), (tp["b"][0], jp["b"][0])):
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(tstate.error["a"].numpy(),
                                      np.asarray(jstate.error["a"]))
        td = tcomp.CompressedAllReduce.decompress(tp)
        jd = jcomp.CompressedAllReduce.decompress(jp)
        np.testing.assert_array_equal(td["b"][0].numpy(),
                                      np.asarray(jd["b"][0]))


@pytest.mark.parametrize("make", [
    lambda: tmesh.make_data_parallel_mesh(),
    lambda: tmesh.make_smoke_mesh(1),
    lambda: tmesh.make_mesh((1, 1), ("data", "model"))])
def test_cuda_meshes_raise_without_a_card(make):
    """The entry points default to the card; with none they raise before
    any process group starts, and nothing falls back to gloo."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="card"):
        make()
    assert not dist.is_initialized()


def test_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.PRODUCTION_SHAPES[True] == ((2, 16, 16),
                                             ("pod", "data", "model"))
