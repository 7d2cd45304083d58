"""The LM family's sharded forms against JAX's, on the CPU.

In the test process: ``param_specs`` and ``cache_specs`` against JAX's
for the five LM configs on ``(2, 4)`` and JAX's production shapes 16 x 16
and 2 x 16 x 16 (JAX's ``AbstractMesh`` beside the port's), entry by
entry; ``LMConfig``'s sharded fields and their defaults.

On a spawned gloo world of 8 ranks (``tests/_dist_worlds.py``,
``task_lm8``) beside one JAX subprocess with
``--xla_force_host_platform_device_count=8`` computing the same float32
configs from the same init trees and numpy batches, at 1e-5:

* forward, ``lm_loss`` and every gradient on ``(2, 4)``, ``(8, 1)`` and
  ``(1, 8)``, for JAX's own test config (2 KV heads of 16: the guard
  splits ``wk`` mid-head on 4 and 8 model ranks) and one whose heads each
  model size divides (and whose vocabulary pads 61 to 64);
* two ``param_specs``-placed AdamW steps with ``microbatches=2`` and
  uneven target masks, ``explicit_row_parallel`` off and on; the same
  with microbatches the data ranks do not divide (4 rows over 8, 12 over
  8, 1 over 2), and the uneven splits JAX's ``shard_map`` refuses (the
  capacity MoE, the explicit row-parallel matmul) refused alike;
* the capacity-bounded MoE at ``capacity_factor=1.25`` on ``(2, 4)`` and
  ``(8, 1)`` (two functions: capacity counts each data rank's tokens), and
  at 64 on ``(2, 4)`` and ``(1, 8)`` against JAX's dense oracle;
* eight plain decode steps filling a sequence-split cache, then a flash
  decoding step at index 8, the logits and the cache; the same with the
  sequence split over every axis and the batch whole;
* a prefill's cache in ``cache_specs``' placement;
* two traps, each on the wrong form: the FSDP gather with a slicing
  backward, and microbatches cut from each rank's own rows.
"""
import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _dist_worlds as W

TOL = 1e-5

JAX_SCRIPT = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import optim
from repro.compat import make_auto_mesh, set_mesh
from repro.models.lm import (LMConfig, init_params, forward, lm_loss,
                             make_train_step, param_specs, init_cache,
                             make_decode_step, make_prefill_step)

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "targets": jnp.asarray(inp["targets"])}
out = {}

def cfg_of(name, **kw):
    return LMConfig(**{**spec["cfgs"][name], **kw}, dtype=jnp.float32,
                    param_dtype=jnp.float32)

def flat(prefix, tree):
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/" + "/".join(str(k.key) for k in path)] = \
            np.asarray(v)

def tree_of(prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v)
    return tree

params = {n: tree_of("params/" + n) for n in spec["cfgs"]}
meshes = {tuple(s): make_auto_mesh(tuple(s), ("data", "model"))
          for s in spec["meshes"]}

def placed(cfg, name, mesh):
    return jax.device_put(params[name], jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), param_specs(cfg, mesh)))

def loss_grads(key, cfg, name, mesh):
    def f(p):
        logits = forward(cfg, p, batch["tokens"], mesh)
        return lm_loss(cfg, p, batch, mesh), logits
    if mesh is None:
        (loss, logits), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params[name])
    else:
        with set_mesh(mesh):
            (loss, logits), g = jax.jit(jax.value_and_grad(
                f, has_aux=True))(placed(cfg, name, mesh))
    out[key + "/loss"], out[key + "/logits"] = np.asarray(loss), \
        np.asarray(logits)
    flat(key + "/grads", g)

for name in ("gqa", "heads"):
    for s, mesh in meshes.items():
        loss_grads(f"loss/{name}/{s}", cfg_of(name), name, mesh)
for name, s, erp in spec["train"]:
    cfg = cfg_of(name, microbatches=2, explicit_row_parallel=erp)
    mesh = meshes[tuple(s)]
    opt = optim.adamw(spec["lr"], eps=spec["eps"])
    with set_mesh(mesh):
        p = placed(cfg, name, mesh)
        st = opt.init(p)
        step = jax.jit(make_train_step(cfg, opt, mesh))
        losses = []
        for _ in range(2):
            p, st, loss = step(p, st, batch)
            losses.append(float(loss))
    key = f"train/{name}/{tuple(s)}/{erp}"
    out[key + "/losses"] = np.asarray(losses)
    flat(key + "/params", p)
batches = {16: batch, 24: {"tokens": jnp.asarray(inp["tokens24"]),
                           "targets": jnp.asarray(inp["targets24"])}}
for name, s, M, n in spec["uneven"]:
    cfg = cfg_of(name, microbatches=M)
    mesh = meshes[tuple(s)]
    opt = optim.adamw(spec["lr"], eps=spec["eps"])
    with set_mesh(mesh):
        p = placed(cfg, name, mesh)
        st = opt.init(p)
        step = jax.jit(make_train_step(cfg, opt, mesh))
        losses = []
        for _ in range(2):
            p, st, loss = step(p, st, batches[n])
            losses.append(float(loss))
    key = f"uneven/{name}/{tuple(s)}/{M}/{n}"
    out[key + "/losses"] = np.asarray(losses)
    flat(key + "/params", p)
refused = {}
for name, s, M, n, kw in spec["refused"]:
    cfg = cfg_of(name, microbatches=M, **kw)
    mesh = meshes[tuple(s)]
    opt = optim.adamw(spec["lr"], eps=spec["eps"])
    try:
        with set_mesh(mesh):
            p = placed(cfg, name, mesh)
            jax.jit(make_train_step(cfg, opt, mesh))(p, opt.init(p),
                                                     batches[n])
        refused[f"{name}/{tuple(s)}/{M}/{n}"] = None
    except Exception as e:
        refused[f"{name}/{tuple(s)}/{M}/{n}"] = f"{type(e).__name__}: {e}"
print("REFUSED " + json.dumps(refused))
for cf, s in spec["moe"]:
    loss_grads(f"moe/{cf}/{tuple(s)}", cfg_of("moe", capacity_factor=cf),
               "moe", meshes[tuple(s)])
loss_grads("moe/oracle", cfg_of("moe"), "moe", None)

# decode: 8 plain steps on (2, 4), then one flash step (FLASH_DECODE_SCRIPT)
mesh = meshes[(2, 4)]
toks, nxt = jnp.asarray(inp["dec_tokens"]), jnp.asarray(inp["dec_next"])
for key, seq_axes, dp in (("decode", ("model",), None),
                          ("decode_all_axes", ("data", "model"), ())):
    cfg = cfg_of("gqa", decode_seq_axes=seq_axes)
    with set_mesh(mesh):
        p = placed(cfg, "gqa", mesh)
        cache = init_cache(cfg, batch=toks.shape[0], max_seq=cfg.max_seq)
        dec = jax.jit(make_decode_step(cfg, mesh=mesh, dp_axes=dp))
        for i in range(8):
            lg, cache = dec(p, cache, toks[:, i:i + 1], jnp.int32(i))
            out[f"{key}/logits/{i}"] = np.asarray(lg)
        cspec = P(None, None, "data" if dp is None else None, seq_axes,
                  None, None)
        cache = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(mesh, cspec)), cache)
        flash = jax.jit(make_decode_step(
            dataclasses.replace(cfg, flash_decode=True), mesh=mesh,
            dp_axes=dp))
        lg, cache = flash(p, cache, nxt, jnp.int32(8))
    out[f"{key}/logits/8"] = np.asarray(lg)
    for k in ("k", "v"):
        out[f"{key}/cache/{k}"] = np.asarray(cache[k])
cfg = cfg_of("heads")
with set_mesh(mesh):
    lg, cache = jax.jit(make_prefill_step(cfg, mesh))(
        placed(cfg, "heads", mesh), toks)
out["prefill/logits"] = np.asarray(lg)
for k in ("k", "v"):
    out[f"prefill/cache/{k}"] = np.asarray(cache[k])
np.savez(sys.argv[2], **out)
print("JAX_LM_MESH_OK")
"""


def _inputs():
    rng = np.random.default_rng(12)
    vocab = min(c["vocab"] for c in W.LM_CFGS.values())
    return {"tokens": rng.integers(0, vocab, (16, 8)).astype(np.int32),
            # uneven masks: each microbatch and rank its own count
            "targets": rng.integers(-1, vocab, (16, 8)).astype(np.int32),
            "dec_tokens": rng.integers(0, vocab, (4, 8)).astype(np.int32),
            "dec_next": rng.integers(0, vocab, (4, 1)).astype(np.int32),
            # 3 rows a rank on (8, 1): microbatches of 12 rows over 8 ranks
            "tokens24": rng.integers(0, vocab, (24, 8)).astype(np.int32),
            "targets24": rng.integers(-1, vocab, (24, 8)).astype(np.int32)}


def _trees():
    """Each config's parameters, drawn by the port's init (seed i) and
    exported as JAX's tree: both sides start from them."""
    from repro_torch import convert
    from repro_torch.models import lm

    return {n: convert.export_params(lm.init_params(
        W.lm_config(n), device="cpu", seed=i))
        for i, n in enumerate(W.LM_CFGS)}


def _flat(prefix, tree):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key, sub in tree.items()
            for k, v in _flat(f"{prefix}/{key}", sub).items()}


@pytest.fixture(scope="module")
def worlds():
    inp = _inputs()
    trees = _trees()
    spec = {"cfgs": W.LM_CFGS, "meshes": W.LM_MESHES,
            "train": W.LM_TRAIN, "moe": W.LM_MOE, "lr": W.LM_LR,
            "eps": W.LM_EPS, "uneven": W.LM_UNEVEN,
            "refused": W.LM_REFUSED}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **inp, **_flat("params", trees))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
            os.path.dirname(__file__), "..", "src"))
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, src, dst, json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        try:
            ranks = W.spawn("lm8", 8, timeout=300, trees=trees,
                            batch={k: inp[k] for k in ("tokens", "targets")},
                            dec={"tokens": inp["dec_tokens"],
                                 "next": inp["dec_next"]},
                            batch24={"tokens": inp["tokens24"],
                                     "targets": inp["targets24"]})
            out, err = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        assert "JAX_LM_MESH_OK" in out
        jax_out = dict(np.load(dst))
    refused = json.loads(next(line for line in out.splitlines()
                              if line.startswith("REFUSED "))[8:])
    return SimpleNamespace(ranks=ranks, jax=jax_out, refused=refused)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _close_tree(got, jax_out, prefix):
    want = {k[len(prefix) + 1:].replace("/", "."): v
            for k, v in jax_out.items() if k.startswith(prefix + "/")}
    assert set(got) == set(want)
    for name, v in got.items():
        _close(v, want[name], f"{prefix} {name}")


def _worst(got, jax_out, prefix):
    return max(float(np.abs(v - jax_out[prefix + "/" + n.replace(".", "/")])
                     .max()) for n, v in got.items())


# ---------------------------------------------------------------------------
# the world's checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", W.LM_MESHES)
@pytest.mark.parametrize("name", ["gqa", "heads"])
def test_forward_loss_and_gradients_match_jax(worlds, name, shape):
    key = f"loss/{name}/{shape}"
    for r in worlds.ranks:
        got = r[("loss", name, shape)]
        _close(got["loss"], worlds.jax[key + "/loss"], key)
        # JAX's forward leaves the padded columns unmasked: all of them
        _close(got["logits"], worlds.jax[key + "/logits"], key)
        _close_tree(got["grads"], worlds.jax, key + "/grads")
        # the card's adamw takes contiguous tensors only
        assert got["contiguous"]


@pytest.mark.parametrize("name,shape,erp", W.LM_TRAIN)
def test_two_microbatched_steps_match_jax(worlds, name, shape, erp):
    key = f"train/{name}/{shape}/{erp}"
    for r in worlds.ranks:
        got = r[("train", name, shape, erp)]
        _close(got["losses"], worlds.jax[key + "/losses"], key)
        _close_tree(got["params"], worlds.jax, key + "/params")


@pytest.mark.parametrize("name,shape,M,n", W.LM_UNEVEN)
def test_uneven_microbatch_steps_match_jax(worlds, name, shape, M, n):
    """Microbatches of n / M rows that the data ranks do not divide (fewer
    rows than ranks, or 12 over 8): each rank takes ceil(rows / ranks) of
    them, padded with masked rows, as GSPMD pads JAX's; the padded rows add
    nothing to the loss, its count or any gradient."""
    key = f"uneven/{name}/{shape}/{M}/{n}"
    for r in worlds.ranks:
        got = r[("uneven", name, shape, M, n)]
        _close(got["losses"], worlds.jax[key + "/losses"], key)
        _close_tree(got["params"], worlds.jax, key + "/params")


@pytest.mark.parametrize("name,shape,M,n,kw", W.LM_REFUSED)
def test_uneven_split_is_refused_where_jax_refuses(worlds, name, shape, M,
                                                   n, kw):
    """JAX's shard_map bodies (the capacity MoE, the explicit row-parallel
    matmul) refuse a microbatch the data ranks do not divide; the port
    refuses it alike, on every rank, with a ValueError."""
    want = worlds.refused[f"{name}/{shape}/{M}/{n}"]
    assert want is not None and want.startswith("ValueError: shard_map")
    assert "not evenly divisible" in want
    for r in worlds.ranks:
        got = r[("refused", name, shape, M, n)]
        assert got is not None and "not evenly divisible" in got, got


@pytest.mark.parametrize("cf,shape", W.LM_MOE)
def test_capacity_moe_matches_jax(worlds, cf, shape):
    """At 1.25 against JAX's same mesh (the two meshes' values differ: a
    per-rank microbatch or a global capacity would miss one); at 64
    (lossless) against JAX's dense oracle. Each capacity cut on these
    inputs keeps a gate at least 1e-4 (relative) above the first it drops:
    closer, float32 rounding alone decides which token an expert keeps
    (one input drawn before these had a cut 2e-7 apart, and flipped)."""
    key = f"moe/{cf}/{shape}" if cf < W.LM_CFGS["moe"].get(
        "n_experts") else "moe/oracle"
    for r in worlds.ranks:
        got = r[("moe", cf, shape)]
        assert got["margin"] > 1e-4, got["margin"]
        _close(got["loss"], worlds.jax[key + "/loss"], key)
        _close(got["logits"], worlds.jax[key + "/logits"], key)
        _close_tree(got["grads"], worlds.jax, key + "/grads")


def test_capacity_moe_is_another_function_per_mesh(worlds):
    losses = [float(worlds.jax[f"moe/1.25/{s}/loss"]) for s in
              ((2, 4), (8, 1))] + [float(worlds.jax["moe/oracle/loss"])]
    assert min(abs(a - b) for i, a in enumerate(losses)
               for b in losses[i + 1:]) > 100 * TOL, losses


def test_fsdp_gather_with_a_slicing_backward_misses(worlds):
    """The FSDP gather's consumer differs from data rank to data rank: a
    backward that keeps this rank's slice drops the other data rank's
    share of every FSDP-sharded weight's gradient."""
    key = "loss/gqa/(2, 4)"
    for r in worlds.ranks:
        got = r["trap_fsdp"]
        _close(got["loss"], worlds.jax[key + "/loss"], key)  # forward holds
        assert _worst(got["grads"], worlds.jax, key + "/grads") > 100 * TOL


def test_per_rank_microbatch_split_misses(worlds):
    """Microbatch m of each rank's own rows is another set of rows per
    microbatch: with uneven masks its counts, and so its steps, differ."""
    key = "train/gqa/(2, 4)/False"
    for r in worlds.ranks:
        got = r["trap_microbatch"]
        assert _worst(got["params"], worlds.jax, key + "/params") > \
            10 * TOL


@pytest.mark.parametrize("key", ["decode", "decode_all_axes"])
def test_plain_and_flash_decode_match_jax(worlds, key):
    """Eight plain steps, then flash decoding at index 8: the logits of
    every step (this rank's rows, the whole vocabulary) and this rank's
    block of the cache, written at the index by the rank that holds it."""
    for r in worlds.ranks:
        d, m = r["coords"]
        got = r[key]
        B = got["logits"][0].shape[0]
        rows = slice(d * B, (d + 1) * B) if key == "decode" else slice(None)
        for i, lg in enumerate(got["logits"]):
            _close(lg, worlds.jax[f"{key}/logits/{i}"][rows], f"{key} {i}")
        for k, v in got["cache"].items():
            S = v.shape[3]
            block = m if key == "decode" else d * 4 + m
            want = worlds.jax[f"{key}/cache/{k}"][:, :, rows,
                                                  block * S:(block + 1) * S]
            _close(v, want, f"{key} cache {k}")
        if (8 // S) == block:  # the index's block holds the new token
            assert np.abs(got["cache"]["k"][:, :, :, 8 % S]).sum() > 0


def test_prefill_cache_in_cache_specs_placement(worlds):
    """The heads config runs attention on this rank's heads; the cache
    leaves split by sequence over ``model``, the batch over ``data``."""
    for r in worlds.ranks:
        d, m = r["coords"]
        got = r["prefill"]
        B = got["logits"].shape[0]
        _close(got["logits"], worlds.jax["prefill/logits"][d * B:(d + 1) * B],
               "prefill logits")
        for k, v in got["cache"].items():
            S = v.shape[3]
            _close(v, worlds.jax[f"prefill/cache/{k}"][
                :, :, d * B:(d + 1) * B, m * S:(m + 1) * S], f"cache {k}")


# ---------------------------------------------------------------------------
# in the test process: specs and the config
# ---------------------------------------------------------------------------

def _norm(spec):
    """A spec as a tuple of None / axis / tuple of axes (JAX's and the
    port's normalise a one-axis tuple to the axis)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


MESH_SHAPES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]


@pytest.mark.parametrize("shape,names", MESH_SHAPES)
@pytest.mark.parametrize("arch", ["llama3-405b", "phi3-mini-3.8b",
                                  "llama3.2-1b", "granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"])
def test_param_and_cache_specs_match_jax(arch, shape, names):
    import jax

    from repro.configs import registry as jreg
    from repro.models import lm as jlm
    from repro_torch.configs import registry as treg
    from repro_torch.distrib.shardings import AbstractMesh
    from repro_torch.models import lm as tlm

    jmesh = jax.sharding.AbstractMesh(shape, names)
    tmesh = AbstractMesh(shape, names)
    jcfg, tcfg = jreg.get_arch(arch).FULL, treg.get_arch(arch).FULL
    want = jax.tree_util.tree_leaves_with_path(
        jlm.param_specs(jcfg, jmesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tlm.param_specs(tcfg, tmesh)
    assert len(want) == sum(len(v) if isinstance(v, dict) else 1
                            for v in got.values())
    for path, spec in want:
        node = got
        for k in path:
            node = node[k.key]
        assert _norm(node) == _norm(spec), (arch, path)
    for shard_seq in (True, False):
        jc = jlm.cache_specs(jcfg, jmesh, shard_seq=shard_seq)
        tc = tlm.cache_specs(tcfg, tmesh, shard_seq=shard_seq)
        assert {k: _norm(v) for k, v in tc.items()} == \
            {k: _norm(v) for k, v in jc.items()}


#: The port's own LMConfig fields, after JAX's, at their defaults.
PORT_ONLY = {"attention": "gqa", "kv_lora_rank": 0, "qk_nope_head_dim": 0,
             "qk_rope_head_dim": 0, "v_head_dim": 0, "router": "softmax",
             "routed_scaling_factor": 1.0,
             "first_k_dense": 0, "norm_eps": 1e-6, "moe_impl": "dense"}


def test_config_has_jax_sharded_fields_and_defaults():
    import dataclasses

    from repro.models.lm import LMConfig as JCfg
    from repro_torch.models.lm import LMConfig as TCfg

    jf = {f.name: f.default for f in dataclasses.fields(JCfg)}
    tf = {f.name: f.default for f in dataclasses.fields(TCfg)}
    # JAX's fields first, in its order; then the port's own (MLA, the
    # sigmoid router, leading dense layers, norm eps, the dispatched MoE),
    # whose defaults are JAX's model
    assert list(tf)[:len(jf)] == list(jf)
    assert {k: tf[k] for k in list(tf)[len(jf):]} == PORT_ONLY
    for k in ("capacity_factor", "explicit_row_parallel", "flash_decode",
              "decode_seq_axes"):
        assert tf[k] == jf[k], k


def test_place_and_gather_on_a_world_of_one():
    """A (1, 1) mesh on gloo: every block is the whole tensor; the placed
    forward is the single-device forward to the bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        cfg = W.lm_config("gqa")
        full = lm.init_params(cfg, device="cpu", seed=3)
        placed = lm.place_params(cfg, full, mesh)
        back = lm.gather_params(cfg, placed, mesh)
        for (n, a), (_, b) in zip(full.named_parameters(),
                                  back.named_parameters()):
            assert torch.equal(a, b), n
        tokens = torch.randint(0, cfg.vocab, (2, 8))
        with torch.no_grad():
            assert torch.equal(lm.forward(cfg, placed, tokens, mesh),
                               lm.forward(cfg, full, tokens))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_on_a_world_of_one_is_no_mesh_to_the_bit(dtype):
    """A (1, 1) mesh on gloo runs the single-device decode's operations on
    tensors laid out as its own (gathered weights and q contiguous, one
    softmax helper): three plain decode steps give its logits and cache to
    the bit in either type; flash decoding's first step is within 1e-5 in
    float32."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm

    kind = getattr(torch, dtype)
    cfg = dataclasses.replace(W.lm_config("gqa"), dtype=kind,
                              param_dtype=kind)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        full = lm.init_params(cfg, device="cpu", seed=5)
        placed = lm.place_params(cfg, full, mesh)
        gen = torch.Generator().manual_seed(5)
        caches = []
        for m in (None, mesh):
            cache = lm.init_cache(cfg, 2, 16, device="cpu", mesh=m)
            for k in cache:
                cache[k][:, :, :, :8] = torch.randn(
                    cache[k][:, :, :, :8].shape, generator=gen).to(kind)
            caches.append(cache)
        caches[1] = {k: v.clone() for k, v in caches[0].items()}
        tokens = torch.randint(0, cfg.vocab, (3, 2, 1), generator=gen)
        no_mesh = lm.make_decode_step(cfg)
        plain = lm.make_decode_step(cfg, mesh)
        for i in range(3):
            want, _ = no_mesh(full, caches[0], tokens[i], 8 + i)
            got, _ = plain(placed, caches[1], tokens[i], 8 + i)
            assert torch.equal(got, want), i
        for k in ("k", "v"):
            assert torch.equal(caches[1][k], caches[0][k]), k
        if dtype == "float32":
            flash = lm.make_decode_step(
                dataclasses.replace(cfg, flash_decode=True), mesh)
            want, _ = no_mesh(full, caches[0], tokens[0], 11)
            got, _ = flash(placed, caches[1], tokens[0], 11)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                       atol=TOL)
    finally:
        dist.destroy_process_group()


def test_row_parallel_partial_products_are_the_upcast_matmul():
    """``_MatmulF32`` (the partial products the row-parallel matmul sums
    in float32): on the CPU the upcast GEMM to the bit; its backward, the
    two gradient GEMMs in bfloat16, within one bfloat16 rounding of the
    upcast form's autograd (relative L2 1e-2)."""
    from repro_torch.models.lm import sharded

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=gen).to(torch.bfloat16)
    w = (torch.randn(64, 24, generator=gen) / 8).to(torch.bfloat16)
    x.requires_grad_(True)
    w.requires_grad_(True)
    got = sharded._MatmulF32.apply(x, w)
    want = x.float() @ w.float()
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    gy = torch.randn(got.shape, generator=gen).to(torch.bfloat16).float()
    for a, b in zip(torch.autograd.grad(got, (x, w), gy),
                    torch.autograd.grad(want, (x, w), gy)):
        assert a.dtype == b.dtype == torch.bfloat16
        rel = float(torch.linalg.vector_norm((a - b).float())
                    / torch.linalg.vector_norm(b.float()))
        assert rel < 1e-2, rel
