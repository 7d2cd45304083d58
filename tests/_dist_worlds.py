"""Spawned gloo worlds for the port's distributed tests.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``'s
spawn context, one rank each, every one running ``TASKS[task](rank,
world, **kwargs)`` with ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE`` set (the port's meshes read them), and returns each rank's
result (pickled through a file). The join has a deadline: a rank still
running after ``timeout`` seconds is killed and the call fails, and every
process group has the mesh module's timeout, so a rank that diverges fails
fast instead of hanging the suite. A failing rank's traceback is raised.

This module imports only numpy and torch at the top (the children import
it, and nothing of JAX); the tasks import the port inside.
"""
from __future__ import annotations

import os
import pickle
import signal
import socket
import tempfile
import time
import traceback

import numpy as np


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(task, rank, world, port, out_dir, kwargs):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        result = TASKS[task](rank, world, **kwargs)
        with open(path + ".pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(task: str, world: int, timeout: float = 150.0, **kwargs):
    """Run ``task`` on a gloo world of ``world`` spawned ranks; returns
    the list of their results, rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        port = _free_port()
        procs = [ctx.Process(target=_child, args=(task, r, world, port,
                                                  out_dir, kwargs))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)
                p.join()
        errors = []
        for r in range(world):
            err = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors or hung or any(p.exitcode for p in procs):
            raise AssertionError(
                f"world {task!r} of {world}: hung ranks {hung}, exit codes "
                f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _np(t):
    return t.detach().cpu().numpy().copy()


def _named(model, fn=_np):
    """``{JAX path joined by '.': fn(parameter)}`` of ``model``."""
    from repro_torch.convert import param_path

    return {".".join(param_path(n)): fn(p)
            for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# the collectives, the meshes and GraphSAGE: a (2, 4) world of 8
# ---------------------------------------------------------------------------

def task_distrib(rank, world, lookup, compress, sage):
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce as nn_all_reduce

    from repro_torch import convert
    from repro_torch.distrib import (masked_psum_lookup,
                                     sharded_embedding_lookup)
    from repro_torch.distrib.collectives import (axes_group,
                                                 moe_all_to_all_dispatch)
    from repro_torch.distrib.compression import (CompressedAllReduce,
                                                 compressed_psum)
    from repro_torch.distrib.shardings import (P, NamedSharding,
                                               clax_param_rule,
                                               data_parallel_index,
                                               make_shardings)
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import gnn

    mesh = meshes.make_mesh((2, 4), ("data", "model"), device="cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    data_group = mesh.get_group("data")
    out = {"coords": (d, m), "data_index": data_parallel_index(mesh)}

    # --- the lookups -------------------------------------------------------
    table = torch.from_numpy(lookup["table"])
    ids = torch.from_numpy(lookup["ids"])
    rows, b = table.shape[0] // 4, ids.shape[0] // 2
    ids_local = ids[d * b:(d + 1) * b]

    def grad_of(fn):
        t = table[m * rows:(m + 1) * rows].clone().requires_grad_(True)
        emb = fn(t)
        (emb ** 2).sum().backward()
        g = t.grad.clone()
        dist.all_reduce(g, group=data_group)  # the global batch's gradient
        return emb, g

    lookup_fn = masked_psum_lookup(mesh, batch_dims=2)
    emb, g = grad_of(lambda t: lookup_fn(t, ids_local))
    out["lookup"], out["lookup_grad"] = _np(emb), _np(g)

    def trap(t):  # the all-reduce whose backward sums over 'model'
        local = ids_local - m * rows
        owned = (local >= 0) & (local < rows)
        e = torch.where(owned[..., None], t[local.clamp(0, rows - 1)], 0.0)
        return nn_all_reduce(e, group=mesh.get_group("model"))

    _, g = grad_of(trap)
    out["trap_grad"] = _np(g)
    emb, g = grad_of(lambda t: sharded_embedding_lookup(t, ids_local, mesh))
    out["sharded"], out["sharded_grad"] = _np(emb), _np(g)
    try:
        lookup_fn(table[:rows], ids_local[:, 0])
        out["bad_batch_dims"] = None
    except ValueError as e:
        out["bad_batch_dims"] = str(e)
    try:
        moe_all_to_all_dispatch(mesh, 4, 8)
    except NotImplementedError as e:
        out["moe"] = str(e)

    # --- compressed_psum over 'data' -----------------------------------------
    grads = torch.from_numpy(compress["grads"])
    half = grads.shape[0] // 2
    mine = grads[d * half:(d + 1) * half]
    reduced, state = compressed_psum({"w": [mine]}, data_group,
                                     CompressedAllReduce.init({"w": [mine]}))
    out["compressed"] = _np(reduced["w"][0])
    out["compressed_error"] = _np(state.error["w"][0])

    # --- meshes and specs ----------------------------------------------------
    smoke = meshes.make_smoke_mesh(8, device="cpu")
    dp = meshes.make_data_parallel_mesh(device="cpu")
    out["smoke_shape"] = tuple(smoke.shape)
    out["dp_shape"] = tuple(dp.shape)
    out["dp_names"] = tuple(dp.mesh_dim_names)
    for name, fn in (("production", lambda: meshes.make_production_mesh(
                          device="cpu")),
                     ("production_pods", lambda: meshes.make_production_mesh(
                         True, device="cpu")),
                     ("wrong_shape", lambda: meshes.make_mesh(
                         (3, 3), ("data", "model"), device="cpu"))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    full = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    tree = {"table": torch.zeros(1 << 16, 1), "small": torch.zeros(10),
            "stacked": torch.zeros(3, 1 << 16)}
    specs = make_shardings(mesh, tree, clax_param_rule(mesh))
    out["specs"] = {k: tuple(v.spec) for k, v in specs.items()}
    out["replica_specs"] = {
        k: tuple(v.spec) for k, v in make_shardings(
            mesh, tree, clax_param_rule(mesh, leading_axes=1)).items()}
    out["table_block"] = NamedSharding(mesh, P("model", None)).local(full)
    out["batch_block"] = NamedSharding(mesh, P(("data", "model"))).local(
        full)
    cube = meshes.make_mesh((2, 2, 2), ("pod", "data", "model"),
                            device="cpu")
    out["pod_data_ranks"] = dist.get_process_group_ranks(
        axes_group(cube, ("pod", "data")))
    out["cube_data_index"] = data_parallel_index(cube)

    # --- GraphSAGE's two sharded forms ---------------------------------------
    cfg0 = gnn.SAGEConfig(n_layers=2, d_in=12, d_hidden=16, n_classes=4)
    sage = {**sage, "graph_797": {**sage["graph"],
                                  "src": sage["graph"]["src"][:797],
                                  "dst": sage["graph"]["dst"][:797]}}
    for form, key, cfg in (
            ("sharded", "graph", cfg0),
            ("sharded_797", "graph_797", cfg0),
            ("dst_partitioned", "graph_dst",
             dataclasses.replace(cfg0, partitioned_edges=True))):
        params = gnn.init_params(cfg, device="cpu")
        convert.load_jax_params(params, sage["params"])
        graph = {k: torch.from_numpy(v) for k, v in sage[key].items()}
        logits = gnn.full_graph_forward(cfg, params, graph, mesh)
        loss = gnn.node_classification_loss(logits, graph["labels"])
        loss.backward()
        out[f"sage_{form}"] = _np(logits)
        out[f"sage_{form}_loss"] = float(loss)
        out[f"sage_{form}_grads"] = {n: _np(p.grad) for n, p in
                                     params.named_parameters()}
    return out


# ---------------------------------------------------------------------------
# the Trainer on a mesh: a world of 8
# ---------------------------------------------------------------------------

def pbm_data(every_row=False):
    """JAX's data-parallel script's log; with ``every_row`` 10 queries of
    6 documents, each session showing all of its query's, so that each
    batch of 256 touches every one of the 60 table rows."""
    from repro_torch.data import (SyntheticConfig, generate_click_log,
                                  split_sessions)

    cfg = SyntheticConfig(n_sessions=2200, n_queries=10 if every_row else 25,
                          docs_per_query=6 if every_row else 12, positions=6,
                          behavior="pbm", seed=13)
    data, _ = generate_click_log(cfg)
    return cfg, split_sessions(data, (0.8, 0.1, 0.1), seed=0)


def pbm_run(mesh, train, val, cfg, epochs=2, weight=None, poison=None,
            sparse=False, ckpt=None, resume=False, preempt_at=None,
            handle_preemption=False, **trainer_kw):
    """The JAX data-parallel script's PBM run (adamw 0.05, batch 256, seed
    5, chunks of 4; val batch 128, drop_last=False) on ``mesh`` (None: a
    single process): (history, {name: array}, the trainer). ``weight``
    replaces the engine's loss weight (the 1/dp control); ``sparse``
    takes lazy AdamW on the table; ``preempt_at`` SIGTERMs this process
    when its loader makes that batch (every rank of a world passes
    ``handle_preemption``)."""
    import signal as sig

    from repro_torch import optim
    from repro_torch.core import PositionBasedModel
    from repro_torch.data import ClickLogLoader
    from repro_torch.testing import KillSwitch
    from repro_torch.train import Trainer, engine as engine_mod

    model = PositionBasedModel(query_doc_pairs=cfg.n_query_doc_pairs,
                               positions=cfg.positions, init_prob=0.2,
                               device="cpu")
    kw = dict(sparse_tables=True, sparse_table_kwargs=dict(
        lr=0.05, weight_decay=1e-4)) if sparse else {}
    trainer = Trainer(optim.adamw(0.05), epochs=epochs, patience=100,
                      log_fn=lambda *_: None, chunk_batches=4, mesh=mesh,
                      device="cpu", checkpoint_dir=ckpt,
                      handle_preemption=handle_preemption, **kw,
                      **trainer_kw)
    loader = ClickLogLoader(train, batch_size=256, seed=5)
    if poison is not None:
        loader.data["clicks"] = loader.data["clicks"].copy()
        loader.data["clicks"][poison] = np.nan
    if preempt_at is not None:
        loader = KillSwitch(loader, preempt_at, sig=sig.SIGTERM)
    vloader = ClickLogLoader(val, batch_size=128, shuffle=False,
                             drop_last=False)
    saved = engine_mod.TrainEngine._loss_weight
    if weight is not None:
        engine_mod.TrainEngine._loss_weight = lambda self, batch: weight
    try:
        history = trainer.train(model, loader, vloader, resume=resume)
    finally:
        engine_mod.TrainEngine._loss_weight = saved
    return history, _named(model), trainer


def uneven(train, seed=3):
    """``train`` with each session's mask cut to a random length (1 to 6
    items): the ranks' blocks of a batch hold different counts."""
    rng = np.random.default_rng(seed)
    keep = rng.integers(1, 7, train["mask"].shape[0])
    out = dict(train)
    out["mask"] = train["mask"] & (np.arange(train["mask"].shape[1])[None]
                                   < keep[:, None])
    return out


def dbn_model(device="cpu"):
    from repro_torch.core import (Compression, DynamicBayesianNetwork,
                                  EmbeddingParameterConfig)

    cfg = EmbeddingParameterConfig(parameters=655_360,
                                   compression=Compression.HASH,
                                   compression_ratio=10.0,
                                   baseline_correction=True, init_logit=-2.0)
    return DynamicBayesianNetwork(positions=6, attraction=cfg,
                                  satisfaction=cfg, device=device)


def dbn_data():
    from repro_torch.data import (SyntheticConfig, generate_click_log,
                                  split_sessions)

    cfg = SyntheticConfig(n_sessions=1600, n_queries=25, docs_per_query=12,
                          positions=6, behavior="dbn", seed=7)
    data, _ = generate_click_log(cfg)
    return split_sessions(data, (0.8, 0.1, 0.1), seed=0)


#: lazy AdamW on the DBN's tables, mirroring ``optim.adamw(0.01)``
DBN_SPARSE = dict(sparse_tables=True,
                  sparse_table_kwargs=dict(lr=0.01, weight_decay=1e-4))


def dbn_run(mesh, train, val, epochs, ckpt=None, resume=False,
            sparse=False):
    """The row-sharded DBN: adamw 0.01, batch 256, chunks of 4 (with
    ``sparse``, lazy AdamW on the tables)."""
    from repro_torch import optim
    from repro_torch.data import ClickLogLoader
    from repro_torch.train import Trainer

    model = dbn_model()
    trainer = Trainer(optim.adamw(0.01), epochs=epochs, patience=100,
                      log_fn=lambda *_: None, chunk_batches=4, mesh=mesh,
                      device="cpu", checkpoint_dir=ckpt,
                      **(DBN_SPARSE if sparse else {}))
    history = trainer.train(
        model, ClickLogLoader(train, batch_size=256, seed=5),
        ClickLogLoader(val, batch_size=128, shuffle=False, drop_last=False),
        resume=resume)
    return history, _named(model, lambda p: p)


def dbn_chunk(train, index=0, count=1, n=4, batch=256, which=None):
    """The first ``n`` batches of ``train`` in order (or the batches
    ``which``), stacked ``(n, B, K)``, rank ``index``'s block of rows of
    each among ``count``."""
    import torch

    rows = batch // count
    which = range(n) if which is None else which
    return {k: torch.from_numpy(np.stack([
        v[i * batch + index * rows:i * batch + (index + 1) * rows]
        for i in which])) for k, v in train.items()
        if k in ("positions", "query_doc_ids", "clicks", "mask")}


def dbn_engine_step(mesh, train, index=0, count=1):
    """One chunk of 4 through ``TrainEngine(telemetry=True,
    nonfinite_guard=True)`` on the row-sharded DBN: the per-step series."""
    from repro_torch import optim
    from repro_torch.train import TrainEngine

    engine = TrainEngine(dbn_model(), optim.adamw(0.01), chunk_batches=4,
                         mesh=mesh, telemetry=True, nonfinite_guard=True)
    state = engine.init_opt_state()
    _, out = engine.step(state, dbn_chunk(train, index, count))
    return {k: _np(v) for k, v in out.items()}


def dbn_sparse_chunk(mesh, train, index=0, count=1, which=(0, 1, 2, 3),
                     poison=None):
    """One chunk of the DBN with sparse tables through ``TrainEngine(
    telemetry=True, nonfinite_guard=True)``: the per-step series and the
    parameters (row shards gathered over ``model``). ``poison=(m, step)``
    makes the attraction table's gradient NaN on model rank ``m`` alone at
    that step: rows only that rank owns."""
    from repro_torch import optim
    from repro_torch.train import TrainEngine

    engine = TrainEngine(dbn_model(), optim.adamw(0.01),
                         chunk_batches=len(which), mesh=mesh, telemetry=True,
                         nonfinite_guard=True, **DBN_SPARSE)
    if poison is not None and mesh.get_local_rank("model") == poison[0]:
        calls = []

        def hook(grad):
            calls.append(None)
            return grad * float("nan") if len(calls) == poison[1] + 1 \
                else grad

        engine.sparse_parts["attraction/table"].table.register_hook(hook)
    state = engine.init_opt_state()
    _, out = engine.step(state, dbn_chunk(train, index, count, which=which))
    params = engine.gathered({n: p for n, p in zip(engine.names,
                                                   engine.params)})
    return {k: _np(v) for k, v in out.items()}, \
        {n: _np(p) for n, p in params.items()}


# ---------------------------------------------------------------------------
# sparse tables on meshes whose 'model' axis is larger than one: a world of 8
# ---------------------------------------------------------------------------

def task_sparse8(rank, world, ckpt):
    import torch.distributed as dist

    from repro_torch.distrib.collectives import gather_rows
    from repro_torch.launch import mesh as meshes

    train, val, _ = dbn_data()
    out = {}

    def full(params, mesh):  # row shards gathered, the rest as they are
        group, rows = mesh.get_group("model"), params[
            "attraction.table"].shape[0]
        return {n: _np(gather_rows(p, group) if p.dim() == 2 and
                       p.shape[0] == rows else p) for n, p in params.items()}

    for shape in ((2, 4), (8, 1), (1, 8)):
        mesh = meshes.make_mesh(shape, ("data", "model"), device="cpu")
        history, params = dbn_run(mesh, train, val, epochs=2, sparse=True)
        out[shape] = (history, full(params, mesh),
                      int(params["attraction.table"].shape[0]))
    mesh = meshes.make_mesh((2, 4), ("data", "model"), device="cpu")
    d = mesh.get_local_rank("data")
    out["telemetry"] = dbn_sparse_chunk(mesh, train, d, 2)
    out["poisoned"] = dbn_sparse_chunk(mesh, train, d, 2, poison=(1, 1))
    # elastic: epoch 1 on (2, 4) with a checkpoint, epoch 2 restored onto
    # (1, 8) (the test process restores it onto one process)
    dbn_run(mesh, train, val, epochs=1, ckpt=ckpt, sparse=True)
    dist.barrier()  # rank 0 has written the checkpoint
    wide = meshes.make_smoke_mesh(8, device="cpu")
    history, params = dbn_run(wide, train, val, epochs=2, ckpt=ckpt,
                              resume=True, sparse=True)
    out["elastic"] = (history, full(params, wide))
    return out


def task_train8(rank, world, ckpt):
    import torch
    import torch.distributed as dist

    from repro_torch.data import ClickLogLoader
    from repro_torch.distrib.collectives import gather_rows
    from repro_torch.launch import mesh as meshes

    torch.manual_seed(0)
    dp = meshes.make_data_parallel_mesh(device="cpu")
    out = {}
    cfg, (train, val, _) = pbm_data()
    out["pbm"] = pbm_run(dp, train, val, cfg)[:2]
    for name, loader in (
            ("indivisible", ClickLogLoader(train, batch_size=250, seed=5)),
            ("drop_last", ClickLogLoader(train, batch_size=256, seed=5,
                                         drop_last=False))):
        from repro_torch import optim
        from repro_torch.core import PositionBasedModel
        from repro_torch.train import Trainer

        model = PositionBasedModel(query_doc_pairs=cfg.n_query_doc_pairs,
                                   positions=cfg.positions, device="cpu")
        trainer = Trainer(optim.adamw(0.05), epochs=1, chunk_batches=4,
                          log_fn=lambda *_: None, mesh=dp, device="cpu")
        try:
            trainer.train(model, loader, None)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    cut = uneven(train)
    out["uneven"] = pbm_run(dp, cut, val, cfg, epochs=1)[:2]
    out["uneven_1_over_dp"] = pbm_run(
        dp, cut, val, cfg, epochs=1, weight=torch.tensor(1.0 / world))[:2]
    out["nan"] = pbm_run(dp, train, val, cfg, epochs=1, poison=[77],
                         nonfinite_guard=True)[:2]
    scfg, (strain, sval, _) = pbm_data(every_row=True)
    out["sparse"] = pbm_run(dp, strain, sval, scfg, epochs=1,
                            sparse=True)[:2]
    # the DBN whose 65,536-row tables the rule row-shards over 'model'
    mesh = meshes.make_mesh((2, 4), ("data", "model"), device="cpu")
    dtrain, dval, _ = dbn_data()
    history, params = dbn_run(mesh, dtrain, dval, epochs=2)
    out["dbn_telemetry"] = dbn_engine_step(mesh, dtrain,
                                           mesh.get_local_rank("data"), 2)
    group = mesh.get_group("model")
    out["dbn_local_rows"] = int(params["attraction.table"].shape[0])

    def full(p, rows):  # a row shard gathered, anything else as it is
        return _np(gather_rows(p, group) if p.dim() == 2 and
                   p.shape[0] == rows else p)

    out["dbn"] = (history, {n: full(p, (1 << 16) // 4)
                            for n, p in params.items()})
    # elastic: epoch 1 on (2, 4) with a checkpoint, epoch 2 restored onto
    # (1, 8), each rank cutting the full tables to its rows
    dbn_run(mesh, dtrain, dval, epochs=1, ckpt=ckpt)
    dist.barrier()  # rank 0 has written the checkpoint
    wide = meshes.make_smoke_mesh(8, device="cpu")
    history, params = dbn_run(wide, dtrain, dval, epochs=2, ckpt=ckpt,
                              resume=True)
    group = wide.get_group("model")
    out["dbn_elastic"] = (history, {n: full(p, (1 << 16) // 8)
                                    for n, p in params.items()})
    return out


# ---------------------------------------------------------------------------
# checkpoints and preemption: a world of 2
# ---------------------------------------------------------------------------

def task_train2(rank, world, ckpt, ckpt_preempt):
    from repro_torch.launch import mesh as meshes

    dp = meshes.make_data_parallel_mesh(device="cpu")
    cfg, (train, val, _) = pbm_data()
    out = {}
    history, params, _ = pbm_run(dp, train, val, cfg, epochs=1, ckpt=ckpt)
    out["epoch1"] = (history, params)
    # rank 1 alone is signalled, when its loader makes batch 9
    history, params, trainer = pbm_run(
        dp, train, val, cfg, epochs=2, ckpt=ckpt_preempt,
        preempt_at=9 if rank == 1 else None, handle_preemption=True)
    out["preempt"] = {"history": history,
                      "global_step": trainer._final_state.global_step,
                      "epoch": trainer._final_state.epoch}
    return out


# ---------------------------------------------------------------------------
# the LM family's sharded forms: a world of 8
# ---------------------------------------------------------------------------

#: The float32 LM configs of the mesh tests (``LMConfig`` keywords): JAX's
#: own test config (``tests/test_archs.py``: 2 KV heads of 16, which 4 or 8
#: model ranks split mid-head), one whose heads every model size here
#: divides (and whose vocabulary of 61 pads to 64), and JAX's MoE oracle
#: config (8 experts, top 2).
LM_CFGS = {
    "gqa": dict(name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=64, head_dim=16, attn_chunk=8, max_seq=16),
    "heads": dict(name="h", n_layers=2, d_model=64, n_heads=16,
                  n_kv_heads=8, d_ff=128, vocab=61, head_dim=8,
                  attn_chunk=8, max_seq=16),
    "moe": dict(name="e", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                d_ff=64, vocab=64, head_dim=16, moe=True, n_experts=8,
                top_k=2, d_ff_moe=32, moe_layer_step=1, attn_chunk=8),
}
LM_MESHES = ((2, 4), (8, 1), (1, 8))
#: (config, mesh, explicit_row_parallel) of the two microbatched steps
LM_TRAIN = [("gqa", m, False) for m in LM_MESHES] + [
    ("gqa", (2, 4), True), ("heads", (2, 4), False)]
#: the MoE's capacity factors and meshes: JAX's default on two meshes that
#: give two functions, and a lossless one against the dense oracle
LM_MOE = [(1.25, (2, 4)), (1.25, (8, 1)), (64.0, (2, 4)), (64.0, (1, 8))]
LM_LR, LM_EPS = 1e-3, 1e-2
#: (config, mesh, microbatches, global rows) of two microbatched steps
#: whose microbatches the data ranks do not divide: 4 rows over 8, 12 over
#: 8, and 1 over 2 with ``model`` of 4 (its sums and the vocabulary-parallel
#: loss with a padded rank)
LM_UNEVEN = [("gqa", (8, 1), 4, 16), ("gqa", (8, 1), 2, 24),
             ("gqa", (2, 4), 16, 16), ("heads", (2, 4), 16, 16)]
#: (config, mesh, microbatches, global rows, LMConfig keywords) of uneven
#: splits that JAX's shard_map bodies refuse: the capacity MoE and the
#: explicit row-parallel matmul
LM_REFUSED = [("moe", (8, 1), 2, 24, {}),
              ("gqa", (8, 1), 2, 24, {"explicit_row_parallel": True})]


def lm_config(name, **kw):
    import torch

    from repro_torch.models.lm import LMConfig

    return LMConfig(**{**LM_CFGS[name], **kw}, dtype=torch.float32,
                    param_dtype=torch.float32)


class _SlicingGather:
    """The FSDP gather with :class:`AllGatherRows`' slicing backward (the
    trap: each data rank's gradient of its own rows only)."""

    @staticmethod
    def apply(x, group, dim):
        from repro_torch.distrib.collectives import AllGatherRows

        return AllGatherRows.apply(x.movedim(dim, 0), group).movedim(0, dim)


def _per_rank_microbatches(lay, batch, M):
    """The trap: microbatch m as the m-th block of this rank's rows."""
    b = next(iter(batch.values())).shape[0] // M
    return [{k: v[m * b:(m + 1) * b] for k, v in batch.items()}
            for m in range(M)]


def task_lm8(rank, world, trees, batch, dec, batch24):
    import dataclasses

    import torch

    from repro_torch import convert, optim
    from repro_torch.distrib.collectives import gather_rows
    from repro_torch.distrib.shardings import DATA_AXES, NamedSharding, P
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import lm
    from repro_torch.models.lm import sharded

    def placed(cfg, name, mesh):
        full = lm.init_params(cfg, device="cpu")
        convert.load_jax_params(full, trees[name])
        return full if mesh is None else lm.place_params(cfg, full, mesh)

    def rows(mesh, arrays, dp=None):
        dp = DATA_AXES(mesh) if dp is None else dp
        return {k: torch.from_numpy(NamedSharding(mesh, P(dp)).local(v)
                                    .copy()) for k, v in arrays.items()}

    def full(cfg, mesh, tensors):  # a tree of shards -> {name: array}
        tree = sharded._with_params(cfg, dict(tensors))
        return {n: _np(p) for n, p in lm.gather_params(cfg, tree, mesh)
                .named_parameters()}

    def loss_grads(cfg, name, mesh):
        params = placed(cfg, name, mesh)
        b = rows(mesh, batch)
        logits = lm.forward(cfg, params, b["tokens"], mesh)
        if logits.shape[-1] != cfg.padded_vocab:
            logits = gather_rows(logits, mesh.get_group("model"), 2)
        logits = gather_rows(logits, mesh.get_group("data"), 0)
        loss = lm.lm_loss(cfg, params, b, mesh)
        names = [n for n, _ in params.named_parameters()]
        grads = torch.autograd.grad(loss, list(params.parameters()))
        return {"logits": _np(logits), "loss": float(loss.detach()),
                "grads": full(cfg, mesh, zip(names, grads)),
                "contiguous": all(g.is_contiguous() for g in grads)}

    def train(cfg, name, mesh, microbatches=2, arrays=batch):
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
        params = placed(cfg, name, mesh)
        opt = optim.adamw(LM_LR, eps=LM_EPS)
        state = opt.init(list(params.parameters()))
        step = lm.make_train_step(cfg, opt, mesh)
        losses = []
        for _ in range(2):
            params, state, loss = step(params, state, rows(mesh, arrays))
            losses.append(float(loss))
        return {"losses": losses, "params": full(
            cfg, mesh, params.named_parameters())}

    out = {}
    meshes_ = {s: meshes.make_mesh(s, ("data", "model"), device="cpu")
               for s in LM_MESHES}
    for name in ("gqa", "heads"):
        for shape, mesh in meshes_.items():
            out[("loss", name, shape)] = loss_grads(lm_config(name), name,
                                                    mesh)
    for name, shape, erp in LM_TRAIN:
        out[("train", name, shape, erp)] = train(
            lm_config(name, explicit_row_parallel=erp), name,
            meshes_[shape])
    arrays = {16: batch, 24: batch24}
    for name, shape, M, n in LM_UNEVEN:
        out[("uneven", name, shape, M, n)] = train(
            lm_config(name), name, meshes_[shape], M, arrays[n])
    for name, shape, M, n, kw in LM_REFUSED:
        try:
            train(lm_config(name, **kw), name, meshes_[shape], M, arrays[n])
            out[("refused", name, shape, M, n)] = None
        except ValueError as e:
            out[("refused", name, shape, M, n)] = str(e)
    # each capacity cut's margin: the relative gap between the last gate an
    # expert keeps and the first it drops (a near-tie is decided by
    # float32 rounding alone, in either package)
    top_k, margins = sharded._top_k, []

    def recorded(x, k):
        if x.dim() == 1 and k < x.shape[0]:
            kept, dropped = torch.sort(x.detach(), descending=True).values[
                k - 1:k + 1].tolist()
            if dropped > 0 and kept != dropped:
                margins.append((kept - dropped) / kept)
        return top_k(x, k)

    sharded._top_k = recorded
    try:
        for cf, shape in LM_MOE:
            margins.clear()
            out[("moe", cf, shape)] = loss_grads(
                lm_config("moe", capacity_factor=cf), "moe", meshes_[shape])
            out[("moe", cf, shape)]["margin"] = min(margins, default=1.0)
    finally:
        sharded._top_k = top_k
    mesh = meshes_[(2, 4)]
    # the two traps, each on the wrong form
    saved = sharded.AllGatherReduceScatter
    sharded.AllGatherReduceScatter = _SlicingGather
    try:
        out["trap_fsdp"] = loss_grads(lm_config("gqa"), "gqa", mesh)
    finally:
        sharded.AllGatherReduceScatter = saved
    saved = sharded._microbatches
    sharded._microbatches = _per_rank_microbatches
    try:
        out["trap_microbatch"] = train(lm_config("gqa"), "gqa", mesh)
    finally:
        sharded._microbatches = saved
    # decode: 8 plain steps fill the seq-split cache, one flash step; the
    # same with the sequence over every axis and the batch whole
    for key, seq_axes, dp in (("decode", ("model",), None),
                              ("decode_all_axes", ("data", "model"), ())):
        cfg = lm_config("gqa", decode_seq_axes=seq_axes)
        params = placed(cfg, "gqa", mesh)
        toks = rows(mesh, {"t": dec["tokens"], "n": dec["next"]}, dp)
        cache = lm.init_cache(cfg, dec["tokens"].shape[0], cfg.max_seq,
                              device="cpu", mesh=mesh, dp_axes=dp)
        plain = lm.make_decode_step(cfg, mesh, dp_axes=dp)
        flash = lm.make_decode_step(
            dataclasses.replace(cfg, flash_decode=True), mesh, dp_axes=dp)
        logits = []
        for i in range(8):
            lg, cache = plain(params, cache, toks["t"][:, i:i + 1], i)
            logits.append(_np(lg))
        lg, cache = flash(params, cache, toks["n"], 8)
        logits.append(_np(lg))
        out[key] = {"logits": logits,
                    "cache": {k: _np(v) for k, v in cache.items()}}
    cfg = lm_config("heads")
    logits, cache = lm.make_prefill_step(cfg, mesh)(
        placed(cfg, "heads", mesh), rows(mesh, dec)["tokens"])
    out["prefill"] = {"logits": _np(logits),
                      "cache": {k: _np(v) for k, v in cache.items()}}
    out["coords"] = (mesh.get_local_rank("data"),
                     mesh.get_local_rank("model"))
    return out


# ---------------------------------------------------------------------------
# the recsys models on a mesh: worlds of 4 as (2, 2) and (1, 4)
# ---------------------------------------------------------------------------

def task_recsys4(rank, world, shape, cases, lr):
    """Each case's reduced recsys model on a ``shape`` gloo mesh: its JAX
    parameters loaded, its tables cut to this rank's rows (``place_``),
    one AdamW step per batch over this rank's rows of it, and the
    retrieval scores of this rank's candidates. Returns, per case, the
    rank's coordinates, the losses, its parameter blocks and scores."""
    import dataclasses
    import importlib

    import torch

    from repro_torch import optim
    from repro_torch.convert import load_jax_params
    from repro_torch.launch import mesh as meshes

    mesh = meshes.make_mesh(shape, ("data", "model"), device="cpu")
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    dp = shape[0]
    out = {}
    for name, case in cases.items():
        conf = importlib.import_module(f"repro_torch.configs.{case['arch']}")
        cfg = dataclasses.replace(conf.reduced(), **case["overrides"])
        model = conf.make_model(device="cpu", cfg=cfg)
        load_jax_params(model, case["params"])
        model.place_(mesh)
        step = model.make_train_step(optim.adamw(lr), mesh)
        state = step.init()
        losses = []
        for batch in case["batches"]:
            rows = next(iter(batch.values())).shape[0] // dp
            local = {k: torch.from_numpy(v[d * rows:(d + 1) * rows])
                     for k, v in batch.items()}
            state, loss = step(state, local)
            losses.append(float(loss))
        scores = None
        if case.get("retrieval") is not None:
            r = case["retrieval"]
            key = "candidate_ids" if "candidate_ids" in r else "field_ids"
            rows = r[key].shape[0] // dp
            local = {k: torch.from_numpy(v[d * rows:(d + 1) * rows]
                                         if k == key else v)
                     for k, v in r.items()}
            with torch.no_grad():
                scores = _np(model.retrieval_score(local, mesh))
        out[name] = {"coords": (d, m), "losses": losses,
                     "params": _named(model), "scores": scores}
    return out


TASKS = {"distrib": task_distrib, "train8": task_train8,
         "train2": task_train2, "sparse8": task_sparse8,
         "lm8": task_lm8, "recsys4": task_recsys4}
