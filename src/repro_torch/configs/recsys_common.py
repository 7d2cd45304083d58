"""The recsys shapes and batch factories (port of ``SHAPES``,
``tabular_batch_factory`` and ``sequence_batch_factory`` of
``repro.configs.recsys_common``).

Shapes: train_batch (65536, training), serve_p99 (512, online),
serve_bulk (262144, offline scoring), retrieval_cand (1 query x 1M
candidates).

A factory gives a shape's batch as real tensors, drawn from a
``torch.Generator`` on its device; its ``specs(info, dp)`` gives what
JAX's factory gives, the global shapes and dtypes (as ``{key: (shape,
dtype)}``) and their sharding specs. :func:`build_recsys_cell` builds a
dry-run cell (``configs/common.py``) from them: the model's tables
row-sharded over ``model`` and its towers replicated, the batch over the
data axes, every tensor this rank's fake block.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import optim as optim_lib
from repro_torch.configs.common import (Cell, dp_axes, dp_size, fake_module,
                                        local_batch)
from repro_torch.distrib.shardings import P

SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

Factory = Callable[[dict, int, torch.Generator], Dict[str, torch.Tensor]]


def _ids(shape, vocab: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, vocab, shape, generator=gen, device=gen.device,
                         dtype=torch.int32)


def _labels(rows: int, gen: torch.Generator) -> torch.Tensor:
    return (torch.rand(rows, generator=gen, device=gen.device) < 0.5).float()


def build_recsys_cell(model, shape: str, mesh, *, batch_factory,
                      flops_per_example: float, retrieval_flops: float,
                      arch_name: str) -> Cell:
    """The cell of ``model`` (a recsys model built on ``meta``) at
    ``shape`` on ``mesh``: its tables cut to this rank's rows and every
    tensor made on the mesh's device (fake, under the caller's
    ``FakeTensorMode``). Training is one AdamW step
    (:meth:`RecsysModel.make_train_step` on the mesh); serving and
    retrieval one forward over this rank's rows."""
    info = SHAPES[shape]
    dp = dp_axes(mesh)
    device = mesh.device_type
    pspecs = model.param_specs(mesh)
    fake_module(model.place_(mesh), device)
    shapes, bspecs = batch_factory.specs(info, dp)
    batch = local_batch(mesh, shapes, bspecs, device)

    if info["kind"] == "train":
        step = model.make_train_step(optim_lib.adamw(1e-3), mesh)
        opt_state = step.init()
        ospecs = (optim_lib.ScaleByAdamState(count=P(), mu=pspecs,
                                             nu=pspecs), (), ())

        def train(model, opt_state, batch):
            return step(opt_state, batch)

        return Cell(
            arch=arch_name, shape=shape, kind="train", fn=train,
            args=(model, opt_state, batch),
            in_specs=(pspecs, ospecs, bspecs),
            out_specs=(pspecs, ospecs, P()),
            model_flops=3.0 * flops_per_example * info["batch"],
            donate=(0, 1),
            notes="tables row-sharded over 'model'; towers replicated",
        )

    out_spec = P(dp) if info["batch"] % dp_size(mesh) == 0 else P(None)
    if info["kind"] == "serve":
        return Cell(
            arch=arch_name, shape=shape, kind="serve",
            fn=lambda model, batch: model.serve(batch, mesh),
            args=(model, batch), in_specs=(pspecs, bspecs),
            out_specs=out_spec,
            model_flops=flops_per_example * info["batch"],
            notes="forward only",
        )

    return Cell(
        arch=arch_name, shape=shape, kind="retrieval",
        fn=lambda model, batch: model.retrieval_score(batch, mesh),
        args=(model, batch), in_specs=(pspecs, bspecs),
        out_specs=P(dp, None),
        model_flops=retrieval_flops,
        notes="single batched program over 1M candidates (no host loop)",
    )


def tabular_batch_factory(n_fields: int) -> Factory:
    """deepfm / autoint: ``factory(info, vocab, gen)`` -> (B, n_fields)
    int32 ``field_ids`` in [0, vocab) (+ float32 ``labels`` for training);
    retrieval expands the candidate rows into the field matrix (one
    batched forward)."""
    def factory(info, vocab, gen):
        if info["kind"] == "retrieval":
            return {"field_ids": _ids((info["n_candidates"], n_fields), vocab,
                                      gen)}
        B = info["batch"]
        batch = {"field_ids": _ids((B, n_fields), vocab, gen)}
        if info["kind"] == "train":
            batch["labels"] = _labels(B, gen)
        return batch

    def specs(info, dp):
        if info["kind"] == "retrieval":
            return ({"field_ids": ((info["n_candidates"], n_fields),
                                   torch.int32)},
                    {"field_ids": P(dp, None)})
        B = info["batch"]
        shapes = {"field_ids": ((B, n_fields), torch.int32)}
        bspecs = {"field_ids": P(dp, None)}
        if info["kind"] == "train":
            shapes["labels"] = ((B,), torch.float32)
            bspecs["labels"] = P(dp)
        return shapes, bspecs

    factory.specs = specs
    return factory


def sequence_batch_factory(history_len: int,
                           with_target: bool = True) -> Factory:
    """bst / mind: ``factory(info, vocab, gen)`` -> (B, history_len) int32
    ``history_ids`` + (B,) ``target_ids`` (+ ``labels`` for training);
    retrieval = 1 user x ``n_candidates`` ``candidate_ids``."""
    def factory(info, vocab, gen):
        if info["kind"] == "retrieval":
            return {"history_ids": _ids((1, history_len), vocab, gen),
                    "candidate_ids": _ids((info["n_candidates"],), vocab,
                                          gen)}
        B = info["batch"]
        batch = {"history_ids": _ids((B, history_len), vocab, gen)}
        if with_target:
            batch["target_ids"] = _ids((B,), vocab, gen)
        if info["kind"] == "train":
            batch["labels"] = _labels(B, gen)
        return batch

    def specs(info, dp):
        if info["kind"] == "retrieval":
            return ({"history_ids": ((1, history_len), torch.int32),
                     "candidate_ids": ((info["n_candidates"],),
                                       torch.int32)},
                    {"history_ids": P(None, None), "candidate_ids": P(dp)})
        B = info["batch"]
        shapes = {"history_ids": ((B, history_len), torch.int32)}
        bspecs = {"history_ids": P(dp, None)}
        if with_target:
            shapes["target_ids"] = ((B,), torch.int32)
            bspecs["target_ids"] = P(dp)
        if info["kind"] == "train":
            shapes["labels"] = ((B,), torch.float32)
            bspecs["labels"] = P(dp)
        return shapes, bspecs

    factory.specs = specs
    return factory
