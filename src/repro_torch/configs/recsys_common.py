"""The recsys shapes and batch factories (port of ``SHAPES``,
``tabular_batch_factory`` and ``sequence_batch_factory`` of
``repro.configs.recsys_common``).

Shapes: train_batch (65536, training), serve_p99 (512, online),
serve_bulk (262144, offline scoring), retrieval_cand (1 query x 1M
candidates).

A factory gives a shape's batch as real tensors, drawn from a
``torch.Generator`` on its device, where JAX's gives
``ShapeDtypeStruct``s and sharding specs: the same keys, shapes and
dtypes. ``build_recsys_cell`` and ``configs/common.py``'s ``Cell``, which
are sharded ahead-of-time constructs, wait for ``launch/dryrun.py``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

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

    return factory
