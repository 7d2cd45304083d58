"""The paper's own workload: CLAX click models at Baidu-ULTR scale.

Port of the model builder of ``repro.configs.clax_baidu`` (``_make_model``):
2^31 query-document ids hashed 10x down, with baseline correction, giving a
214,748,672-row float32 logit table (0.86 GB) per hashed variable. UBM, the
JAX package's default, has one such attraction table beside its (K, K)
examination table; the DBN has separate attraction and satisfaction tables
of that size; DCTR, which the port trains at the same width to drive the
``session_nll`` kernel, has the attraction table alone.

:func:`make_two_tower` builds the paper's Listing-4 pair
(``examples/two_tower.py``): a PBM whose attraction is a DeepCrossV2 tower
over the query-document features, and the naive DCTR with the same tower.

``SHAPES`` are JAX's two cells of this config: a training batch of 65,536
sessions and a bulk serving batch of 262,144; :func:`serve_bulk` runs the
latter through ``predict_clicks``. :func:`_param_specs` is JAX's sharding
of the config: tables of 1,000,000 rows or more row-sharded over
``model``, everything else replicated.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import (Compression, DeepCrossParameterConfig,
                              DocumentCTR, DynamicBayesianNetwork,
                              EmbeddingParameterConfig, PositionBasedModel,
                              UserBrowsingModel)

POSITIONS = 10
TRAIN_BATCH = 65536
TOWER_FEATURES = 16

SHAPES = {
    "train_batch": dict(batch=TRAIN_BATCH, kind="train"),
    "serve_bulk": dict(batch=262144, kind="serve"),
}


def make_model(kind: str = "ubm", device="cuda"):
    """The paper-width UBM (``kind="ubm"``), DBN or DCTR."""
    cfg = EmbeddingParameterConfig(
        parameters=1 << 31, compression=Compression.HASH,
        compression_ratio=10.0, baseline_correction=True, init_logit=-2.0)
    if kind == "ubm":
        return UserBrowsingModel(positions=POSITIONS, attraction=cfg,
                                 device=device)
    if kind == "dbn":
        return DynamicBayesianNetwork(positions=POSITIONS, attraction=cfg,
                                      satisfaction=cfg, device=device)
    if kind == "dctr":
        return DocumentCTR(positions=POSITIONS, attraction=cfg, device=device)
    raise ValueError(f"no paper-width {kind!r} in the port (ubm, dbn, dctr)")


def make_two_tower(kind: str = "pbm", features: int = TOWER_FEATURES,
                   device="cuda", seed: int = 0):
    """Listing 4: the two-tower PBM (``kind="pbm"``: a rank table for
    examination, DeepCrossV2 with 2 cross and 2 deep layers, stacked, over
    ``features`` query-document features for attraction) or the naive DCTR
    with the same tower (``kind="dctr"``); ``seed`` seeds the tower."""
    tower = DeepCrossParameterConfig(features=features, cross_layers=2,
                                     deep_layers=2)
    if kind == "pbm":
        return PositionBasedModel(positions=POSITIONS, attraction=tower,
                                  device=device, seed=seed)
    if kind == "dctr":
        return DocumentCTR(positions=POSITIONS, attraction=tower,
                           device=device, seed=seed)
    raise ValueError(f"no two-tower {kind!r} in the port (pbm, dctr)")


def _param_specs(model):
    """``(specs, like)``: the model's JAX-shaped tree of
    :class:`~repro_torch.distrib.shardings.PartitionSpec` (huge hashed
    tables row-sharded over ``model``, everything else replicated) and the
    tree of its parameters' shapes. A model built on the ``meta`` device
    gives both without allocating its tables."""
    from repro_torch.convert import param_path
    from repro_torch.distrib.shardings import P
    from repro_torch.tree import nest

    def rule(shape):
        if len(shape) >= 1 and shape[0] >= 1_000_000:
            return P("model", *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    named = list(model.named_parameters())
    paths = [param_path(n) for n, _ in named]
    shapes = [tuple(p.shape) for _, p in named]
    return nest(paths, [rule(s) for s in shapes]), nest(paths, shapes)


@torch.no_grad()
def serve_bulk(model, batch: Dict[str, np.ndarray]) -> np.ndarray:
    """JAX's ``serve_bulk`` cell (``SHAPES["serve_bulk"]``, 262,144 x 10 for
    the paper-width UBM, the JAX default, or DBN): the host batch
    (``positions``, ``query_doc_ids``, ``mask``) copied to the model's
    device, ``predict_clicks`` over it, and the ``(B, K)`` log P(click)
    copied back to the host."""
    device = next(model.parameters()).device
    out = model.predict_clicks({k: torch.from_numpy(np.ascontiguousarray(
        batch[k])).to(device) for k in ("positions", "query_doc_ids",
                                         "mask")})
    return out.cpu().numpy()
