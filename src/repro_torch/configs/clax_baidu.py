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
``model``, everything else replicated. :func:`build_cell` builds the
dry-run cells on it (UBM ``train_batch`` and ``serve_bulk``, DBN
``train_batch``). Their tables have the rows ``EmbeddingParameter`` gives
2^31 ids hashed 10x, 214,748,672 (rounded up to a multiple of 512), as
JAX's own ``EmbeddingParameter`` sizes them; JAX's ``TABLE_ROWS``
constant (214,748,160) is read by nothing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import optim as optim_lib
from repro_torch.configs.common import Cell, dp_axes, fake_module, local_batch
from repro_torch.core import (Compression, DeepCrossParameterConfig,
                              DocumentCTR, DynamicBayesianNetwork,
                              EmbeddingParameterConfig, PositionBasedModel,
                              UserBrowsingModel)
from repro_torch.data.staging import staging_for
from repro_torch.obs import get_recorder

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
    copied back to the host.

    On a CUDA card the batch goes through the model's pinned staging set
    in pieces (:class:`~repro_torch.data.staging.PinnedStaging`) and the
    answer comes back into a new pinned tensor, whose numpy view the caller
    owns; on the CPU the arrays are copied as they lie.

    On the global recorder: a detail span ``serve_bulk`` (tag ``call``, its
    own span id) with the children ``serve_bulk.copy_in``,
    ``serve_bulk.predict`` (the host's enqueue) and ``serve_bulk.copy_out``
    (waits for the device, then copies back), and the detail counters
    ``serve_bulk.calls``, ``.sessions``, ``.bytes_in`` and ``.bytes_out``;
    through pinned staging also ``serve_bulk.pinned_calls`` and
    ``serve_bulk.pinned_allocs`` (staging sets allocated: one a shape).
    """
    rec = get_recorder()
    with rec.span("serve_bulk", detail=True) as call:
        call.tags["call"] = call.span_id
        device = next(model.parameters()).device
        staging = staging_for(model, device)
        with rec.span("serve_bulk.copy_in", detail=True):
            host = {k: np.ascontiguousarray(batch[k])
                    for k in ("positions", "query_doc_ids", "mask")}
            if staging is None:
                inputs = {k: torch.from_numpy(v).to(device)
                          for k, v in host.items()}
            else:
                inputs, allocated = staging.copy_in(host, device)
        with rec.span("serve_bulk.predict", detail=True):
            out = model.predict_clicks(inputs)
        with rec.span("serve_bulk.copy_out", detail=True):
            if staging is None:
                answer = out.cpu().numpy()
            else:
                answer = staging.copy_out(out, device)
        rec.add("serve_bulk.calls", detail=True)
        rec.add("serve_bulk.sessions", answer.shape[0], detail=True)
        rec.add("serve_bulk.bytes_in", sum(v.nbytes for v in host.values()),
                detail=True)
        rec.add("serve_bulk.bytes_out", answer.nbytes, detail=True)
        if staging is not None:
            rec.add("serve_bulk.pinned_calls", detail=True)
            rec.add("serve_bulk.pinned_allocs", int(allocated), detail=True)
    return answer


def _place(model, mesh) -> None:
    """Row-shard the tables of 1,000,000 rows or more over ``model`` (this
    rank keeps its rows; the lookups go through the masked all-reduce),
    leaving the rest whole: JAX's :func:`_param_specs`. The model counts
    as placed on ``mesh`` (a ``TrainEngine`` on it places nothing
    again)."""
    from repro_torch.core.parameterization import EmbeddingParameter
    from repro_torch.distrib.shardings import NamedSharding, P

    for part in model.modules():
        if isinstance(part, EmbeddingParameter):
            for name in ("table", "quotient", "remainder"):
                t = getattr(part, name, None)
                if t is not None and t.shape[0] >= 1_000_000:
                    part.shard_rows_(name, NamedSharding(mesh,
                                                         P("model", None)))
    model._mesh = mesh


def build_cell(shape: str, mesh, kind: str = "ubm") -> Cell:
    """The dry-run cell of the paper-width ``kind`` (``ubm`` or ``dbn``) at
    ``shape`` on ``mesh``: ``train_batch`` is one step of the engine's
    eager route (``TrainEngine._loop`` over a chunk of one batch, never a
    capture), ``serve_bulk`` one ``predict_clicks`` over this rank's
    rows."""
    from repro_torch.distrib.shardings import P
    from repro_torch.train.engine import TrainEngine

    info = SHAPES[shape]
    B = info["batch"]
    dp = dp_axes(mesh)
    device = mesh.device_type
    model = fake_module(make_model(kind, device="meta"), device)
    pspecs, _ = _param_specs(model)
    _place(model, mesh)
    shapes = {"positions": ((B, POSITIONS), torch.int32),
              "query_doc_ids": ((B, POSITIONS), torch.int32),
              "clicks": ((B, POSITIONS), torch.float32),
              "mask": ((B, POSITIONS), torch.bool)}
    bspecs = {k: P(dp, None) for k in shapes}
    batch = local_batch(mesh, shapes, bspecs, device)

    if info["kind"] == "train":
        engine = TrainEngine(model, optim_lib.adamw(3e-3, weight_decay=1e-4),
                             mesh=mesh)
        opt_state = engine.init_opt_state()
        chunk = {k: v[None] for k, v in batch.items()}

        def train_step(model, opt_state, chunk):
            return engine._loop(opt_state, chunk)

        ospecs = (optim_lib.ScaleByAdamState(count=P(), mu=pspecs,
                                             nu=pspecs), (), ())
        return Cell(
            arch=f"clax-{kind}-baidu", shape=shape, kind="train",
            fn=train_step, args=(model, opt_state, chunk),
            in_specs=(pspecs, ospecs, {k: P(None, dp, None)
                                       for k in shapes}),
            out_specs=(pspecs, ospecs, P()),
            # log-space chain: ~60 flops/item fwd, 3x for bwd — gather-bound.
            model_flops=3.0 * 60 * B * POSITIONS,
            donate=(0, 1),
            notes="2^31 ids hashed 10x -> 214.7M rows P('model'); AdamW",
        )

    return Cell(
        arch=f"clax-{kind}-baidu", shape=shape, kind="serve",
        fn=lambda model, batch: model.predict_clicks(batch),
        args=(model, batch), in_specs=(pspecs, bspecs),
        out_specs=P(dp, None),
        model_flops=1.0 * 60 * B * POSITIONS * POSITIONS,
        notes="unconditional click prediction (UBM marginalization O(K^2))",
    )
