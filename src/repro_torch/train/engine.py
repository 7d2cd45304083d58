"""Single-device training engine: chunked steps with device-resident losses,
and sparse embedding tables.

Port of the single-device core of ``repro.train.engine.TrainEngine``.
``DevicePrefetcher(chunk_batches=N)`` stacks N host batches into one
``(N, B, ...)`` device tensor per key; :meth:`TrainEngine.step` runs the N
optimizer steps over it and returns the per-step losses as one ``(N,)``
tensor that stays on the device until the caller drains it. The body of a
chunk is a loop over :meth:`_one_step`, so a chunk of N gives bit for bit
the parameters and losses of N chunks of one. Parameters live in the model
and are updated in place through ``optim.step``: the fused ``adamw`` kernel
on the card, the chain on the CPU.

**One dispatch per chunk** (the JAX engine jits its ``lax.scan`` over the
chunk into one dispatch, since a per-batch loop starves the accelerator).
A CUDA chunk runs through :class:`~repro_torch.train.capture.ChunkGraphs`:
the first chunk of each signature (n, and each key's shape and dtype, as
JAX retraces per shape) runs the loop eagerly, as the warm-up, and is then
captured in a CUDA graph; every later chunk of that signature is copied
into the graph's static buffers and replayed, one replay per chunk. The
graph is bound to the optimizer state it captured: the kernels update the
parameters and the state in place, so their addresses stay fixed, and a
call with another state object captures anew. A CPU chunk runs the loop.
Nothing chooses between the two but the device, and a capture that fails
raises.

**Sparse tables.** With ``sparse_tables=True`` every
:class:`~repro_torch.core.parameterization.EmbeddingParameter` table is
updated by lazy AdamW (:mod:`repro_torch.optim.sparse`): only the batch's
distinct rows are read and written, and the dense optimizer holds no
moments for a table. ``backward`` still makes the full (R, d) table
gradient, as the JAX engine's autodiff does; its rows are gathered at the
batch's distinct ids. ``sparse_table_kwargs`` must give ``lr`` and
``weight_decay`` mirroring the dense optimizer, since a transformation
cannot be introspected. Both routes are captured.

Replicas, the mesh, the non-finite guard and telemetry wait for later
slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import optim as optim_lib
from repro_torch.core.parameterization import Compression, EmbeddingParameter
from repro_torch.optim.sparse import (init_sparse_table_state,
                                      sparse_adamw_update,
                                      unique_rows_with_sentinel)
from repro_torch.train.capture import ChunkGraphs, tree_leaves

SPARSE_PATH_SEP = "/"


def discover_sparse_tables(model) -> Dict[Tuple[str, ...],
                                          EmbeddingParameter]:
    """Map param path -> EmbeddingParameter for every table part of
    ``model``.

    Only single-table parameterizations qualify: QR compression splits each
    logical row across two tables and has no single row-id stream.
    """
    parts = getattr(model, "parts", None) or {}
    out = {}
    for name, part in parts.items():
        if isinstance(part, EmbeddingParameter):
            if part.config.compression == Compression.QR:
                raise NotImplementedError(
                    f"sparse_tables: part {name!r} uses quotient-remainder "
                    "compression (two coupled tables, no single row-id "
                    "stream) — train it with the dense optimizer")
            out[(name, "table")] = part
    if not out:
        raise ValueError(
            "sparse_tables=True but the model has no EmbeddingParameter "
            "parts — nothing to update sparsely")
    return out


def _grads(params):
    return [torch.zeros_like(p) if p.grad is None else p.grad
            for p in params]


class TrainEngine:
    """Usage (what ``Trainer.train`` does)::

        engine = TrainEngine(model, optimizer, chunk_batches=4)
        opt_state = engine.init_opt_state()
        for chunk, loader_state, n in DevicePrefetcher(
                loader, chunk_batches=engine.chunk_batches, device=device):
            opt_state, losses = engine.step(opt_state, chunk)
            # losses: (n,) device tensor; read it one chunk behind
    """

    def __init__(self, model, optimizer, *, chunk_batches: int = 1,
                 sparse_tables: bool = False,
                 sparse_table_kwargs: Optional[Dict[str, Any]] = None):
        if chunk_batches < 1:
            raise ValueError(f"chunk_batches must be >= 1, got {chunk_batches}")
        self.model = model
        self.optimizer = optimizer
        self.chunk_batches = int(chunk_batches)
        self.params = list(model.parameters())
        tables = discover_sparse_tables(model) if sparse_tables else {}
        self.sparse_parts = {SPARSE_PATH_SEP.join(path): part
                             for path, part in tables.items()}
        self.sparse_kwargs = {}
        if self.sparse_parts:
            kwargs = dict(sparse_table_kwargs or {})
            missing = [k for k in ("lr", "weight_decay") if k not in kwargs]
            if missing:
                # The defaults disagree (optim.adamw decays at 1e-4,
                # sparse_adamw_update at 0.0): silence would quietly break
                # the touched-rows == dense-AdamW guarantee.
                raise ValueError(
                    f"sparse_tables=True needs sparse_table_kwargs with "
                    f"{missing} mirroring the dense optimizer (pass b1/b2/"
                    f"eps too if the dense optimizer overrides them)")
            self.sparse_kwargs = kwargs
        table_ids = {id(part.table) for part in self.sparse_parts.values()}
        self.dense_params = [p for p in self.params
                             if id(p) not in table_ids]
        # made at the first CUDA chunk
        self.graphs: Optional[ChunkGraphs] = None

    def init_opt_state(self):
        """The dense optimizer's state, or ``{"dense": ..., "sparse":
        {"attraction/table": SparseTableState, ...}}`` with sparse tables
        (the dense state then covers every parameter but the tables)."""
        if not self.sparse_parts:
            return self.optimizer.init(self.params)
        return {"dense": self.optimizer.init(self.dense_params),
                "sparse": {key: init_sparse_table_state(part.table)
                           for key, part in self.sparse_parts.items()}}

    def apply_update(self, opt_state, batch: Dict[str, torch.Tensor]):
        """The optimizer half of a step, from the gradients that
        ``backward`` left in ``.grad``; returns the new state."""
        if not self.sparse_parts:
            return optim_lib.step(self.optimizer, _grads(self.params),
                                  opt_state, self.params)
        dense = optim_lib.step(self.optimizer, _grads(self.dense_params),
                               opt_state["dense"], self.dense_params)
        sparse = {}
        for key, part in self.sparse_parts.items():
            table = part.table
            n_rows = table.shape[0]
            # backward already summed duplicate lookups into the table
            # gradient's rows: take exactly the batch's distinct rows (the
            # sentinel pads read the last row, and are skipped).
            rows = unique_rows_with_sentinel(part.row_ids(batch), n_rows)
            (d_table,) = _grads([table])
            d_rows = torch.index_select(d_table, 0,
                                        torch.clamp(rows, max=n_rows - 1))
            _, sparse[key] = sparse_adamw_update(
                table, opt_state["sparse"][key], rows, d_rows,
                **self.sparse_kwargs)
        return {"dense": dense, "sparse": sparse}

    def _one_step(self, opt_state, batch: Dict[str, torch.Tensor]):
        """One optimizer step; returns the new state and the detached loss."""
        for p in self.params:
            p.grad = None
        loss = self.model.compute_loss(batch)
        loss.backward()
        opt_state = self.apply_update(opt_state, batch)
        for p in self.params:
            p.grad = None
        return opt_state, loss.detach()

    def _loop(self, opt_state, chunk: Dict[str, torch.Tensor]):
        """The chunk's steps one after the other: the CPU's route, and the
        body that a CUDA chunk captures."""
        n = next(iter(chunk.values())).shape[0]
        losses = []
        for i in range(n):
            opt_state, loss = self._one_step(
                opt_state, {k: v[i] for k, v in chunk.items()})
            losses.append(loss)
        return opt_state, torch.stack(losses)

    @staticmethod
    def _chunk_body(chunk: Dict[str, torch.Tensor], bound):
        """The loop of the bound ``(engine, params, opt_state)`` (a static
        method, so the graphs hold no reference to the engine). A graph
        replays the state at the addresses it captured, so every state
        tensor must be updated in place, as ``optim.step``'s fused pass and
        ``sparse_adamw_update`` do; a state that moved raises."""
        engine, _, opt_state = bound
        state, losses = engine._loop(opt_state, chunk)
        if any(new is not old for new, old in zip(
                tree_leaves(state), tree_leaves(opt_state), strict=True)):
            raise RuntimeError(
                "TrainEngine: the optimizer made new state tensors; a "
                "captured chunk needs one that updates its state in place")
        return {"losses": losses}

    def step(self, opt_state, chunk: Dict[str, torch.Tensor]) -> Any:
        """``n = chunk[k].shape[0]`` optimizer steps, one per stacked batch.
        Returns the new optimizer state and the ``(n,)`` loss tensor. A CUDA
        chunk is one graph replay (after its signature's first chunk, which
        runs eagerly and is captured); the state object passed in is updated
        in place and returned."""
        if next(iter(chunk.values())).device.type != "cuda":
            return self._loop(opt_state, chunk)
        if self.graphs is None:
            self.graphs = ChunkGraphs(self._chunk_body)
        return self._replayed(opt_state, chunk)

    def _replayed(self, opt_state, chunk: Dict[str, torch.Tensor]):
        out = self.graphs(chunk, (self, self.params, opt_state))
        # a copy: the graph's buffer is overwritten by the next replay
        return opt_state, out["losses"].clone()
