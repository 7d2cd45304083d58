"""Training engine: chunked steps with device-resident losses, sparse
embedding tables, replica sweeps, the non-finite guard and on-device
telemetry.

Port of ``repro.train.engine.TrainEngine`` (the mesh waits for the
distributed slice).
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
graph is bound to the tensors it updates (the optimizer state, and a
sweep's stacked parameters and active mask): the kernels update them in
place, so their addresses stay fixed, and a call with another state object
captures anew. A CPU chunk runs the loop. Nothing chooses between the two
but the device, and a capture that fails raises.

**Sparse tables.** With ``sparse_tables=True`` every
:class:`~repro_torch.core.parameterization.EmbeddingParameter` table is
updated by lazy AdamW (:mod:`repro_torch.optim.sparse`): only the batch's
distinct rows are read and written, and the dense optimizer holds no
moments for a table. ``backward`` still makes the full (R, d) table
gradient, as the JAX engine's autodiff does; its rows are gathered at the
batch's distinct ids. ``sparse_table_kwargs`` must give ``lr`` and
``weight_decay`` mirroring the dense optimizer, since a transformation
cannot be introspected. Both routes are captured.

**Replica sweeps.** ``TrainEngine(replicas=R)`` trains R independent runs
on one batch stream: :meth:`init_replica_params` gives every parameter one
stacked leaf with a leading R axis (replica r's feature towers drawn from
``seeds[r]``, its tables at the model's values, which start at constants
as in JAX), :meth:`init_opt_state` the optimizer state stacked the same
way (step counts and injected learning rates ``(R,)``), and
:meth:`set_replica_lrs` one learning rate per replica (an ``inject_lr``
optimizer only). A step runs replica r's forward through
``torch.func.functional_call`` over views ``leaf[r]`` of the stacked
leaves, its backward, and its optimizer update on the views ``leaf[r]``,
``mu[r]``, ``count[r]``: the kernels launch once per replica, all inside
the one replay, and replica r gets bit for bit the run of a single engine
with the same seed and learning rate. Losses come back ``(n, R)``. ``step``
takes an ``active`` ``(R,)`` mask: an inactive replica keeps its
parameters, moments and count (per-replica early stopping). The mask lives
on the device as the predicate the update kernels read, so stopping a
replica writes into that tensor and never captures anew, as JAX never
retraces.

**Non-finite guard.** ``nonfinite_guard=True`` reduces the loss and every
gradient to one on-device flag ``ok`` (finite min and max of each
gradient); the update runs with ``ok`` (and a sweep's active mask) as its
predicate, so a poisoned step keeps the previous parameters and optimizer
state, step count included, with no host sync and no new capture. The
payload becomes ``{"loss", "skipped"}`` (``(n,)`` or ``(n, R)`` each). Guard
off is the unguarded engine, bit for bit.

**On-device telemetry.** ``telemetry=True`` computes per-step scalars
inside the chunk (JAX ``_telemetry_out``): the global norm of the gradients
(:func:`repro_torch.optim.global_norm`), the global norm of the parameters
after the update, from the update's own pass (:func:`repro_torch.optim.step`
with ``norm=True``; after the guard's predicate: a skipped step reports
the parameters it kept; a sweep's frozen replica, as in JAX's vmapped
step, the parameters its update would write), and the injected learning rate
where the optimizer carries one. They are outputs of the chunk beside
the losses, at fixed addresses in the captured graph, so they leave the
card with the losses, one chunk behind (:mod:`repro_torch.obs.telemetry`):
no host sync and no dispatch of their own, still one replay per chunk. The
parameters are bit for bit those of ``telemetry=False``. The payload
becomes a dict ``{"loss", "grad_norm", "param_norm"[, "lr"][,
"skipped"]}`` of ``(n,)`` (or ``(n, R)``) tensors. Telemetry on and off
are separate chunk signatures: they never share a graph.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import optim as optim_lib
from repro_torch.convert import param_path
from repro_torch.core.parameterization import (CONSTANT_START, Compression,
                                               EmbeddingParameter,
                                               FeatureParameter)
from repro_torch.optim.sparse import (init_sparse_table_state,
                                      sparse_adamw_update,
                                      unique_rows_with_sentinel)
from repro_torch.train.capture import ChunkGraphs
from repro_torch.tree import nest, tree_copy_, tree_leaves, tree_map

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


class _Call(torch.nn.Module):
    """``model``'s methods behind a ``forward``, so that
    ``torch.func.functional_call`` can run any of them over other
    parameters."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, method: str, *args):
        return getattr(self.model, method)(*args)


def call_with(model, names, tensors, method: str, *args):
    """``getattr(model, method)(*args)`` with its parameters ``names``
    replaced by ``tensors`` (a replica's views); ``tensors=None`` runs the
    model's own."""
    if tensors is None:
        return getattr(model, method)(*args)
    params = {"model." + n: t for n, t in zip(names, tensors)}
    return torch.func.functional_call(_Call(model), params, (method, *args))


def all_finite(loss: torch.Tensor, grads) -> torch.Tensor:
    """One bool 0-d device tensor: the loss and every gradient finite (a
    NaN or an infinity reaches the min or the max). No host sync."""
    ok = torch.isfinite(loss)
    for g in grads:
        if g.numel():
            lo, hi = torch.aminmax(g)
            ok = ok & torch.isfinite(lo) & torch.isfinite(hi)
    return ok


class TrainEngine:
    """Usage (what ``Trainer.train`` does)::

        engine = TrainEngine(model, optimizer, chunk_batches=4)
        opt_state = engine.init_opt_state()
        for chunk, loader_state, n in DevicePrefetcher(
                loader, chunk_batches=engine.chunk_batches, device=device):
            opt_state, losses = engine.step(opt_state, chunk)
            # losses: (n,) device tensor; read it one chunk behind

    A sweep (``replicas=R``) calls ``params = engine.init_replica_params(
    seeds)`` first: the stacked parameters live in the engine (and are
    returned as the JAX-shaped tree), and ``step(opt_state, chunk,
    active=mask)`` trains them.
    """

    def __init__(self, model, optimizer, *, chunk_batches: int = 1,
                 sparse_tables: bool = False,
                 sparse_table_kwargs: Optional[Dict[str, Any]] = None,
                 replicas: Optional[int] = None,
                 nonfinite_guard: bool = False, telemetry: bool = False):
        if chunk_batches < 1:
            raise ValueError(f"chunk_batches must be >= 1, got {chunk_batches}")
        if replicas is not None and replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.model = model
        self.optimizer = optimizer
        self.chunk_batches = int(chunk_batches)
        self.replicas = None if replicas is None else int(replicas)
        self.nonfinite_guard = bool(nonfinite_guard)
        self.telemetry = bool(telemetry)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.paths = [param_path(n) for n in self.names]
        self.params = [p for _, p in named]
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
        index = {id(p): i for i, p in enumerate(self.params)}
        # sparse key -> the table's index among the parameters
        self._table_at = {key: index[id(part.table)]
                          for key, part in self.sparse_parts.items()}
        tables_at = set(self._table_at.values())
        self._dense_at = [i for i in range(len(self.params))
                          if i not in tables_at]
        self.dense_params = [self.params[i] for i in self._dense_at]
        # a sweep's stacked parameters, their per-replica views and the
        # device-resident active mask (made by init_replica_params)
        self.replica_params: Optional[List[torch.Tensor]] = None
        self._views: List[List[torch.Tensor]] = []
        self.active: Optional[torch.Tensor] = None
        self._active_host: Optional[np.ndarray] = None
        # made at the first CUDA chunk
        self.graphs: Optional[ChunkGraphs] = None

    # -- optimizer state -------------------------------------------------------
    def _init_single(self, params):
        if not self.sparse_parts:
            return self.optimizer.init(params)
        return {"dense": self.optimizer.init([params[i]
                                              for i in self._dense_at]),
                "sparse": {key: init_sparse_table_state(params[i])
                           for key, i in self._table_at.items()}}

    def init_opt_state(self):
        """The dense optimizer's state, or ``{"dense": ..., "sparse":
        {"attraction/table": SparseTableState, ...}}`` with sparse tables
        (the dense state then covers every parameter but the tables). With
        ``replicas=R`` every leaf is stacked over a leading R axis (a step
        count or a learning rate becomes ``(R,)``); call
        :meth:`init_replica_params` first."""
        if self.replicas is None:
            return self._init_single(self.params)
        if self.replica_params is None:
            raise ValueError("a sweep's optimizer state needs its stacked "
                             "parameters: call init_replica_params first")
        R = self.replicas
        state = self._init_single(self.replica_params)
        return tree_map(lambda t: t.expand(R).clone()
                        if isinstance(t, torch.Tensor) and t.dim() == 0
                        else t, state)

    # -- replica sweeps --------------------------------------------------------
    def init_replica_params(self, seeds) -> Dict[str, Any]:
        """Stacked parameters, one leading R axis per leaf: replica r's
        feature towers are those of a tower built with ``seeds[r]``, every
        table and scalar keeps the model's value (they start at constants,
        as in JAX). Replica r of a freshly built model is then exactly the
        model built with ``seed=seeds[r]``. A parameter that is neither
        raises: nothing says how a seed draws it. The engine keeps the
        stacked tensors (its sweep trains them in place) and returns them
        as the JAX-shaped tree."""
        if self.replicas is None:
            raise ValueError("init_replica_params needs "
                             "TrainEngine(replicas=R)")
        seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
        if len(seeds) != self.replicas:
            raise ValueError(f"need exactly {self.replicas} seeds, got "
                             f"{len(seeds)}")
        towers = {}
        constant = {}
        for mname, module in self.model.named_modules():
            prefix = f"{mname}." if mname else ""
            if isinstance(module, FeatureParameter):
                towers[prefix] = module
            elif isinstance(module, CONSTANT_START):
                constant.update({prefix + k: p for k, p in
                                 module.named_parameters(recurse=False)})
        tower_names = {prefix + k for prefix, t in towers.items()
                       for k, _ in t.named_parameters()}
        unseeded = [n for n in self.names
                    if n not in constant and n not in tower_names]
        if unseeded:
            raise ValueError(f"init_replica_params: {unseeded} are neither "
                             "feature-tower weights nor tables or scalars "
                             "that start at a constant")
        R = self.replicas
        with torch.no_grad():
            stacked = [torch.empty((R,) + tuple(p.shape), dtype=p.dtype,
                                   device=p.device) for p in self.params]
            for r, seed in enumerate(seeds):
                values = dict(constant)
                for prefix, tower in towers.items():
                    built = FeatureParameter(
                        tower.config, next(tower.parameters()).device, seed)
                    values.update({prefix + k: p for k, p in
                                   built.named_parameters()})
                for leaf, n in zip(stacked, self.names):
                    leaf[r].copy_(values[n])
        self._bind_replicas(stacked)
        return nest(self.paths, stacked)

    def _bind_replicas(self, stacked: List[torch.Tensor]) -> None:
        self.replica_params = stacked
        # per replica, views that autograd treats as leaves: their grads
        # are their own tensors, never a slice of a stacked gradient
        self._views = [[t.detach()[r].requires_grad_(True) for t in stacked]
                       for r in range(self.replicas)]
        device = stacked[0].device if stacked else torch.device("cpu")
        self.active = torch.ones(self.replicas, dtype=torch.bool,
                                 device=device)
        self._active_host = np.ones(self.replicas, dtype=bool)

    def set_replica_lrs(self, opt_state, lrs):
        """Give every replica its own learning rate, written into the
        state's ``(R,)`` injected lr in place.

        Requires an optimizer built with ``inject_lr=True`` (the lr must be
        a state leaf to differ across replicas) and no sparse tables (the
        lazy-AdamW path takes its lr as a hyperparameter shared by all
        replicas)."""
        if self.replicas is None:
            raise ValueError("set_replica_lrs needs TrainEngine(replicas=R)")
        if self.sparse_parts:
            raise NotImplementedError(
                "per-replica learning rates are not supported with "
                "sparse_tables: sparse_table_kwargs['lr'] is a static "
                "hyperparameter shared across replicas")
        lrs = np.asarray(lrs, np.float32)
        if lrs.shape != (self.replicas,):
            raise ValueError(f"need exactly {self.replicas} learning rates, "
                             f"got shape {lrs.shape}")
        lr = optim_lib.get_injected_lr(opt_state)
        if lr is None:
            raise ValueError(
                "optimizer state has no InjectLRState — build the optimizer "
                "with inject_lr=True (e.g. optim.adamw(lr, inject_lr=True)) "
                "to set per-run learning rates")
        for r, value in enumerate(lrs.tolist()):
            lr[r].fill_(value)
        return opt_state

    def _set_active(self, active) -> None:
        """Write the host mask into the device's, element by element and
        only where it changed: a ``fill_`` each, no host sync."""
        mask = np.asarray(active, dtype=bool).reshape(-1)
        if mask.shape != (self.replicas,):
            raise ValueError(f"active mask of shape {mask.shape} for "
                             f"replicas={self.replicas}")
        for r in np.flatnonzero(mask != self._active_host):
            self.active[int(r)].fill_(bool(mask[r]))
        self._active_host = mask.copy()

    # -- the step --------------------------------------------------------------
    def _sparse_rows(self, batch) -> Dict[str, torch.Tensor]:
        """Each sparse table's distinct rows in the batch, padded with the
        sentinel (backward already summed duplicate lookups into the table
        gradient's rows)."""
        return {key: unique_rows_with_sentinel(
                    part.row_ids(batch), self.params[self._table_at[key]]
                    .shape[0])
                for key, part in self.sparse_parts.items()}

    def _update(self, opt_state, params, grads, rows, pred, norm=False,
                apply=None):
        """The optimizer half of a step over ``params`` (the model's, or a
        replica's views) and their ``grads``, under the predicate ``pred``
        (None: always). Returns the new state; with ``norm`` also the
        float64 sum of squares of the parameters the step would write under
        ``apply`` alone (see ``optim.step``: the telemetry's
        ``param_norm``)."""
        if not self.sparse_parts:
            return optim_lib.step(self.optimizer, grads, opt_state, params,
                                  pred, norm=norm, apply=apply)
        dense = optim_lib.step(
            self.optimizer, [grads[i] for i in self._dense_at],
            opt_state["dense"], [params[i] for i in self._dense_at], pred,
            norm=norm, apply=apply)
        if norm:
            dense, sumsq = dense
        sparse = {}
        for key, at in self._table_at.items():
            table, d_table = params[at], grads[at]
            n_rows = table.shape[0]
            # the sentinel pads read the last row, and are skipped
            d_rows = torch.index_select(
                d_table, 0, torch.clamp(rows[key], max=n_rows - 1))
            done = sparse_adamw_update(
                table, opt_state["sparse"][key], rows[key], d_rows,
                pred=pred, norm=norm, apply=apply, **self.sparse_kwargs)
            sparse[key] = done[1]
            if norm:
                sumsq = sumsq + done[2]
        state = {"dense": dense, "sparse": sparse}
        return (state, sumsq) if norm else state

    def apply_update(self, opt_state, batch: Dict[str, torch.Tensor]):
        """The optimizer half of a step, from the gradients that
        ``backward`` left in the model's ``.grad``; returns the new
        state."""
        return self._update(opt_state, self.params, _grads(self.params),
                            self._sparse_rows(batch), None)

    def _telemetry_out(self, out, grads, opt_state, sumsq) -> None:
        """Add the step's telemetry to ``out``: ``grad_norm`` of ``grads``
        (which the update reads and leaves), ``param_norm``, the root of
        ``sumsq`` (the update's own sum of squares of the parameters it
        would write under the guard), and the injected ``lr`` (a copy)
        where the state has one (the update leaves it as it is)."""
        with torch.no_grad():
            out["grad_norm"] = optim_lib.global_norm(grads)
            out["param_norm"] = torch.sqrt(sumsq).float()
            lr = optim_lib.get_injected_lr(opt_state)
            if lr is not None:
                out["lr"] = lr.clone()

    def _one_step(self, opt_state, batch: Dict[str, torch.Tensor]):
        """One optimizer step; returns the new state and the step's outputs:
        ``{"loss"}``, with the guard ``"skipped"``, with telemetry its
        series."""
        for p in self.params:
            p.grad = None
        loss = self.model.compute_loss(batch)
        loss.backward()
        grads = _grads(self.params)
        rows = self._sparse_rows(batch)
        out = {"loss": loss.detach()}
        ok = None
        if self.nonfinite_guard:
            ok = all_finite(out["loss"], grads)
            out["skipped"] = ~ok
        new = self._update(opt_state, self.params, grads, rows, ok,
                           norm=self.telemetry,
                           apply=ok if self.telemetry else None)
        if self.telemetry:
            new, sumsq = new
            self._telemetry_out(out, grads, new, sumsq)
        if ok is None:
            opt_state = new
        else:
            tree_copy_(opt_state, new)
        for p in self.params:
            p.grad = None
        return opt_state, out

    def _replica_one_step(self, opt_state, batch: Dict[str, torch.Tensor]):
        """One step of every replica: for each, its forward over its views,
        its backward, and its update under ``active[r]`` (and its own
        finiteness, with the guard), into its slice of the stacked state.
        Returns the state and the step's outputs, each ``(R,)``: ``loss``,
        with the guard ``skipped``, with telemetry its series.

        Telemetry follows JAX's vmapped step, which takes it before the
        active mask: ``param_norm`` is the norm of the parameters the
        replica's update would write (under the guard's ``ok``), so a
        frozen replica reports its would-be update while its parameters,
        moments and count stay as they were (``optim.step``'s norm
        mode)."""
        rows = self._sparse_rows(batch)
        outs = []
        for r, views in enumerate(self._views):
            for v in views:
                v.grad = None
            loss = call_with(self.model, self.names, views, "compute_loss",
                             batch)
            loss.backward()
            grads = _grads(views)
            out = {"loss": loss.detach()}
            pred, ok = self.active[r], None
            if self.nonfinite_guard:
                ok = all_finite(out["loss"], grads)
                # a frozen replica attempted no update: not skipped
                out["skipped"] = ~ok & pred
                pred = pred & ok
            state_r = tree_map(lambda t, r=r: t[r], opt_state)
            new = self._update(state_r, views, grads, rows, pred,
                               norm=self.telemetry,
                               apply=ok if self.telemetry else None)
            if self.telemetry:
                new, sumsq = new
                self._telemetry_out(out, grads, new, sumsq)
            tree_copy_(state_r, new)
            for v in views:
                v.grad = None
            outs.append(out)
        return opt_state, {k: torch.stack([o[k] for o in outs])
                           for k in outs[0]}

    def _loop(self, opt_state, chunk: Dict[str, torch.Tensor]):
        """The chunk's steps one after the other: the CPU's route, and the
        body that a CUDA chunk captures. Returns the state and the ``(n,)``
        (or ``(n, R)``) losses, or, with the guard or telemetry, the dict
        of every per-step series (see :meth:`step`)."""
        n = next(iter(chunk.values())).shape[0]
        one_step = (self._one_step if self.replicas is None
                    else self._replica_one_step)
        outs = []
        for i in range(n):
            opt_state, out = one_step(opt_state,
                                      {k: v[i] for k, v in chunk.items()})
            outs.append(out)
        stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        # a bare loss payload stays the (n,) tensor (JAX's _step_out_ys)
        return opt_state, (stacked["loss"] if set(stacked) == {"loss"}
                           else stacked)

    @staticmethod
    def _chunk_body(chunk: Dict[str, torch.Tensor], bound):
        """The loop of the bound ``(engine, tensors, opt_state)`` (a static
        method, so the graphs hold no reference to the engine). A graph
        replays the state at the addresses it captured, so every state
        tensor must be updated in place, as ``optim.step``'s fused pass and
        ``sparse_adamw_update`` do; a state that moved raises."""
        engine, _, opt_state = bound
        state, out = engine._loop(opt_state, chunk)
        if any(new is not old for new, old in zip(
                tree_leaves(state), tree_leaves(opt_state), strict=True)):
            raise RuntimeError(
                "TrainEngine: the optimizer made new state tensors; a "
                "captured chunk needs one that updates its state in place")
        return out if isinstance(out, dict) else {"losses": out}

    def step(self, opt_state, chunk: Dict[str, torch.Tensor], active=None
             ) -> Any:
        """``n = chunk[k].shape[0]`` optimizer steps, one per stacked batch.
        Returns the new optimizer state and the ``(n,)`` loss tensor (``(n,
        R)`` with replicas; with the guard ``{"loss", "skipped"}``, same
        shapes; with telemetry also ``grad_norm``, ``param_norm`` and, for
        an injected-lr optimizer, ``lr``). A CUDA chunk is one graph replay
        (after its signature's first chunk, which runs eagerly and is
        captured); the state object
        passed in is updated in place and returned. ``active``, an ``(R,)``
        bool mask (default: as the last call left it, all on at first),
        freezes the replicas it turns off."""
        if self.replicas is None:
            if active is not None:
                raise ValueError("active mask requires "
                                 "TrainEngine(replicas=R)")
        else:
            if self.replica_params is None:
                raise ValueError("a sweep steps its stacked parameters: "
                                 "call init_replica_params first")
            if active is not None:
                self._set_active(active)
        if next(iter(chunk.values())).device.type != "cuda":
            return self._loop(opt_state, chunk)
        if self.graphs is None:
            self.graphs = ChunkGraphs(self._chunk_body)
        return self._replayed(opt_state, chunk)

    def _replayed(self, opt_state, chunk: Dict[str, torch.Tensor]):
        tensors = (self.params if self.replicas is None
                   else self.replica_params + [self.active])
        # telemetry on and off are separate signatures: never one graph
        out = self.graphs(chunk, (self, tensors, opt_state),
                          tag=("telemetry", self.telemetry))
        # a copy: the graph's buffers are overwritten by the next replay
        if "losses" in out:
            return opt_state, out["losses"].clone()
        return opt_state, {k: v.clone() for k, v in out.items()}
