"""Warm multi-model registry: one process serves many models, three tiers.

Port of ``repro.serve.registry``. Each :class:`ModelEntry` owns the three
rungs of its degradation ladder:

* ``primary`` — the float32 parameters through the model's
  ``predict_clicks``.
* ``int8`` — a 4x smaller resident copy where every large float leaf is
  int8-quantized (:func:`repro_torch.distrib.compression.quantize_tree`).
  The tables are read **gather-first**: a lookup gathers the batch's int8
  rows and widens only them (``EmbeddingParameter.int8``), which equals
  dequantize-then-gather to the bit; JAX gets the same from XLA fusing the
  elementwise dequantize into the gather. No call makes a float32 table.
  Any other quantized leaf (a large tower kernel) is widened whole inside
  the call. The worst per-logit error is ``scale/2`` per quantized factor.
* ``prior`` — a constant log-CTR, pure host numpy: the answer of last
  resort that cannot fail and costs nothing.

**No recapture** (JAX: no retrace). On the card, :meth:`ModelRegistry.warmup`
captures one CUDA graph per (model, tier, bucket) before the first request,
each with static pinned host and device input buffers and a static output,
all graphs in one memory pool; each capture bumps ``trace_counts[tier]``
(JAX's field name: the counter equality of "traffic never captures" reads
as JAX's "traffic never retraces"). A call is then one ``copy_`` per input
into the pinned and then the device buffer, one replay, and one
device-to-host copy of the ``(bucket, K)`` answer behind one event; while
``capture.replayed_kernels`` counts, each replay adds its graph's kernel
nodes to it, as ``ChunkGraphs``' replays do. The capture follows ``train/capture.py``'s discipline: an eager warm-up and the
capture on its side stream, ``capture_error_mode="thread_local"``, the
cyclic collector off while capturing, a failed capture raises (nothing
falls back to an eager call), and no body holds its entry (the tier
functions are static, bound to the model alone). On the CPU each call runs
eagerly and nothing is captured, unless the registry is given a stand-in
``backend`` (the tests' graphs, whose replay runs the body).

Warmup also seeds the per-bucket service-time estimates: an EMA of the
measured wall time of a rerun (a replay on the card), or the exact
:class:`~repro_torch.serve.clock.ServiceModel` under virtual time, which
the deadline-aware batcher plans with.
"""
from __future__ import annotations

import functools
import math
import time
from typing import Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.convert import load_jax_params
from repro_torch.core.parameterization import (EmbeddingParameter,
                                               int8_lookups)
from repro_torch.distrib.compression import (QuantizedTensor, dequantize_int8,
                                             quantize_tree, tree_nbytes)
from repro_torch.serve.request import TIERS, make_request
from repro_torch.train import capture
from repro_torch.train.engine import call_with

DEFAULT_BUCKETS = (1, 4, 16, 64, 256)

# EMA weight for wall-mode service-time estimates: new = (1-a)*old + a*obs.
_EMA_ALPHA = 0.3


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _primary(model, batch):
    return model.predict_clicks(batch)


@torch.no_grad()
def _int8(model, tables, widened, batch):
    """``predict_clicks`` over the int8 copy: the tables gathered first
    (``tables``: ``[(part, {name: (q, scale)})]``), every other quantized
    leaf (``widened``: ``{param name: QuantizedTensor}``) widened whole."""
    with int8_lookups(tables):
        if not widened:
            return model.predict_clicks(batch)
        return call_with(model, list(widened),
                         [dequantize_int8(qt.q, qt.scale)
                          for qt in widened.values()],
                         "predict_clicks", batch)


class _Replay(NamedTuple):
    """One captured (tier, bucket): its static buffers, graph and event."""
    host: Dict[str, torch.Tensor]     # pinned on the card's host
    device: Dict[str, torch.Tensor]
    out: torch.Tensor                 # the graph's output
    out_host: torch.Tensor            # pinned
    graph: object
    event: Optional[torch.cuda.Event]


class ModelEntry:
    """One served model. ``params`` is the JAX-shaped tree (numpy arrays,
    loaded into ``model`` with :func:`repro_torch.convert.load_jax_params`)
    or None to serve the model's own parameters. ``backend`` supplies
    ``warm_up(fn)`` and ``capture(fn) -> graph``
    (:class:`repro_torch.train.capture.CudaGraphs`, shared by a registry's
    entries so their graphs share one pool); None runs every call eagerly
    (the CPU)."""

    def __init__(self, name: str, model, params, n_pairs: int,
                 prior_ctr: float = 0.1, feature_dim: Optional[int] = None,
                 quantize_min_size: int = 512, service_model=None,
                 backend=None):
        if params is not None:
            load_jax_params(model, params)
        self.name = name
        self.model = model
        self.device = _model_device(model)
        self.n_pairs = int(n_pairs)
        self.positions = int(model.positions)
        self.feature_dim = feature_dim
        self.prior_log_ctr = math.log(min(max(float(prior_ctr), 1e-6),
                                          1.0 - 1e-6))
        self.service_model = service_model
        self.backend = backend
        self.trace_counts: Dict[str, int] = {"primary": 0, "int8": 0}
        self.dispatches = 0
        self.errors = 0
        self.replays = 0
        self._estimates: Dict[tuple, float] = {}
        self._replays: Dict[tuple, _Replay] = {}
        self._kernels: Dict[tuple, object] = {}
        # host seconds of each capture (warm-up excluded), by tier/bucket
        self.capture_seconds: Dict[str, float] = {}

        named = {n: p.detach() for n, p in model.named_parameters()}
        self.qparams = quantize_tree(named, min_size=quantize_min_size)
        self.primary_nbytes = tree_nbytes(named)
        self.int8_nbytes = tree_nbytes(self.qparams)
        # the quantized tables, read gather-first; the other quantized
        # leaves, widened whole in the call
        tables = []
        in_tables = set()
        for mname, module in model.named_modules():
            if not isinstance(module, EmbeddingParameter):
                continue
            prefix = f"{mname}." if mname else ""
            copies = {}
            for pname, _ in module.named_parameters(recurse=False):
                qt = self.qparams.get(prefix + pname)
                # the tables EmbeddingParameter._rows reads
                if isinstance(qt, QuantizedTensor) and pname in (
                        "table", "quotient", "remainder"):
                    copies[pname] = (qt.q, qt.scale)
                    in_tables.add(prefix + pname)
            if copies:
                tables.append((module, copies))
        widened = {n: qt for n, qt in self.qparams.items()
                   if isinstance(qt, QuantizedTensor) and n not in in_tables}
        # static functions bound to the model alone: no cycle through self
        self._fns = {"primary": functools.partial(_primary, model),
                     "int8": functools.partial(_int8, model, tables,
                                               widened)}

    # -- execution -----------------------------------------------------------
    def _tensors(self, batch: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _capture(self, key: tuple, batch: Dict[str, np.ndarray]
                 ) -> _Replay:
        """Static buffers for ``batch``'s shapes, the eager warm-up and the
        capture of the tier's function over them; counts the capture."""
        tier = key[0]
        cuda = self.device.type == "cuda"
        host = {k: torch.empty(v.shape, dtype=torch.from_numpy(
                    np.asarray(v)).dtype, pin_memory=cuda)
                for k, v in batch.items()}
        device = {k: torch.empty_like(h, device=self.device)
                  for k, h in host.items()}
        for k, v in batch.items():
            host[k].numpy()[...] = v
            device[k].copy_(host[k])
        fn = self._fns[tier]
        first = self.backend.warm_up(lambda: fn(device))
        out = torch.empty_like(first)

        def captured():
            out.copy_(fn(device))

        t0 = time.perf_counter()
        graph = self.backend.capture(captured)
        bucket = len(batch["positions"])
        self.capture_seconds[f"{tier}/{bucket}"] = time.perf_counter() - t0
        self.trace_counts[tier] += 1
        replay = _Replay(host, device, out,
                         torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=cuda),
                         graph, torch.cuda.Event() if cuda else None)
        self._replays[key] = replay
        return replay

    def launch(self, tier: str, batch: Dict[str, np.ndarray]) -> _Replay:
        """The device half of a captured call: each input copied into its
        pinned and then its device buffer, one replay, the answer's copy to
        the host and the event behind it. Nothing here waits for the
        device: :meth:`collect` it before the next launch of the same
        (tier, shapes), whose pinned buffers this one's copies read. Captures
        first if this (tier, shapes) has no graph yet."""
        key = (tier, tuple(sorted((k, np.shape(v)) for k, v in batch.items())))
        replay = self._replays.get(key)
        if replay is None:
            replay = self._capture(key, batch)
        for k, v in batch.items():
            replay.host[k].numpy()[...] = v
            replay.device[k].copy_(replay.host[k], non_blocking=True)
        replay.graph.replay()
        self.replays += 1
        if capture.replayed_kernels is not None:  # counting, as ChunkGraphs
            if key not in self._kernels:
                self._kernels[key] = self.backend.kernels(replay.graph)
            capture.replayed_kernels.update(self._kernels[key])
        replay.out_host.copy_(replay.out, non_blocking=True)
        if replay.event is not None:
            replay.event.record()
        return replay

    @staticmethod
    def collect(replay: _Replay) -> np.ndarray:
        """Wait for :meth:`launch`'s answer and return a host copy of it."""
        if replay.event is not None:
            replay.event.synchronize()
        return replay.out_host.numpy().copy()

    def run(self, tier: str, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Run one padded batch on ``tier``; blocks until the answer is on
        the host. Raises whatever the computation raises — the engine's
        ladder walk is the catch site."""
        if tier == "prior":
            return np.full(batch["positions"].shape, self.prior_log_ctr,
                           np.float32)
        if self.backend is None:
            out = self._fns[tier](self._tensors(batch))
            return out.cpu().numpy()
        return self.collect(self.launch(tier, batch))

    # -- service-time estimates ----------------------------------------------
    def estimate(self, tier: str, bucket: int) -> float:
        if self.service_model is not None:
            return self.service_model(tier, bucket)
        return self._estimates.get((tier, bucket), 0.0)

    def observe(self, tier: str, bucket: int, seconds: float) -> None:
        if self.service_model is not None:
            return
        key = (tier, bucket)
        old = self._estimates.get(key)
        self._estimates[key] = seconds if old is None else \
            (1.0 - _EMA_ALPHA) * old + _EMA_ALPHA * seconds

    def health(self) -> Dict:
        return {"dispatches": self.dispatches, "errors": self.errors,
                "trace_counts": dict(self.trace_counts),
                "primary_nbytes": self.primary_nbytes,
                "int8_nbytes": self.int8_nbytes}


class ModelRegistry:
    """The served models. ``backend`` captures every entry's graphs, in one
    shared pool: by default a :class:`~repro_torch.train.capture.CudaGraphs`
    for the entries on the card, none (eager calls) for those on the CPU;
    a test may pass a stand-in for every entry."""

    def __init__(self, buckets: Iterable[int] = DEFAULT_BUCKETS,
                 service_model=None, backend=None):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("buckets must be positive ints")
        self.service_model = service_model
        self.backend = backend
        self._cuda_graphs = None
        self.entries: Dict[str, ModelEntry] = {}

    def _backend_for(self, model):
        if self.backend is not None:
            return self.backend
        if _model_device(model).type != "cuda":
            return None
        if self._cuda_graphs is None:
            self._cuda_graphs = capture.CudaGraphs()
        return self._cuda_graphs

    def add(self, name: str, model, params, n_pairs: int,
            prior_ctr: float = 0.1, feature_dim: Optional[int] = None,
            quantize_min_size: int = 512) -> ModelEntry:
        entry = ModelEntry(name, model, params, n_pairs,
                           prior_ctr=prior_ctr, feature_dim=feature_dim,
                           quantize_min_size=quantize_min_size,
                           service_model=self.service_model,
                           backend=self._backend_for(model))
        self.entries[name] = entry
        return entry

    def __getitem__(self, name: str) -> ModelEntry:
        return self.entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def choose_bucket(self, n: int) -> int:
        """Smallest captured bucket holding ``n`` requests."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def dummy_batch(self, entry: ModelEntry, bucket: int):
        """A well-formed padded batch for warmup captures."""
        rng = np.random.default_rng(0)
        reqs = [make_request(-1 - i, entry.name, entry.positions, rng,
                             entry.n_pairs) for i in range(1)]
        return pad_batch(reqs, bucket, entry)

    def warmup(self, log_fn=None) -> Dict[str, float]:
        """Capture every (model, tier, bucket) graph and seed service-time
        estimates. After this returns, a request can only ever replay a
        captured graph: the first call's warm-up and capture are paid here,
        not by traffic."""
        seeded = {}
        for entry in self.entries.values():
            for tier in TIERS:
                for bucket in self.buckets:
                    batch = self.dummy_batch(entry, bucket)
                    t0 = time.perf_counter()
                    entry.run(tier, batch)
                    # warm-up + capture + replay; rerun for a replay alone
                    t1 = time.perf_counter()
                    entry.run(tier, batch)
                    dt = time.perf_counter() - t1
                    entry.observe(tier, bucket, dt)
                    seeded[f"{entry.name}/{tier}/{bucket}"] = dt
                    if log_fn:
                        log_fn(f"[serve] warm {entry.name}/{tier} bucket "
                               f"{bucket}: capture {t1 - t0:.3f}s "
                               f"run {dt * 1e3:.2f}ms")
        return seeded


def pad_batch(requests, bucket: int, entry: ModelEntry):
    """Stack validated requests into a (bucket, K) batch dict; pad rows are
    fully masked out so they cannot influence real rows."""
    k = entry.positions
    positions = np.tile(np.arange(1, k + 1, dtype=np.int32), (bucket, 1))
    ids = np.zeros((bucket, k), np.int32)
    mask = np.zeros((bucket, k), bool)
    for i, req in enumerate(requests):
        positions[i] = np.asarray(req.positions, np.int32)
        ids[i] = np.asarray(req.query_doc_ids, np.int32)
        mask[i] = np.asarray(req.mask, bool)
    batch = {"positions": positions, "query_doc_ids": ids, "mask": mask,
             "clicks": np.zeros((bucket, k), np.float32)}
    if entry.feature_dim is not None:
        feats = np.zeros((bucket, k, entry.feature_dim), np.float32)
        for i, req in enumerate(requests):
            if req.features is not None:
                feats[i] = np.asarray(req.features, np.float32)
        batch["query_doc_features"] = feats
    return batch
