"""One CUDA graph per chunk signature: the port's counterpart of ``jax.jit``
over an engine chunk (``repro.train.engine.TrainEngine._chunk_step``, a
scanned step jitted into one dispatch, retraced per chunk shape).

:class:`ChunkGraphs` runs a *body* ``body(inputs, bound)``: ``inputs`` is a
dict of device tensors (one chunk's stacked batches; for evaluation also
the metric state), ``bound`` is what the caller passed beside them (for
training the parameters and the optimizer state, which the body updates
in place), and the body returns a dict of tensors. The first call of each
signature (every input's name, shape and dtype, after the caller's
``tag``: what else changes the body, such as the engine's telemetry) does
three things:

1. copies the inputs into static buffers of its own;
2. runs the body eagerly over them, on a side stream (one per device)
   that the current stream then waits on. That is the warm-up that
   capturing a whole training step requires, and a real run: its outputs
   are the call's result and its in-place updates stand;
3. captures the body into a ``torch.cuda.CUDAGraph`` on that stream, in a
   memory pool shared by all of this object's graphs. Each output is
   copied into a static buffer inside the capture, so the graph writes its
   results to fixed addresses; an output named like an input (a carry) is
   copied into that input's buffer. The capture runs nothing. It uses
   ``capture_error_mode="thread_local"``, so the CUDA calls of another
   thread (the prefetcher's staging thread copies and queries events
   meanwhile, on a stream of another priority, which no capture uses) do
   not void it. Python's cyclic garbage collector is off while capturing:
   a collection there could free another graph (an engine dropped in a
   reference cycle), and destroying a graph voids the capture under way.
   A capture that fails raises: nothing falls back to the eager body.

A later call of the same signature copies each input into its static buffer
(one ``copy_`` per key, none where the input already is that buffer),
replays the graph once and returns the static outputs, which the next
replay of that signature overwrites.

A graph reads and writes the bound tensors at the addresses it captured,
so the graphs are keyed by those addresses too (the tensors of ``bound``,
see :func:`tree_leaves`): a call with other bound tensors (another
optimizer state) drops every graph and captures anew. Nothing here keeps
``bound`` past the call, so a body that is a plain function (an owner
passes itself in ``bound``) leaves no reference cycle: a dropped owner
frees its graphs and their pool at once.

A replay runs no Python, so no kernel wrapper counts its launches; the
wrappers count none while a stream is being captured either (a capture
launches nothing). The launches of replays are read from the graphs
themselves: each graph keeps its ``cudaGraph_t``, and while
:data:`replayed_kernels` is a ``Counter`` every replay adds to it the
graph's kernel nodes by function name (:func:`graph_kernels`, read once per
graph with the CUDA driver API). That count is exact: it is the graph the
replay launches, and no trace buffer can drop it.
"""
from __future__ import annotations

import ctypes
import gc
import time
from collections import Counter
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves

Tensors = Dict[str, torch.Tensor]


_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}

#: While a ``Counter``, the kernel launches of every replay, by kernel
#: (function) name; ``None`` counts nothing.
replayed_kernels: Optional[Counter] = None

# CUgraphNodeType values (cuda.h)
_KERNEL_NODE, _CHILD_GRAPH_NODE, _CONDITIONAL_NODE = 0, 4, 13


def _driver_call(lib, name, *args) -> None:
    err = getattr(lib, name)(*args)
    if err:
        raise RuntimeError(f"{name} failed with CUresult {err}")


def graph_kernels(raw_graph: int) -> Counter:
    """The kernel nodes of a ``cudaGraph_t`` (child graphs included), by
    function name, read with the CUDA driver API (``cuFuncGetName`` and
    ``cuKernelGetName`` need a driver of CUDA 12.3 or later). A conditional
    node raises: how often its body runs is not in the graph."""
    lib = ctypes.CDLL("libcuda.so.1")
    out: Counter = Counter()
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    _driver_call(lib, "cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _driver_call(lib, "cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        _driver_call(lib, "cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value == _CHILD_GRAPH_NODE:
            child = ctypes.c_void_p()
            _driver_call(lib, "cuGraphChildGraphNodeGetGraph", node,
                         ctypes.byref(child))
            out.update(graph_kernels(child.value))
        elif kind.value == _CONDITIONAL_NODE:
            raise RuntimeError("graph_kernels: a conditional node's "
                               "launches are not in the graph")
        elif kind.value == _KERNEL_NODE:
            # CUDA_KERNEL_NODE_PARAMS_v2: CUfunction func at byte 0, CUkernel
            # kern at byte 56 (the buffer is larger than the struct)
            params = (ctypes.c_uint64 * 16)()
            _driver_call(lib, "cuGraphKernelNodeGetParams_v2", node, params)
            func, kern = params[0], params[7]
            name = ctypes.c_char_p()
            if func:
                _driver_call(lib, "cuFuncGetName", ctypes.byref(name),
                             ctypes.c_void_p(func))
            else:
                _driver_call(lib, "cuKernelGetName", ctypes.byref(name),
                             ctypes.c_void_p(kern))
            out[name.value.decode()] += 1
    return out


def _side_stream() -> torch.cuda.Stream:
    """The current device's one stream for every warm-up and capture.
    PyTorch keeps a cuBLAS workspace (32 MiB on Hopper) for each stream that
    runs a matrix product, for good, so a new stream for each capture would
    leave one more behind every time."""
    index = torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


class CudaGraphs:
    """The CUDA side of :class:`ChunkGraphs`: eager warm-up and capture on
    a side stream, the captures into one shared memory pool."""

    def __init__(self):
        self._pool = None

    def warm_up(self, fn: Callable[[], Any]) -> Any:
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream().wait_stream(side)
        return out

    def capture(self, fn: Callable[[], None]) -> torch.cuda.CUDAGraph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # for kernels()
        collecting = gc.isenabled()
        gc.disable()  # torch.cuda.graph collects once, before it begins
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=_side_stream(),
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        return graph

    @staticmethod
    def kernels(graph: torch.cuda.CUDAGraph) -> Counter:
        return graph_kernels(graph.raw_cuda_graph())


class _Entry(NamedTuple):
    inputs: Tensors
    outputs: Tensors
    graph: Any


class ChunkGraphs:
    """Graphs of one body, keyed by signature (see the module docstring).

    ``backend`` supplies ``warm_up(fn)``, ``capture(fn) -> graph`` (with
    ``graph.replay()``) and ``kernels(graph)`` (its kernel launches by name,
    asked once per graph while :data:`replayed_kernels` counts):
    :class:`CudaGraphs` unless a test passes a stand-in. ``captures``,
    ``replays`` and ``capture_seconds`` (host seconds spent capturing,
    warm-up excluded) count this object's work.
    """

    def __init__(self, body: Callable[[Tensors, Any], Tensors],
                 backend=None):
        self.body = body
        self.backend = CudaGraphs() if backend is None else backend
        self._entries: Dict[tuple, _Entry] = {}
        self._kernels: Dict[tuple, Counter] = {}
        self._bound: tuple = ()
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def __call__(self, inputs: Tensors, bound: Any = (),
                 tag: tuple = ()) -> Tensors:
        where = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for t in tree_leaves(bound))
        if where != self._bound:
            self._entries.clear()
            self._kernels.clear()
            self._bound = where
        key = tag + tuple((k, tuple(v.shape), v.dtype)
                          for k, v in sorted(inputs.items()))
        entry = self._entries.get(key)
        if entry is None:
            return self._first(key, inputs, bound)
        for k, v in inputs.items():
            if v is not entry.inputs[k]:
                entry.inputs[k].copy_(v)
        entry.graph.replay()
        self.replays += 1
        if replayed_kernels is not None:
            if key not in self._kernels:
                self._kernels[key] = self.backend.kernels(entry.graph)
            replayed_kernels.update(self._kernels[key])
        return entry.outputs

    def _first(self, key, inputs: Tensors, bound) -> Tensors:
        static = {k: v.clone() for k, v in inputs.items()}
        out = self.backend.warm_up(lambda: self.body(static, bound))
        outputs = {k: static[k] if k in static else torch.empty_like(v)
                   for k, v in out.items()}

        def captured():
            for k, v in self.body(static, bound).items():
                outputs[k].copy_(v)

        t0 = time.perf_counter()
        graph = self.backend.capture(captured)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        self._entries[key] = _Entry(static, outputs, graph)
        return out
