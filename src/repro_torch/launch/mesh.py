"""Meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions (``("data", "model")``, or ``("pod", "data", "model")``) over
the ranks of the world, one process per card. The port's engine never
hands tensors to DTensor: it reads the mesh's process groups
(``mesh.get_group("data")``) and runs explicit collectives on local
tensors, so the hand-written kernels and the CUDA-graph capture see plain
tensors.

The world comes from the environment under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).
Without it a constructor starts a world of one itself:
``init_process_group`` on ``tcp://127.0.0.1:<a free port>``, rank 0,
world 1. ``device="cuda"`` (the default) runs NCCL and raises where there
is no card or no NCCL; ``device="cpu"`` runs gloo. Nothing drops to gloo
or to the CPU by itself.

Every process group gets :data:`TIMEOUT`, so ranks that diverge fail
instead of waiting for ever. Beside the mesh's groups there is one gloo
group over the whole world, :func:`host_group`, for decisions the host
takes (the preemption flag): reducing them there never waits on the card.
It is made at its first use, by every rank at once.

:func:`start_fake_world` starts a world of many ranks in one process:
rank 0 of ``torch.distributed``'s ``fake`` backend, whose collectives
return at once and move nothing. A mesh over it has every group and
coordinate of rank 0 of the real world, on either device; it is what the
dry run (:mod:`repro_torch.launch.dryrun`) builds its cells on, with fake
tensors. A process holds one world, so a fake one runs in a process of
its own.
"""
from __future__ import annotations

import os
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distrib.collectives import TIMEOUT

#: JAX's production shapes and axis names (``make_production_mesh``).
PRODUCTION_SHAPES: Dict[bool, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_HOST_GROUP: list = []  # [the world's gloo group], made at first use


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_fake_world() -> bool:
    """Whether the running world is a :func:`start_fake_world` one."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def start_fake_world(world_size: int) -> None:
    """Start a world of ``world_size`` ranks in this process, as rank 0 of
    the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``):
    every group forms, every collective returns at once and moves
    nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a world is running already: a fake world needs "
                           "a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))


def _device_type(device) -> str:
    kind = torch.device(device).type
    if is_fake_world() and kind in _BACKEND:
        return kind
    if kind not in _BACKEND:
        raise ValueError(f"meshes run on cuda (NCCL) or cpu (gloo), not "
                         f"{device!r}")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a card: torch.cuda is not "
                               "available (pass device='cpu' for gloo)")
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, and this PyTorch "
                               "has none")
    return kind


def world_size() -> int:
    """The size of the running world, else the one the environment
    describes (1 outside ``torchrun``)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def ensure_world(device="cuda") -> None:
    """Start the world if it is not up: from ``torchrun``'s environment,
    else a world of one on a free local port. A running world must have
    the backend ``device`` needs."""
    kind = _device_type(device)
    backend = _BACKEND[kind]
    if is_fake_world():
        return
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the running world uses {have}; a {kind} "
                               f"mesh needs {backend}")
    else:
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=TIMEOUT)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                rank=0, world_size=1, timeout=TIMEOUT)


def host_group():
    """The gloo group over the whole world (host-side flags): the world
    itself under gloo, else one made at the first call, which every rank
    makes at the same point."""
    if not dist.is_initialized():
        raise RuntimeError("no world is running: build a mesh first")
    if not _HOST_GROUP:
        _HOST_GROUP.append(dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo",
                                               timeout=TIMEOUT))
    return _HOST_GROUP[0]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the world's
    ranks in order (rank = the row-major index of its coordinate), each
    dimension's groups made with :data:`TIMEOUT`. Raises ``ValueError``
    when the world has another number of ranks than the shape."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         "in length")
    need = 1
    for s in shape:
        need *= s
    have = world_size()
    if have != need:
        raise ValueError(f"a {shape} mesh over {names} needs {need} ranks; "
                         f"the world has {have}")
    ensure_world(device)
    kind = _device_type(device)
    ranks = torch.arange(need).reshape(shape)
    me = dist.get_rank()
    groups = []
    for dim in range(len(shape)):
        mine = None
        # every rank makes every group, in the same order
        for row in ranks.movedim(dim, -1).reshape(-1, shape[dim]).tolist():
            group = dist.new_group(row, timeout=TIMEOUT, backend=None
                                   if is_fake_world() else _BACKEND[kind])
            if me in row:
                mine = group
        groups.append(mine)
    return DeviceMesh.from_group(groups, kind, mesh=ranks,
                                 mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, *, device="cuda"):
    """JAX's production meshes: ``(16, 16)`` over ``("data", "model")``,
    or ``(2, 16, 16)`` over ``("pod", "data", "model")``. Raises
    ``ValueError`` unless the world has 256 (512) ranks."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, names, device)


def make_smoke_mesh(n_devices: int = 1, *, device="cuda"):
    """Single-host mesh for tests: ``(1, n)`` data x model."""
    return make_mesh((1, n_devices), ("data", "model"), device)


def make_data_parallel_mesh(n_devices: Optional[int] = None, *,
                            device="cuda"):
    """``(n, 1)`` data x model over the world (``n`` defaults to its size):
    batches split over ``data``, parameters replicated (``clax_param_rule``
    shards nothing over a ``model`` axis of one). The mesh every
    ``--data-parallel`` run uses."""
    n = world_size() if n_devices is None else int(n_devices)
    return make_mesh((n, 1), ("data", "model"), device)
