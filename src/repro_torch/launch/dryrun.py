"""Dry run: build every (arch, shape) cell for one rank of the production
mesh and count what that rank's step dispatches (port of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch deepfm --shape train_batch
    python -m repro_torch.launch.dryrun --all --extra --both-meshes
    python -m repro_torch.launch.dryrun --all --extra --device cpu

(with ``src`` on ``PYTHONPATH``).

JAX forces 512 host devices, lowers and compiles each cell on
``make_production_mesh`` and reads XLA's memory and cost analyses. The port
runs the cell instead, once, for rank 0 of a fake world
(:func:`~repro_torch.launch.mesh.start_fake_world`: 256 ranks, or 512 with
``--multi-pod``) under ``FakeTensorMode``, so nothing is allocated and no
collective moves a byte, and counts it with
:class:`~repro_torch.launch.op_cost.OpCounter`: dot flops, bytes of every
op, JAX's ring-model wire bytes per collective and the peak of live
bytes, all per device. ``--device cuda`` (the default, on a card) makes
the tensors fake CUDA tensors, so each kernel the card would run is met
as the registered op it is (``repro_torch::<name>``, counted by
:mod:`repro_torch.kernels.cost`) and none is launched; ``--device cpu``
counts the plain routes, which is how the tests run it.

One JSON per cell goes to ``<out>/{arch}__{shape}__{mesh}.json`` in JAX's
layout, with ``build_seconds`` / ``count_seconds`` in place of the lower
and compile seconds, the ``device``, and ``kernel_ops`` (each kernel op's
count, flops and bytes). ``memory`` holds the arguments' bytes and the
peak of live bytes (the step updates its state in place, so JAX's output
and alias bytes have no counterpart; ``temp`` is the peak less the
arguments).

A process holds one world, so each mesh's cells run in worker processes of
their own (``--jobs`` of them a mesh), each starting its fake world.
``--cells arch:shape,...`` names the cells to run, and ``--mesh DxM`` a
``(data, model)`` mesh of D x M ranks in place of the production one (the
smoke's world of one: ``--mesh 1x1``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}

_MESHES: Dict[Tuple[str, str], object] = {}


def mesh_shape(name: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """A mesh name's shape and axis names: the production meshes, or
    ``DxM`` over ``(data, model)``."""
    from repro_torch.launch.mesh import PRODUCTION_SHAPES

    for multi_pod, mesh_name in MESH_NAMES.items():
        if name == mesh_name:
            return PRODUCTION_SHAPES[multi_pod]
    d, m = (int(x) for x in name.split("x"))
    return (d, m), ("data", "model")


def world_size(name: str) -> int:
    n = 1
    for s in mesh_shape(name)[0]:
        n *= s
    return n


def _mesh(name, device: str):
    """The mesh ``name`` (a production flag or name, or ``DxM``) over the
    running fake world, made once a process with its groups over every set
    of axes (host bookkeeping on real rank tensors, which must not run
    under the fake mode)."""
    import itertools

    from repro_torch.distrib.collectives import axes_group
    from repro_torch.launch.mesh import make_mesh

    if isinstance(name, bool):
        name = MESH_NAMES[name]
    key = (name, device)
    if key not in _MESHES:
        mesh = make_mesh(*mesh_shape(name), device=device)
        names = tuple(mesh.mesh_dim_names)
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                axes_group(mesh, axes)
        _MESHES[key] = mesh
    return _MESHES[key]


def run_cell(arch: str, shape: str, mesh_name, out_dir: str,
             device: str = "cuda") -> dict:
    """Build and count one cell on ``mesh_name`` (``multi_pod`` as a flag,
    or a name) over the running fake world; write and return its
    record."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import registry
    from repro_torch.launch.op_cost import OpCounter

    if isinstance(mesh_name, bool):
        mesh_name = MESH_NAMES[mesh_name]
    mesh = _mesh(mesh_name, device)
    t0 = time.time()
    with FakeTensorMode():
        cell = registry.build_cell(arch, shape, mesh)
        t_build = time.time() - t0
        counter = OpCounter()
        counter.track(cell.args)
        arguments = counter.live
        with counter, (torch.no_grad() if cell.kind != "train"
                       else contextlib.nullcontext()):
            cell.fn(*cell.args)
        t_count = time.time() - t0 - t_build
    walk = counter.result()
    peak = walk["peak_bytes"]
    record = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "kind": cell.kind, "notes": cell.notes,
        "model_flops": cell.model_flops,
        "device": device,
        "build_seconds": round(t_build, 2),
        "count_seconds": round(t_count, 2),
        "memory": {
            "argument_bytes_per_device": arguments,
            "temp_bytes_per_device": peak - arguments,
            "peak_bytes_per_device": peak,
        },
        "cost": {
            "flops_per_device": walk["flops"],
            "bytes_accessed_per_device": walk["bytes"],
            "unknown_trip_loops": walk["unknown_trip_loops"],
        },
        "collectives": {
            "wire_bytes_per_device": walk["collective_ops"],
            "total_wire_bytes_per_device": walk["collective_wire_bytes"],
            "op_counts": walk["collective_counts"],
        },
        "kernel_ops": walk["kernel_ops"],
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(f"[dryrun] OK {arch} x {shape} x {mesh_name}: "
          f"peak={peak / 2**30:.2f}GiB/dev "
          f"flops={walk['flops']:.3e}/dev "
          f"wire={walk['collective_wire_bytes'] / 2**20:.1f}MiB/dev "
          f"kernels={_counts(walk['kernel_ops'])} "
          f"(build {t_build:.1f}s count {t_count:.1f}s)", flush=True)
    return record


def _counts(kernel_ops) -> Dict[str, int]:
    return {k: v["count"] for k, v in kernel_ops.items()}


def _worker(cells: List[Tuple[str, str]], mesh_name: str, out_dir: str,
            device: str) -> int:
    """Start this process's fake world and run ``cells`` on it; the
    number of cells that failed."""
    from repro_torch.launch.mesh import start_fake_world

    start_fake_world(world_size(mesh_name))
    failures = 0
    for arch, shape in cells:
        try:
            run_cell(arch, shape, mesh_name, out_dir, device)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures += 1
            print(f"[dryrun] FAIL {arch} x {shape} x {mesh_name}: "
                  f"{e!r}", flush=True)
            traceback.print_exc()
    return failures


def run(cells: List[Tuple[str, str]], meshes: List[str], out_dir: str,
        device: str = "cuda", jobs: int = 1,
        timeout: Optional[float] = None) -> int:
    """Run ``cells`` on each of ``meshes`` (mesh names) in worker
    processes, ``jobs`` a mesh, the cells dealt round-robin; returns the
    number of workers that failed."""
    procs = []
    for name in meshes:
        for j in range(max(1, jobs)):
            mine = cells[j::max(1, jobs)]
            if not mine:
                continue
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--worker", "--out", out_dir, "--device", device,
                 "--mesh", name,
                 "--cells", ",".join(f"{a}:{s}" for a, s in mine)]))
    deadline = None if timeout is None else time.time() + timeout
    failed = 0
    for p in procs:
        try:
            rc = p.wait(None if deadline is None
                        else max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = -9
        failed += 1 if rc else 0
    return failed


def summarize(out_dir: str, hbm_bytes: float = 80e9) -> str:
    """A markdown table of the records in ``out_dir``: per cell, and per
    mesh, the flops, bytes and wire per device, the peak in GB and whether
    it fits one card of ``hbm_bytes``."""
    records: Dict[Tuple[str, str], Dict[str, dict]] = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                rec = json.load(f)
            records.setdefault((rec["arch"], rec["shape"]), {})[
                rec["mesh"]] = rec
    meshes = sorted({m for r in records.values() for m in r})
    head = "| cell | " + " | ".join(
        f"{m}: flops / bytes / wire per device, peak GB, fits"
        for m in meshes) + " |"
    lines = [head, "| --- |" + " --- |" * len(meshes)]
    for (arch, shape), by_mesh in records.items():
        cols = []
        for m in meshes:
            rec = by_mesh.get(m)
            if rec is None:
                cols.append("missing")
                continue
            peak = rec["memory"]["peak_bytes_per_device"]
            cols.append(
                f"{rec['cost']['flops_per_device']:.3g} / "
                f"{rec['cost']['bytes_accessed_per_device']:.3g} / "
                f"{rec['collectives']['total_wire_bytes_per_device']:.3g}, "
                f"{peak / 1e9:.2f}, {'yes' if peak <= hbm_bytes else 'no'}")
        lines.append(f"| {arch} {shape} | " + " | ".join(cols) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--extra", action="store_true",
                    help="also run the paper-own CLAX cells")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device: cuda counts the kernel "
                         "ops the card runs, cpu the plain routes")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes per mesh")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds before the workers are killed")
    ap.add_argument("--cells", help="arch:shape,... (in place of --arch "
                    "and --shape)")
    ap.add_argument("--mesh", help="a (data, model) mesh DxM in place of "
                    "the production mesh, e.g. 1x1")
    ap.add_argument("--summarize", metavar="DIR",
                    help="print a markdown table of DIR's records and exit")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.summarize:
        print(summarize(args.summarize))
        return 0

    from repro_torch.configs import registry

    if args.cells:
        cells = [tuple(c.split(":", 1)) for c in args.cells.split(",")]
    elif args.all:
        cells = registry.list_cells(include_extra=args.extra)
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, --cells, or --all")
    if args.mesh:
        meshes = [args.mesh]
    elif args.both_meshes:
        meshes = [MESH_NAMES[False], MESH_NAMES[True]]
    else:
        meshes = [MESH_NAMES[args.multi_pod]]
    if args.worker:
        return 1 if _worker(cells, meshes[0], args.out, args.device) else 0
    failed = run(cells, meshes, args.out, args.device, args.jobs,
                 args.timeout)
    if failed:
        print(f"[dryrun] {failed} worker(s) reported failures")
        return 1
    print(f"[dryrun] all {len(cells) * len(meshes)} cells counted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
