"""Build the port's CUDA C++ kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which the kernel's module
loads with ``ctypes``. The library lands in ``kernels/build/``
(git-ignored) under a name that carries a hash of the source, the
headers beside it and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.
:func:`build_all` compiles every ``csrc/*.cu`` at once, one ``nvcc`` per
source. Nothing here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "build")

#: Files under csrc/ that a source may include.
HEADERS = (".cuh", ".h")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class Build(NamedTuple):
    path: str        # the shared library
    seconds: float   # nvcc wall time; 0.0 when an existing build was reused
    log: str         # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every header under ``csrc/`` (a source may include any of
    them) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(HEADERS))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless its library already exists. Raises
    with nvcc's output if the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return Build(out, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, name + ".cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(out, time.perf_counter() - t0,
                 (proc.stdout + proc.stderr).strip())


def sources() -> List[str]:
    """The names of every CUDA source, ``csrc/<name>.cu``."""
    return sorted(name[:-3] for name in os.listdir(CSRC)
                  if name.endswith(".cu"))


def build_all() -> Dict[str, Build]:
    """Build every source, all ``nvcc`` processes started together; raises
    with the first failing source's output."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        builds = list(pool.map(build, names))
    return dict(zip(names, builds))
