"""The port stands alone: nothing under src/repro_torch/ nor chip_smoke.py
(nor the port's scripts under scripts/) imports JAX or the JAX package
``repro``.

A subprocess blocks ``jax`` and ``repro`` in ``sys.modules`` and imports every
module of the port plus chip_smoke.py; a static scan finds no such import
statement in their sources either (the scan also covers imports inside
functions, which run only on the GPU).
"""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.MULTILINE)


def _sources():
    for dirpath, _, names in os.walk(PKG):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    scripts = os.path.join(ROOT, "scripts")
    for name in sorted(os.listdir(scripts)) if os.path.isdir(scripts) else ():
        if name.endswith(".py"):
            yield os.path.join(scripts, name)


def test_no_jax_or_repro_import_statement_in_the_port():
    offenders = {}
    for path in _sources():
        with open(path) as f:
            hits = _FORBIDDEN.findall(f.read())
        if hits:
            offenders[os.path.relpath(path, ROOT)] = hits
    assert not offenders


def test_every_port_module_imports_with_jax_and_repro_blocked():
    script = r"""
import importlib, os, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None  # any import of them now raises ImportError
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script, ROOT],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 25
