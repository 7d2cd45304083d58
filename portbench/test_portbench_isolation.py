"""Nothing under ``portbench/`` imports JAX or the JAX package ``repro``,
and neither the plain references nor the yardstick import anything of the
port (``repro_torch``). Imports are compared by their whole top-level
name, since ``repro_torch`` begins with ``repro``."""
import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: Modules that make up the yardstick and the references: no port at all.
STANDALONE = ("references", "yardstick")


def _sources():
    for dirpath, dirs, names in os.walk(HERE):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = list(_sources())


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_or_jax_package_import(path):
    assert not _top_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES
             if os.path.relpath(p, HERE).split(os.sep)[0] in STANDALONE],
    ids=lambda p: os.path.relpath(p, HERE))
def test_yardstick_and_references_stand_apart_from_the_port(path):
    assert "repro_torch" not in _top_imports(path)


def test_a_run_loads_no_jax_with_the_package_blocked():
    """The harness, its loops and readers import with ``jax``, ``jaxlib``
    and ``repro`` blocked, and leave none of them loaded."""
    script = r"""
import sys
for name in ("jax", "jaxlib", "flax", "repro"):
    sys.modules[name] = None
sys.path[:0] = [sys.argv[1]]
import run
run.prepare()
import importlib, os
for sub in ("loops", "references", "yardstick"):
    for f in sorted(os.listdir(os.path.join(sys.argv[1], sub))):
        if f.endswith(".py") and f != "__init__.py":
            importlib.import_module(sub + "." + f[:-3])
for f in sorted(os.listdir(os.path.join(sys.argv[1], "metrics"))):
    run._reader(f[:-3])
import repro_torch.configs.clax_baidu, repro_torch.train
for k in ("jax", "jaxlib", "flax", "repro"):
    del sys.modules[k]
assert run.forbidden_modules() == [], run.forbidden_modules()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script, HERE],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_forbidden_names_are_matched_whole():
    import repro_torch  # noqa: F401 - loaded, as in a run
    import run

    assert "repro" not in [n for n in run.forbidden_modules()
                           if n == "repro_torch"]
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
