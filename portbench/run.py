"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload clax-dbn-baidu.serve_bulk --seed 7 \
        --seconds 51 --trace 0

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) is set up from
the seed, measured for ``--seconds`` and then checked against the plain
reference. The numbers that decide ``correct`` are printed beside their
limits as the last lines of standard error, and one JSON object is the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Without a card, or with fewer cards than the cell asks for,
it prints no result and exits with 2; if JAX or the JAX package was
loaded, with 3. See README.md.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Compile and build caches of the program, at fixed paths in the checkout.
CACHE = os.path.join(ROOT, ".portbench_cache")


def prepare() -> None:
    """The harness and the port on the import path; Triton's and
    PyTorch's extension caches inside the checkout."""
    for path in (os.path.join(ROOT, "src"), HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")


def forbidden_modules():
    """The forbidden top-level names among the modules loaded."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer(cell, ctx):
    """The cell's per-layer metrics that their readers found, by name."""
    out = {}
    for name, unit in cell.per_layer:
        value = _reader(name)(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit}
    return out


def _finite(x):
    """A number as JSON has it: a gap that is no number reads null."""
    return float(x) if math.isfinite(x) else None


def execute(cell, seed: int, seconds: float, trace: bool, device="cuda",
            builder=None, t_process=None):
    """Run the cell's loop; returns ``(result, check_lines)``: the result
    line's object and the lines of the numbers beside their limits."""
    import torch

    from yardstick import check

    loop = importlib.import_module(f"loops.{cell.traffic['loop']}")
    outcome = loop.run(cell, seed, seconds, trace, device=device,
                       builder=builder, t_process=t_process)
    correct, checks = check.judge(outcome.gaps, cell.limits)
    if trace:
        metrics = per_layer(cell, outcome.ctx)
    else:
        metrics = {name: {"value": float(outcome.e2e[name]), "unit": unit}
                   for name, unit in cell.end_to_end}
    cuda = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": bool(correct and outcome.failed == 0),
              "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": info}
    tr = outcome.ctx.get("trace")
    if trace and tr is not None:
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": _finite(c["value"]),
                               "limit": c["limit"]}
                        for name, c in checks.items()}
    parts = ", ".join(f"{k} {v:.2f}" for k, v in outcome.setup_parts.items())
    lines = [f"setup_s parts: {parts}"]
    lines += [f"check {name} {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
             for name, c in checks.items()]
    lines.append(f"correct {str(result['correct']).lower()} (failed "
                 f"{result['failed']} of {result['attempted']})")
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    prepare()
    from yardstick import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {found}; no result", file=sys.stderr)
        return 2
    try:
        result, lines = execute(cell, args.seed, args.seconds,
                                bool(args.trace), t_process=T_PROCESS)
    except Exception:  # noqa: BLE001 - the run failed: no result line
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
