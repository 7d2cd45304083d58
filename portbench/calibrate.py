"""Readings for the limits of ``correct``: the program's on many seeds and
the control's, each cell's in one process.

    python3 portbench/calibrate.py --workload clax-dbn-baidu.train \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 1

For each of ``--seeds`` the cell runs as ``run.py`` runs it (with a short
window) and its gaps are printed. For each of ``--control-seeds`` the
control is read: the plain reference computed in bfloat16, put in the
program's place, on the same inputs a run compares (the check's steps, or
``sample_calls`` served batches), and judged against the float64
reference; a loop that defines ``control(cell, seed, device)`` reads its
own. For each of ``--fault-seeds`` (training cells) the fault of
half of each batch left out is read the same way: the reference over the
first half of each batch's sessions in the program's place. One JSON line
each on standard output, also appended to ``--out``. The benchmark's own
runs never run the control or the fault.
"""
import argparse
import importlib
import json
import os
import sys
import time

import run


def control(cell, seed: int, device="cuda"):
    """The control's gaps on ``seed``'s inputs: those of the cell's loop's
    own ``control(cell, seed, device)`` where its module has one (the loop
    of another model family), else the click models'."""
    import torch

    from loops import serve_bulk, train
    from yardstick import check, inputs

    loop = importlib.import_module(f"loops.{cell.traffic['loop']}")
    if hasattr(loop, "control"):
        return loop.control(cell, seed, device)
    pool = inputs.make_pool(cell.config, cell.traffic, seed)
    if cell.traffic["loop"] == "train":
        batches = train.check_batches(pool, cell.traffic, seed)
        want = check.train_reference(cell.config, seed, batches,
                                     torch.float64, device)
        got = check.train_reference(cell.config, seed, batches,
                                    torch.bfloat16, device)
        return check.train_gaps(got, want)
    gap = 0.0
    batches = serve_bulk.served_batches(pool, cell.traffic)
    for batch in batches[:cell.traffic["sample_calls"]]:
        want = check.serve_reference(cell.config, seed, batch,
                                     torch.float64, device)
        got = check.serve_reference(cell.config, seed, batch,
                                    torch.bfloat16, device)
        gap = max(gap, check.logp_gap(got.astype("float32"), want))
    return {"logp_gap": gap}


def half_batch(cell, seed: int, device="cuda"):
    """The fault of half of each batch left out, the mean taken over the
    rest: the reference so, in the program's place."""
    import torch

    from loops import train
    from yardstick import check, inputs

    pool = inputs.make_pool(cell.config, cell.traffic, seed)
    batches = train.check_batches(pool, cell.traffic, seed)
    want = check.train_reference(cell.config, seed, batches, torch.float64,
                                 device)
    halves = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    got = check.train_reference(cell.config, seed, halves, torch.float64,
                                device)
    return check.train_gaps(got, want)


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.prepare()
    from yardstick import spec

    cell = spec.load_cell(args.workload)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in args.seeds:
        t0 = time.perf_counter()
        result, _ = run.execute(cell, seed, args.seconds, False,
                                t_process=t0)
        emit({"workload": cell.name, "seed": seed, "side": "program",
              "correct": result["correct"],
              "gaps": {k: c["value"] for k, c in result["checks"].items()},
              "metrics": {k: m["value"] for k, m in
                          result["metrics"].items()},
              "seconds": time.perf_counter() - t0})
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        emit({"workload": cell.name, "seed": seed, "side": "control",
              "gaps": control(cell, seed),
              "seconds": time.perf_counter() - t0})
    if cell.traffic["loop"] == "train":
        for seed in args.fault_seeds:
            t0 = time.perf_counter()
            emit({"workload": cell.name, "seed": seed, "side": "half_batch",
                  "gaps": half_batch(cell, seed),
                  "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
