"""Time ``sparse_adamw`` of two or more checkouts of the port on one card,
in turns, and hold their parameters and moments to each other's bits.

    python3 scripts/sparse_adamw_trees.py --out DIR TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive``, say into ``.archive/parent``). Each runs in
a process of its own, in the order given (``parent . . parent`` compares
two designs twice, each in turn), with ``PYTHONPATH=TREE/src``, so every
process builds and calls its own tree's kernel. Each process makes the same
inputs: one table of the paper-width DBN (214,748,672 x 1 float32 rows, as
``chip_smoke.py``'s optimizer phase) and the 655,360 ids of the first batch
of its synthetic log, hashed into the table and deduped. It reports, by
CUDA-graph replay (warm L2, and cold after a 512 MB write whose own time is
taken out):

* ``every_slot``: the per-slot form over every slot, which every tree has;
* ``route``: the tree's single-device engine route for one table: the
  slot-wide ``index_select`` of the table gradient then the per-slot form,
  or, where the kernel takes the table gradient and a span, that form over
  the dedupe's span;
* where the tree has them, ``per_slot_span`` (the per-slot form over the
  live run ``live_span`` finds) and ``table_grad`` (the engine's form).

It writes each process's touched rows of p, m and v after two steps of the
per-slot form to ``DIR/<i>.pt``, and fails (exit 1) unless every tree's
are equal to the first tree's to the bit, every untouched row is left as
it was and every form of a tree gives its per-slot form's bits. The last
line of its output is one JSON object with each run's times and checks.
Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

DBN_ROWS = 214_748_672      # configs/clax_baidu.py: 2^31 ids hashed 10x
B_MAIN, K_MAIN = 65536, 10
SLOTS = B_MAIN * K_MAIN
KW = dict(lr=3e-3, weight_decay=1e-4)


def graph_ms(fn, calls=20, replays=10, before=None):
    """Device ms of one ``fn()``: ``calls`` calls captured in one CUDA
    graph (each after ``before()``, when given), replayed ``replays``
    times."""
    import torch

    def body():
        if before is not None:
            before()
        fn()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            body()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def child(out_path: str) -> dict:
    """The runs of the tree on ``PYTHONPATH``: see the module's text."""
    import torch

    from repro_torch.core.parameterization import hash_ids
    from repro_torch.data import SyntheticConfig, generate_click_log
    from repro_torch.kernels import sparse_adamw_cuda
    from repro_torch.optim import sparse as sparse_lib

    device = torch.device("cuda")
    # the ids of chip_smoke.py's optimizer phase: the first batch of the
    # DBN's synthetic log, hashed into the table; row 0 untouched, R-1 not
    cfg = SyntheticConfig(n_sessions=17 * B_MAIN,
                          n_queries=17 * B_MAIN // 100, docs_per_query=20,
                          positions=K_MAIN, behavior="dbn", seed=0)
    log, _ = generate_click_log(cfg)
    ids = hash_ids(torch.from_numpy(
        log["query_doc_ids"][:B_MAIN].reshape(-1)).to(device), DBN_ROWS)
    ids = torch.where(ids == 0, 1, ids)
    ids[0] = DBN_ROWS - 1
    rows = sparse_lib.unique_rows_with_sentinel(ids, DBN_ROWS)
    live = int((rows < DBN_ROWS).sum())
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    before = torch.randn(DBN_ROWS, 1, generator=gen, device=device) * 0.5
    row_grads = torch.randn(SLOTS, 1, generator=gen, device=device)
    d_table = torch.zeros(DBN_ROWS, 1, device=device)
    d_table[rows[:live]] = row_grads[:live]
    params = inspect.signature(sparse_adamw_cuda).parameters
    forms = {"every_slot": (row_grads, {})}
    route_form = None
    if "span" in params and "table_grad" in params:
        whole = torch.tensor([0, DBN_ROWS], dtype=torch.int64, device=device)
        _, dedupe_span = sparse_lib.unique_rows_with_sentinel(
            ids, DBN_ROWS, return_span=True)
        forms["per_slot_span"] = (row_grads, dict(
            span=sparse_lib.live_span(rows, whole)))
        forms["table_grad"] = (d_table, dict(span=dedupe_span,
                                             table_grad=True))
        route_form = "table_grad"

    def run(grads, extra, steps=2):
        t = before.clone()
        st = sparse_lib.init_sparse_table_state(t)
        for _ in range(steps):
            st.count.add_(1)
            sparse_adamw_cuda(t, st.mu, st.nu, rows, grads, st.count,
                              **KW, **extra)
        return t, st

    t, st = run(row_grads, {})
    touched = torch.zeros(DBN_ROWS, dtype=torch.bool, device=device)
    touched[rows[:live]] = True
    checks = {"untouched_rows_unchanged": bool(
        torch.equal(t[~touched], before[~touched])
        and (st.mu[~touched] == 0).all() and (st.nu[~touched] == 0).all())}
    at = rows[:live]
    torch.save({"p": t[at].cpu(), "m": st.mu[at].cpu(),
                "v": st.nu[at].cpu()}, out_path)
    for form, (grads, extra) in forms.items():
        if form != "every_slot":
            tf, sf = run(grads, extra)
            checks[f"{form}_bits_equal_every_slot"] = bool(
                torch.equal(tf, t) and torch.equal(sf.mu, st.mu)
                and torch.equal(sf.nu, st.nu))
            del tf, sf
    del t, st
    torch.cuda.empty_cache()

    t = before.clone()
    st = sparse_lib.init_sparse_table_state(t)
    st.count.add_(1)

    def call(form):
        grads, extra = forms[form]
        return lambda: sparse_adamw_cuda(t, st.mu, st.nu, rows, grads,
                                         st.count, **KW, **extra)

    def parent_route():  # the slot-wide gather, then every slot walked
        d = torch.index_select(d_table, 0,
                               torch.clamp(rows, max=DBN_ROWS - 1))
        sparse_adamw_cuda(t, st.mu, st.nu, rows, d, st.count, **KW)

    timed = {form: call(form) for form in forms}
    timed["route"] = call(route_form) if route_form else parent_route
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device=device)
    flush_ms = graph_ms(lambda: flush.add_(1))
    device_ms = {name: graph_ms(fn) for name, fn in timed.items()}
    cold_ms = {name: graph_ms(fn, before=lambda: flush.add_(1)) - flush_ms
               for name, fn in timed.items()}
    return {"live": live, "forms": sorted(forms), "device_ms": device_ms,
            "cold_ms": cold_ms, "checks": checks,
            "launches": sparse_adamw_cuda.launches}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", required=True)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sparse_adamw_trees: no CUDA card", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.out)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        out = os.path.join(os.path.abspath(args.out), f"{i}.pt")
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--out",
             out], cwd=root, env=env, capture_output=True, text=True)
        sys.stderr.write(done.stderr[-4000:])
        if done.returncode != 0:
            print(json.dumps({"tree": tree, "rc": done.returncode}))
            return 1
        run = json.loads(done.stdout.strip().splitlines()[-1])
        run.update(tree=tree, out=out)
        print(json.dumps(run), flush=True)
        runs.append(run)
    first = torch.load(runs[0]["out"])
    ok = True
    for run in runs:
        got = torch.load(run["out"])
        run["bits_equal_first_tree"] = all(
            torch.equal(got[k], first[k]) for k in ("p", "m", "v"))
        ok &= run["bits_equal_first_tree"] and all(run["checks"].values())
    print(card())
    print(json.dumps({"ok": ok, "runs": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
