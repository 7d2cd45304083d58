"""The port's dry run (``launch/dryrun.py``, ``launch/op_cost.py``, every
config's ``build_cell``) against JAX's (``launch/dryrun.py``,
``launch/hlo_cost.py``), on the CPU.

JAX runs in one subprocess with ``--xla_force_host_platform_device_count
=256``: it builds all 43 cells of its registry on ``(16, 16)`` (without
compiling) for their ``model_flops``, and compiles a set of cells on
``(1, 1)`` and ``(2, 4)`` for ``analyze_hlo``'s walk. The port runs in
subprocesses of its own, each on a fake world (256, 1 and 8 ranks) with
fake CPU tensors, so every kernel takes its plain route. Held:

* the counter on a synthetic step, exactly (JAX's
  ``test_hlo_cost_walker_on_synthetic_module``);
* ``model_flops`` equal to JAX's for every cell at FULL width;
* dot flops per device at 1e-6 relative where both count the same
  products, else at the ratio named in :data:`RATIOS` within 1%;
* the ``clax-*`` cells' collective wire (the gradient all-reduce over
  ``data``) within 1%; the other cells' wire is printed beside JAX's, with
  no hold (XLA's collectives are GSPMD's choice, the port's its explicit
  ones);
* the CLI writing JAX's record layout;
* each kernel's registered op meeting its fake form under a
  ``FakeTensorMode`` (the output's shape and type, no launch), and
  ``kernels/cost.py`` giving every bound of PERF.md's kernel table.

The LM cells take llama3.2-1b's reduced config with a 4,096-row attention
chunk on both sides (the same products as its 16-row chunk, in fewer
dispatched ops).
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

#: The walked cells: (key, mesh) pairs held against JAX.
MESHES = ("1x1", "2x4")
WALKED = ("lm|train_4k", "lm|prefill_32k", "lm|decode_32k",
          "deepfm|train_batch", "bst|train_batch", "graphsage|full_graph_sm",
          "clax-dbn|train_batch")

#: port / JAX dot flops where they differ, by (cell, mesh), and why.
#: * DeepFM: XLA turns the last Dense's (B, 16) x (16, 1) forward product
#:   into an elementwise multiply and reduce, which is no dot (2 x 16 flops
#:   an example).
#: * BST: the same product, and the port's ``flash_attention`` backward
#:   recomputes the forward's two attention products (2 x 2 H S^2 Dh =
#:   1,568 flops an example), where JAX's autodiff of its XLA form keeps
#:   them: 1,600 an example in all.
#: * The LM on (2, 4): reduced llama has 2 KV heads, which a ``model`` axis
#:   of 4 splits mid-head, so the port gathers q, k and v over ``model``
#:   and every model rank runs every head (``models/lm/sharded.py``),
#:   where GSPMD keeps each rank's share; attention dominates these
#:   shapes, so the port's count is nearly 4x.
RATIOS = {
    ("deepfm|train_batch", "1x1"): 308281344 / 306184192,
    ("deepfm|train_batch", "2x4"): 154140672 / 153092096,
    ("bst|train_batch", "1x1"): 2732589056 / 2627731456,
    ("bst|train_batch", "2x4"): 1366294528 / 1313865728,
    ("lm|train_4k", "2x4"): 6816113098752 / 1855425871872,
    ("lm|prefill_32k", "2x4"): 13242458177536 / 3346853527552,
    ("lm|decode_32k", "2x4"): 1617559552 / 409600000,
}

#: The reduced llama train cell with microbatches narrower than the data
#: ranks: 64 microbatches of 4 of the 256 rows over the 8 data ranks of
#: ``(8, 1)`` (JAX pads each to 8 rows, one a device; the port's ranks 4-7
#: take a masked row).
NARROW = ("lm|train_4k_narrow", "8x1")

CELL_BUILDERS = r"""
def cells(mesh, build_lm, recsys, DeepFM, BST, deepfm, bst, llama, sage,
          clax, meta):
    import dataclasses
    lm = dataclasses.replace(llama.reduced(), attn_chunk=4096)
    for s in ("train_4k", "prefill_32k", "decode_32k"):
        yield "lm|" + s, lambda s=s: build_lm(lm, s, mesh)
    for key, make, factory in (
            ("deepfm|train_batch", lambda: DeepFM(deepfm.reduced(), **meta),
             recsys.tabular_batch_factory(deepfm.reduced().n_sparse)),
            ("bst|train_batch", lambda: BST(bst.reduced(), **meta),
             recsys.sequence_batch_factory(bst.reduced().seq_len))):
        yield key, lambda m=make, f=factory, k=key: recsys.build_recsys_cell(
            m(), "train_batch", mesh, batch_factory=f, flops_per_example=1.0,
            retrieval_flops=1.0, arch_name=k)
    yield "graphsage|full_graph_sm", lambda: sage.build_cell(
        "full_graph_sm", mesh)
    yield "clax-dbn|train_batch", lambda: clax.build_cell(
        "train_batch", mesh, kind="dbn")


def narrow(mesh, build_lm, llama):
    import dataclasses
    lm = dataclasses.replace(llama.reduced(), attn_chunk=4096,
                             microbatches=64)
    return build_lm(lm, "train_4k", mesh)
"""

JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import numpy as np, jax
from jax.sharding import Mesh
from repro.compat import set_mesh
from repro.configs import (bst, clax_baidu, deepfm, graphsage_reddit,
                           llama3_2_1b, recsys_common, registry)
from repro.configs.lm_common import build_lm_cell
from repro.launch.hlo_cost import analyze_hlo
from repro.models.recsys import BST, DeepFM
""" + CELL_BUILDERS + r"""
def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

out = {"model_flops": {}, "walk": {}}
big = mesh_of((16, 16))
with set_mesh(big):
    for arch, shape in registry.list_cells(include_extra=True):
        cell = registry.build_cell(arch, shape, big)
        out["model_flops"][arch + "|" + shape] = cell.model_flops
for shape in ((1, 1), (2, 4)):
    mesh = mesh_of(shape)
    for key, build in cells(mesh, build_lm_cell, recsys_common, DeepFM, BST,
                            deepfm, bst, llama3_2_1b, graphsage_reddit,
                            clax_baidu, {}):
        with set_mesh(mesh):
            cell = build()
            hlo = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                          out_shardings=cell.out_shardings,
                          donate_argnums=cell.donate).lower(
                *cell.args).compile().as_text()
        out["walk"]["%s|%dx%d" % (key, *shape)] = analyze_hlo(hlo)
mesh = mesh_of((8, 1))
with set_mesh(mesh):
    cell = narrow(mesh, build_lm_cell, llama3_2_1b)
    hlo = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                  out_shardings=cell.out_shardings,
                  donate_argnums=cell.donate).lower(
        *cell.args).compile().as_text()
out["walk"]["lm|train_4k_narrow|8x1"] = analyze_hlo(hlo)
print(json.dumps(out))
"""

PORT_SCRIPT = r"""
import sys, json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import (bst, clax_baidu, deepfm, graphsage_reddit,
                                 llama3_2_1b, recsys_common, registry)
from repro_torch.configs.lm_common import build_lm_cell
from repro_torch.launch import dryrun, mesh as meshes
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models.recsys import BST, DeepFM
""" + CELL_BUILDERS + r"""
world = int(sys.argv[1])
meshes.start_fake_world(world)
out = {"model_flops": {}, "walk": {}}
if world == 256:
    mesh = dryrun._mesh(False, "cpu")
    with FakeTensorMode():
        for arch, shape in registry.list_cells(include_extra=True):
            cell = registry.build_cell(arch, shape, mesh)
            out["model_flops"][arch + "|" + shape] = cell.model_flops
else:
    shape = {1: (1, 1), 8: (2, 4)}[world]
    mesh = meshes.make_mesh(shape, ("data", "model"), device="cpu")
    for key, build in cells(mesh, build_lm_cell, recsys_common, DeepFM, BST,
                            deepfm, bst, llama3_2_1b, graphsage_reddit,
                            clax_baidu, {"device": "meta"}):
        with FakeTensorMode():
            cell = build()
            counter = OpCounter()
            counter.track(cell.args)
            with counter, (torch.enable_grad() if cell.kind == "train"
                           else torch.no_grad()):
                cell.fn(*cell.args)
        out["walk"]["%s|%dx%d" % (key, *shape)] = counter.result()
    if world == 8:
        mesh = dryrun._mesh("8x1", "cpu")
        with FakeTensorMode():
            cell = narrow(mesh, build_lm_cell, llama3_2_1b)
            counter = OpCounter()
            counter.track(cell.args)
            with counter, torch.enable_grad():
                cell.fn(*cell.args)
        out["walk"]["lm|train_4k_narrow|8x1"] = counter.result()
print(json.dumps(out))
"""

UNIT_SCRIPT = r"""
import json
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import start_fake_world
from repro_torch.launch.op_cost import OpCounter

start_fake_world(8)
group = dist.new_group([0, 1, 2, 3])
with FakeTensorMode():
    x, w = torch.randn(8, 16), torch.randn(16, 16)
    counter = OpCounter()
    with counter:
        for _ in range(5):
            y = x @ w
            dist.all_reduce(y, group=group)
print(json.dumps(counter.result()))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(script, *args):
    return subprocess.Popen([sys.executable, "-c", script, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env())


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's numbers, their subprocesses run at once."""
    procs = {"jax": _start(JAX_SCRIPT), "full": _start(PORT_SCRIPT, "256"),
             "1x1": _start(PORT_SCRIPT, "1"), "2x4": _start(PORT_SCRIPT, "8")}
    out = {k: _result(p) for k, p in procs.items()}
    port = {"model_flops": out["full"]["model_flops"],
            "walk": {**out["1x1"]["walk"], **out["2x4"]["walk"]}}
    return out["jax"], port


def test_op_counter_counts_a_synthetic_step_exactly():
    """Five iterations of an f32 (8, 16) @ (16, 16) and an all-reduce over
    a group of 4: 5 x 4,096 flops and 5 x 768 wire bytes."""
    got = _result(_start(UNIT_SCRIPT), timeout=120)
    assert got["flops"] == 5 * 4096
    assert got["collective_ops"]["all-reduce"] == 5 * 768
    assert got["collective_counts"]["all-reduce"] == 5
    assert got["unknown_trip_loops"] == 0


def _all_cells():
    from repro.configs import registry

    return [f"{a}|{s}" for a, s in registry.list_cells(include_extra=True)]


@pytest.mark.parametrize("cell", _all_cells())
def test_model_flops_equal_jax_on_every_cell(runs, cell):
    jax_out, port = runs
    assert len(port["model_flops"]) == len(jax_out["model_flops"]) == 43
    assert port["model_flops"][cell] == jax_out["model_flops"][cell]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cell", WALKED)
def test_dot_flops_per_device_match_jax(runs, cell, mesh):
    jax_out, port = runs
    key = f"{cell}|{mesh}"
    want, got = jax_out["walk"][key]["flops"], port["walk"][key]["flops"]
    print(f"{key}: port {got:.6e} JAX {want:.6e} wire port "
          f"{port['walk'][key]['collective_wire_bytes']:.6e} JAX "
          f"{jax_out['walk'][key]['collective_wire_bytes']:.6e}")
    ratio = RATIOS.get((cell, mesh))
    if ratio is None:
        assert got == pytest.approx(want, rel=1e-6, abs=0)
    else:
        assert got == pytest.approx(want * ratio, rel=1e-2)


def test_narrow_microbatch_cell_builds_and_matches_jax_dot_flops(runs):
    """Microbatches of 4 rows over 8 data ranks (the 405b ``train_4k``
    cell on ``pod2x16x16`` lays 16 over 32): the port's rank 0 takes one
    row a microbatch, as each of JAX's devices after GSPMD's padding, so
    its dot flops per device are JAX's, held as
    :func:`test_dot_flops_per_device_match_jax` holds them."""
    jax_out, port = runs
    key = "|".join(NARROW)
    want, got = jax_out["walk"][key]["flops"], port["walk"][key]["flops"]
    print(f"{key}: port {got:.6e} JAX {want:.6e}")
    assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_clax_gradient_wire_matches_jax(runs, mesh):
    """The DBN's only collectives are the data axis's sums (the loss weight,
    the gradients) and the lookups' sums over ``model``: the same wire as
    JAX's all-reduces, within 1%."""
    jax_out, port = runs
    key = f"clax-dbn|train_batch|{mesh}"
    want = jax_out["walk"][key]["collective_wire_bytes"]
    got = port["walk"][key]["collective_wire_bytes"]
    assert got == pytest.approx(want, rel=1e-2, abs=1.0)
    if mesh == "2x4":
        assert got > 4e8


def test_dryrun_cli_writes_jax_record_layout():
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "deepfm", "--shape", "serve_p99", "--device", "cpu", "--out",
             out], capture_output=True, text=True, env=_env(), timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(os.path.join(out, "deepfm__serve_p99__pod16x16.json")) as f:
            rec = json.load(f)
    assert rec["mesh"] == "pod16x16" and rec["device"] == "cpu"
    assert rec["kind"] == "serve" and rec["model_flops"] > 0
    assert set(rec["memory"]) >= {"argument_bytes_per_device",
                                  "peak_bytes_per_device"}
    assert rec["memory"]["peak_bytes_per_device"] >= \
        rec["memory"]["argument_bytes_per_device"] > 0
    # 512 rows over 16 data ranks, the two lookups' sums over model
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["collectives"]["op_counts"] == {"all-reduce": 2}
    assert rec["cost"]["unknown_trip_loops"] == 0
    assert rec["kernel_ops"] == {}  # the CPU's plain routes


# ---------------------------------------------------------------------------
# the kernels as registered ops, and kernels/cost.py's bounds
# ---------------------------------------------------------------------------

def _fake_calls():
    """Each registered kernel op's arguments at its main-path shape (as
    fake CPU tensors) and the output shape and type it must make."""
    import torch

    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def t(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype)

    B, K = 65536, 10
    exam = [t(B, K)] * 6
    q = t(64, 2, 39, 16)
    return {
        "examination_nll": ((exam[0], exam[1], t(B, K, dtype=torch.bool),
                             *exam[2:], [128, 512, 512, 32000]), ()),
        "session_nll": ((t(B, K), t(B, K), t(B, K, dtype=torch.bool),
                         [512, 1, 320]), ()),
        "embedding_bag": ((t(1000, 10), t(64, 39, dtype=i32), None, 8, 0),
                          (64, 10)),
        "fm_interaction": ((t(64, 39, 10),), (64,)),
        "flash_attention": ((q, q, q, False, 0.25, None), (64, 2, 39, 16)),
        "dcn_cross": ((t(64, 16), t(64, 16), t(16, 16), t(16)), (64, 16)),
        "adamw": ((t(100), t(100), t(100), t(100), t(dtype=i32), None, None,
                   None, True, 0.9, 0.999, 1e-8, 1e-4, 1e-3), ()),
        "sparse_adamw": ((t(100, 1), t(100, 1), t(100, 1), t(8, dtype=i64),
                          t(8, 1), t(dtype=i32), None, None, False, 1e-3,
                          0.9, 0.999, 1e-8, 0.0), (0,)),
    }


@pytest.mark.parametrize("name", sorted(_fake_calls()))
def test_kernel_ops_fake_forms_make_outputs_and_launch_nothing(name):
    """Under a FakeTensorMode each kernel op (``torch.ops.repro_torch``)
    meets its fake form: the output's shape and type, no launch (the CPU
    has no kernel to launch, so reaching one would raise)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.kernels  # noqa: F401  (registers the ops)

    args, shape = _fake_calls()[name]
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        out = getattr(torch.ops.repro_torch, name)(*fake)
    assert tuple(out.shape) == shape
    assert out.dtype == (torch.float64 if name.endswith("adamw")
                         else torch.float32)


def test_sparse_adamw_table_gradient_form_meets_its_fake_form_and_cost():
    """The op with a span and the table gradient (the engine's form) under
    a FakeTensorMode and the dry run's counter: no launch, the empty (0,)
    result, charged ``kernels/cost.py``'s bytes for that form (the table
    gradient's sectors in place of per-slot rows)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.kernels  # noqa: F401  (registers the ops)
    from repro_torch.kernels import cost
    from repro_torch.launch.op_cost import OpCounter

    with FakeTensorMode():
        table = torch.empty(1000, 2)
        ids = torch.empty(64, dtype=torch.int64)
        span = torch.empty(2, dtype=torch.int64)
        count = torch.empty((), dtype=torch.int32)
        counter = OpCounter()
        with counter:
            out = torch.ops.repro_torch.sparse_adamw(
                table, table, table, ids, table, count, None, None, False,
                1e-3, 0.9, 0.999, 1e-8, 0.0, span, True)
        want = cost.sparse_adamw(table, table, table, ids, table,
                                 span=span, table_grad=True)
    assert tuple(out.shape) == (0,) and out.dtype == torch.float64
    row = counter.result()["kernel_ops"]["sparse_adamw"]
    assert row["count"] == 1 and row["bytes"] == want.bytes
    # 64 slots' rows of 2 floats: 64 sectors each of p, m, v and the
    # table gradient, against the per-slot form's 64 x 8 gradient bytes
    assert want.bytes == 64 * 192 + 64 * 8 + 64 * 32


#: PERF.md's kernel table: row -> (op, its arguments' shapes and types,
#: the bound in ms at 3.35 TB/s and 67 TFLOP/s, as the table states it)
BOUNDS = {
    "examination_nll": ("examination_nll",
                        (((65536, 10), "float32"),) * 3, 0.00489),
    "session_nll": ("session_nll", (((65536, 10), "float32"),) * 3,
                    0.00176),
    "fm_interaction": ("fm_interaction", (((65536, 39, 10), "float32"),),
                       0.03060),
    "flash_attention": ("flash_attention",
                        (((65536, 2, 39, 16), "float32"),) * 3, 0.3906),
    "flash_attention_bf16": ("flash_attention",
                             (((65536, 2, 39, 16), "bfloat16"),) * 3,
                             0.1953),
    "flash_attention_bst": ("flash_attention",
                            (((65536, 8, 21, 4), "float32"),) * 3, 0.2103),
    "dcn_cross": ("dcn_cross", (((655360, 16), "float32"),
                                ((655360, 16), "float32"),
                                ((16, 16), "float32"), ((16,), "float32")),
                  0.0376),
    "adamw": ("adamw", (((2 * 214748672,), "float32"),) * 4, 3.590),
    "adamw_bf16": ("adamw", (((1498482688,), "bfloat16"),
                             ((1498482688,), "float32"),
                             ((1498482688,), "float32"),
                             ((1498482688,), "float32")), 10.74),
}


#: PERF.md's ``sparse_adamw`` rows at the DBN's first batch: one
#: (214,748,672, 1) table, 655,360 slots, 86,726 live rows in 86,603
#: sectors (``chip_smoke.py`` counts them) -> (the gradient read from the
#: table gradient, the live run's span given, the bound in ms). Every slot
#: walked reads every slot's id; the span forms read the live slots' ids.
SPARSE_BOUNDS = {"per_slot": (False, False, 0.00663),
                 "per_slot_span": (False, True, 0.00527),
                 "table_grad": (True, True, 0.00600)}


@pytest.mark.parametrize("row", sorted(SPARSE_BOUNDS))
def test_cost_reproduces_the_sparse_adamw_rows(row):
    import torch

    from repro_torch.kernels import cost

    table_grad, spanned, want = SPARSE_BOUNDS[row]
    rows, slots = 214748672, 655360
    table = torch.empty((rows, 1), device="meta")
    ids = torch.empty((slots,), dtype=torch.int64, device="meta")
    grads = table if table_grad else torch.empty((slots, 1), device="meta")
    span = torch.empty(2, dtype=torch.int64, device="meta") if spanned \
        else None
    got, by = cost.bound_ms(cost.sparse_adamw(
        table, table, table, ids, grads, span=span, table_grad=table_grad,
        sectors=86603, live=86726))
    assert by == "bytes"
    assert got == pytest.approx(want, abs=0.5e-5)


@pytest.mark.parametrize("row", sorted(BOUNDS))
def test_cost_reproduces_the_kernel_tables_bounds(row):
    """The bound of each row of PERF.md's kernel table at its stated shape
    (the data-dependent rows, ``embedding_bag`` and ``sparse_adamw``, take
    the sectors ``chip_smoke.py`` counts from its data)."""
    import torch

    from repro_torch.kernels import cost

    op, shapes, want = BOUNDS[row]
    args = [torch.empty(s, dtype=getattr(torch, d), device="meta")
            for s, d in shapes]
    got, by = cost.bound_ms(cost.COSTS[op](*args))
    assert by == "bytes"
    digits = len(str(want).split(".")[1])
    assert got == pytest.approx(want, abs=0.5 * 10 ** -digits)
    if row == "adamw":  # the DBN's two tables: 12.03 GB
        assert cost.adamw(*args).bytes == pytest.approx(12.03e9, rel=1e-3)
