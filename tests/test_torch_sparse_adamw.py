"""``sparse_adamw``'s live run and table-gradient form, on the CPU.

The kernel (``kernels/csrc/sparse_adamw.cu``) walks only the live run of
the ids (to the dedupe's count on one device; ``[start, end)`` from
``optim.sparse.live_span`` on a mesh), and reads the gradient either per
slot or from the table gradient at each live row. Its plain version takes
the same arguments, and the CPU runs it:

* the dedupe's span, ``[0, count)``, is ``live_span``'s on a whole
  table;
* the table-gradient form equals ``index_select`` of the table gradient
  followed by the per-slot form, to the bit (parameters, moments, the norm
  mode's sum), with either span and without one;
* on a row-sharded mesh's ids (sentinels on both sides of the live run),
  the span its caller computes holds exactly the live slots, and the update
  writes exactly the live rows;
* the engine's single-device sparse route (the table gradient, the count)
  gives the bits of the route before it (a slot-wide ``index_select``,
  every slot walked) over two steps, with the guard and telemetry too;
* ``launch_plan``'s grid, with the kernel's index math mirrored in numpy,
  visits every element of a run once and spreads a short run over every
  block.
"""
import numpy as np
import pytest
import torch

from repro_torch import core as tcore
from repro_torch import optim as topt
from repro_torch.kernels import sparse_adamw as ksparse
from repro_torch.kernels.sparse_adamw import sparse_adamw_plain
from repro_torch.optim.sparse import (init_sparse_table_state, live_span,
                                      unique_rows_with_sentinel)
from repro_torch.train import TrainEngine
from repro_torch.train.engine import SparseRows

KW = dict(lr=0.05, weight_decay=1e-3)


def _steps(n_rows, d, moments, ids, grads, steps, seed, **kw):
    """``steps`` plain updates from one seeded table; the table, moments and
    each step's norm sum."""
    torch.manual_seed(seed)
    table = torch.randn(n_rows, d)
    st = init_sparse_table_state(table, moments)
    sums = []
    for _ in range(steps):
        st.count.add_(1)
        sums.append(sparse_adamw_plain(table, st.mu, st.nu, ids, grads,
                                       st.count, norm=True, **KW, **kw))
    return table, st, torch.stack(sums)


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1].mu, a[1].nu, a[2]), (b[0], b[1].mu, b[1].nu, b[2])))


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3])
def test_table_gradient_form_is_the_gather_then_per_slot_form(d, moments):
    n_rows = 50
    rng = np.random.default_rng(d)
    ids, dedupe_span = unique_rows_with_sentinel(
        torch.from_numpy(rng.integers(0, n_rows, 40)), n_rows,
        return_span=True)
    assert (ids == n_rows).any()  # sentinel padding at the end
    d_table = torch.from_numpy(rng.standard_normal((n_rows, d))
                               .astype(np.float32))
    gathered = torch.index_select(d_table, 0,
                                  torch.clamp(ids, max=n_rows - 1))
    span = live_span(ids, torch.tensor([0, n_rows]))
    want = _steps(n_rows, d, moments, ids, gathered, 3, 0)
    assert torch.equal(dedupe_span, span)
    for kw in (dict(table_grad=True), dict(table_grad=True, span=span),
               dict(table_grad=True, span=dedupe_span), dict(span=span),
               dict(span=dedupe_span)):
        grads = d_table if kw.get("table_grad") else gathered
        assert _bits_equal(_steps(n_rows, d, moments, ids, grads, 3, 0,
                                  **kw), want), kw


@pytest.mark.parametrize("max_unique", [None, 8, 64])
def test_the_dedupes_count_ends_the_live_run(max_unique):
    """The span ``return_span`` adds (``[0, count)``, count the distinct
    ids, a (2,) int64 tensor; the other outputs as without it) is
    ``live_span``'s on a whole table, and every live slot lies before its
    end."""
    n_rows = 30
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, n_rows, 20))
    want_ids, want_inverse = unique_rows_with_sentinel(
        ids, n_rows, return_inverse=True, max_unique=max_unique)
    got_ids, got_inverse, span = unique_rows_with_sentinel(
        ids, n_rows, return_inverse=True, max_unique=max_unique,
        return_span=True)
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(got_inverse, want_inverse)
    assert span.shape == (2,) and span.dtype == torch.int64
    count = len(set(ids.tolist()))
    assert span.tolist() == [0, count]
    searched = live_span(got_ids, torch.tensor([0, n_rows])).tolist()
    assert searched == [0, min(count, got_ids.numel())]
    assert (got_ids[searched[1]:] == n_rows).all()
    one = unique_rows_with_sentinel(torch.tensor([4, 4, 4]), n_rows,
                                    return_span=True)
    assert one[1].tolist() == [0, 1]
    empty = unique_rows_with_sentinel(torch.empty(0, dtype=torch.int64),
                                      n_rows, return_span=True)
    assert empty[0].numel() == 0 and empty[1].tolist() == [0, 0]


def _mesh_ids(rng, total, lo, rows):
    """A row-sharded rank's ids as the engine makes them: the global ids'
    dedupe, shifted into the block ``[lo, lo + rows)``, every id outside it
    (and every pad) the local sentinel ``rows``; and the span the engine
    searches for on the global ids."""
    unique = unique_rows_with_sentinel(
        torch.from_numpy(rng.integers(0, total, 60)), total)
    local = unique - lo
    ids = torch.where((local >= 0) & (local < rows), local, rows)
    return ids, live_span(unique, torch.tensor([lo, lo + rows]))


@pytest.mark.parametrize("rank", range(4))
def test_mesh_ids_with_the_callers_span_update_exactly_the_live_rows(rank):
    total, rows, d = 64, 16, 2
    rng = np.random.default_rng(3)
    ids, span = _mesh_ids(rng, total, rank * rows, rows)
    start, end = (int(x) for x in span)
    live = (ids < rows).nonzero().reshape(-1)
    # the live run is contiguous, with sentinels on both sides (but at the
    # edges of the id range) and the span holds exactly it
    assert live.numel() and torch.equal(live, torch.arange(start, end))
    assert (ids[:start] == rows).all() and (ids[end:] == rows).all()
    if rank:
        assert start > 0
    assert end < ids.numel()
    grads = torch.from_numpy(rng.standard_normal((ids.numel(), d))
                             .astype(np.float32))
    torch.manual_seed(rank)
    before = torch.randn(rows, d)
    got = _steps(rows, d, torch.float32, ids, grads, 2, rank, span=span)
    assert _bits_equal(got, _steps(rows, d, torch.float32, ids, grads, 2,
                                   rank))
    touched = torch.zeros(rows, dtype=torch.bool)
    touched[ids[start:end]] = True
    assert torch.equal(got[0][~touched], before[~touched])
    assert (got[1].mu[~touched] == 0).all()
    assert (got[0][touched] != before[touched]).all()


def test_a_span_leaves_live_slots_outside_it_alone():
    """The span is the kernel's walk: a live slot outside it is not
    updated (the plain version honours it as the kernel does), an empty
    span updates nothing, and a span of another shape is refused."""
    n_rows = 20
    ids = unique_rows_with_sentinel(torch.tensor([3, 5, 7, 11, 13]), n_rows)
    grads = torch.ones(ids.numel(), 1)
    torch.manual_seed(0)
    before = torch.randn(n_rows, 1)
    table, st, _ = _steps(n_rows, 1, torch.float32, ids, grads, 1, 0,
                          span=torch.tensor([1, 3]))
    changed = (table != before).reshape(-1).nonzero().reshape(-1)
    assert changed.tolist() == [5, 7]
    table, st, _ = _steps(n_rows, 1, torch.float32, ids, grads, 1, 0,
                          span=torch.tensor([2, 2]))
    assert torch.equal(table, before) and (st.mu == 0).all()
    for bad in (torch.tensor(2), torch.tensor([0, 2, 4]),
                torch.tensor([0, 2], dtype=torch.int32)):
        with pytest.raises(TypeError, match="span"):
            _steps(n_rows, 1, torch.float32, ids, grads, 1, 0, span=bad)


class _ParentRoute(TrainEngine):
    """The single-device route before the table-gradient form: each
    table's gradient gathered at every slot (``index_select`` of the
    clamped ids), then the per-slot form over every slot."""

    def _update(self, opt_state, params, grads, rows, pred, norm=False,
                apply=None, d_rows=None):
        d_rows = {key: torch.index_select(
            grads[at], 0, torch.clamp(rows[key].ids,
                                      max=params[at].shape[0] - 1))
            for key, at in self._table_at.items()}
        rows = {key: SparseRows(r.ids, torch.tensor([0, r.ids.numel()]))
                for key, r in rows.items()}
        return super()._update(opt_state, params, grads, rows, pred, norm,
                               apply, d_rows)


def _dbn_batches(n_rows, steps, b=6, k=4):
    rng = np.random.default_rng(11)
    return [{"positions": torch.from_numpy(
                 np.tile(np.arange(1, k + 1, dtype=np.int32), (1, b, 1))),
             "query_doc_ids": torch.from_numpy(
                 rng.integers(0, n_rows, (1, b, k))),
             "clicks": torch.from_numpy(
                 (rng.random((1, b, k)) < 0.3).astype(np.float32)),
             "mask": torch.from_numpy(rng.random((1, b, k)) < 0.9)}
            for _ in range(steps)]


@pytest.mark.parametrize("extras", [{}, {"nonfinite_guard": True,
                                         "telemetry": True}])
def test_engine_sparse_route_gives_the_parents_bits(extras):
    n_rows = 40
    runs = []
    for engine_cls in (TrainEngine, _ParentRoute):
        model = tcore.MODEL_REGISTRY["dbn"](
            query_doc_pairs=n_rows, positions=4, init_prob=0.2,
            device="cpu")
        torch.manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn_like(p) * 0.3)
        engine = engine_cls(model, topt.adamw(0.05, weight_decay=1e-3),
                            sparse_tables=True,
                            sparse_table_kwargs=dict(lr=0.05,
                                                     weight_decay=1e-3),
                            **extras)
        state = engine.init_opt_state()
        outs = []
        for chunk in _dbn_batches(n_rows, 2):
            state, out = engine.step(state, chunk)
            outs.append(out)
        runs.append((model, state, outs))
    (m1, s1, o1), (m2, s2, o2) = runs
    assert len(s1["sparse"]) == 2
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    for key, st in s1["sparse"].items():
        assert torch.equal(st.mu, s2["sparse"][key].mu)
        assert torch.equal(st.nu, s2["sparse"][key].nu)
        assert int(st.count) == int(s2["sparse"][key].count) == 2
    for a, b in zip(o1, o2):
        assert torch.equal(a, b) if not isinstance(a, dict) else all(
            torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("elements", [1, 127, 128, 86_726, 655_360])
def test_launch_plan_visits_every_element_once(elements, sm_count):
    """The kernel's walk, mirrored: warp ``w`` of block ``b`` is warp
    ``w x blocks + b`` of the grid; it takes chunks ``that, that + warps,
    ...``, lane ``l`` of a chunk at ``base`` the elements ``base + 32 j +
    l``, ``j < PER_LANE``."""
    per, threads = ksparse.PER_LANE, ksparse.THREADS
    blocks = ksparse.launch_plan(elements, sm_count)
    assert 1 <= blocks <= ksparse.BLOCKS_PER_SM * sm_count
    warps = blocks * threads // 32
    warp = (np.arange(threads // 32)[:, None] * blocks
            + np.arange(blocks)[None, :]).reshape(-1)        # grid warps
    seen, per_block = [], np.zeros(blocks, int)
    stride = warps * 32 * per
    lane_j = (np.arange(per)[:, None] * 32
              + np.arange(32)[None, :]).reshape(-1)
    for base0 in range(0, elements, stride):
        base = base0 + warp * 32 * per
        e = (base[:, None] + lane_j[None, :]).reshape(-1)
        seen.append(e[e < elements])
        busy = (base < elements).reshape(threads // 32, blocks).any(axis=0)
        per_block += busy
    seen = np.sort(np.concatenate(seen))
    np.testing.assert_array_equal(seen, np.arange(elements))
    chunks = -(-elements // (32 * per))
    if chunks >= blocks:  # a short run still reaches every block
        assert (per_block > 0).all()
