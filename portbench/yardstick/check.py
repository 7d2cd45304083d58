"""The comparison that decides ``correct``.

The plain reference (``references/<model>.py``) is run here, after the
window has closed and the program's state is freed, on inputs the
benchmark made itself: the pool's sessions and the weights from
``weights``. It hashes the ids and gathers the rows on its own, and it
takes nothing from the program but the outputs being judged.

Training: the reference follows the program's first three steps (AdamW as
optax orders it, over the whole tables: a row no batch touched only
decays). Three numbers are compared, each a relative gap:

* ``loss_gap``: the worst of the three steps' losses;
* ``grad_gap``: the gradient of step 1 as the optimizer got it (its first
  moment after one step, over 1 - b1), by the worst leaf: the gap between
  the two norms over the larger of the reference's norm of that leaf and
  of the median leaf;
* ``change_gap``: the parameters' change after step 3, by the worst leaf,
  in the same measure; a leaf whose reference gradient is under a
  thousandth of the median leaf's is left out (it moves by round-off).

Serving: ``logp_gap``, the largest absolute gap between a served log
P(click) and the reference's, over every answer of the calls sampled.

The control is the same reference computed in bfloat16 (the precision
below the configurations' float32; there is no matmul, so TF32 does not
arise) and judged as the program is.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from yardstick import weights

_MASK = np.uint64(0xFFFFFFFF)
#: A leaf's reference gradient under this share of the median leaf's is
#: round-off: the leaf is left out of ``change_gap``.
NEGLIGIBLE_GRAD = 1e-3


def reference_module(config):
    return importlib.import_module(f"references.{config['reference']}")


def hashed_rows(ids: np.ndarray, rows: int, salt: int = 0) -> np.ndarray:
    """The table row of each id under the configurations' hashing trick
    (repro's uint32 multiply-xorshift, salt 0, then ``% rows``), in numpy
    uint64 arithmetic."""
    x = ids.astype(np.uint64) & _MASK
    x ^= np.uint64((salt * 0x9E3779B9 + 0x85EBCA6B) & 0xFFFFFFFF)
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) & _MASK
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) & _MASK
    x ^= x >> np.uint64(16)
    return (x % np.uint64(rows)).astype(np.int64)


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _tensors(batch, device):
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in ("positions", "clicks", "mask") if k in batch}


def _dense_start(leaf, seed, dtype, device):
    n = _numel(leaf["shape"])
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _row_start(leaf, seed, idx, dtype).reshape(leaf["shape"])


def _row_start(leaf, seed, rows, dtype):
    """The rows' start as the program's leaf holds it (its own dtype), in
    ``dtype``."""
    return weights.rounded(seed, leaf["index"], rows, leaf["center"],
                           leaf["spread"],
                           getattr(torch, leaf["dtype"])).to(dtype)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TrainReadings:
    losses: List[float]
    grads: Dict[str, float]    # step 1's gradient norm, by leaf
    changes: Dict[str, float]  # the change after the last step, by leaf


class _AdamW:
    def __init__(self, opt, dtype):
        self.lr, self.b1, self.b2 = (opt["learning_rate"], opt["b1"],
                                     opt["b2"])
        self.eps, self.wd = opt["eps"], opt["weight_decay"]
        self.dtype = dtype

    def decayed(self, p, steps: int):
        """A row no gradient reached, after ``steps`` steps: its moments
        stay 0 and only the decay moves it."""
        for _ in range(steps):
            p = p - self.lr * (self.wd * p)
        return p

    def step(self, t, p, m, v, g):
        m = self.b1 * m + (1 - self.b1) * g
        v = self.b2 * v + (1 - self.b2) * g * g
        mhat = m / (1 - self.b1 ** t)
        vhat = v / (1 - self.b2 ** t)
        p = p - self.lr * (mhat / (torch.sqrt(vhat) + self.eps)
                           + self.wd * p)
        return p, m, v


@torch.no_grad()
def _untouched_change_sq(leaf, seed, steps, adam, dtype, device) -> float:
    """Sum over every row of the leaf of (the row after ``steps`` decays
    less its start)^2, in float64, a block at a time."""
    n = _numel(leaf["shape"])
    total = 0.0
    for lo in range(0, n, weights.BLOCK):
        idx = torch.arange(lo, min(lo + weights.BLOCK, n),
                           dtype=torch.int64, device=device)
        p0 = _row_start(leaf, seed, idx, dtype)
        d = (adam.decayed(p0, steps) - p0).double()
        total += float(torch.dot(d, d))
    return total


def train_reference(config, seed: int, batches: Sequence[Dict[str,
                    np.ndarray]], dtype=torch.float64,
                    device="cpu") -> TrainReadings:
    """The reference's readings over ``batches`` (one step each), its
    arithmetic and its parameters in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_module(config)
    leaves = weights.leaf_table(config)
    adam = _AdamW(config["optimizer"], dtype)
    state = {}
    for path, leaf in leaves.items():
        if leaf.get("hashed"):
            empty = torch.zeros(0, dtype=dtype, device=device)
            state[path] = {"rows": torch.zeros(0, dtype=torch.int64,
                                               device=device),
                           "p": empty, "m": empty, "v": empty, "p0": empty}
        else:
            p0 = _dense_start(leaf, seed, dtype, device)
            state[path] = {"p": p0.clone(), "m": torch.zeros_like(p0),
                           "v": torch.zeros_like(p0), "p0": p0}
    losses, grads = [], {}
    for t, batch in enumerate(batches, start=1):
        params, uniq = {}, {}
        tensors = _tensors(batch, device)
        for path, leaf in leaves.items():
            s = state[path]
            if leaf.get("hashed"):
                rows = torch.from_numpy(hashed_rows(
                    batch[leaf["hashed"]], leaf["shape"][0])).to(device)
                u, inverse = torch.unique(rows, return_inverse=True)
                at = torch.searchsorted(s["rows"], u).clamp_max(
                    max(len(s["rows"]) - 1, 0))
                known = (s["rows"][at] == u) if len(s["rows"]) else \
                    torch.zeros_like(u, dtype=torch.bool)
                current = adam.decayed(_row_start(leaf, seed, u, dtype),
                                       t - 1)
                if len(s["rows"]):
                    current = torch.where(known, s["p"][at], current)
                uniq[path] = (u, current.detach().requires_grad_(True))
                params[path] = uniq[path][1][inverse].reshape(rows.shape)
            else:
                params[path] = s["p"].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = ref.conditional_nll(params, tensors)
            wrt = [uniq[path][1] if path in uniq else params[path]
                   for path in leaves]
            dloss = torch.autograd.grad(loss, wrt)
        losses.append(float(loss.detach()))
        for path, g in zip(leaves, dloss):
            if t == 1:
                grads[path] = float(torch.linalg.vector_norm(g.double()))
            s = state[path]
            if path in uniq:
                u, _ = uniq[path]
                rows = torch.unique(torch.cat([s["rows"], u]))
                p = adam.decayed(_row_start(leaves[path], seed, rows, dtype),
                                 t - 1)
                m, v = torch.zeros_like(p), torch.zeros_like(p)
                old = torch.searchsorted(rows, s["rows"])
                p[old], m[old], v[old] = s["p"], s["m"], s["v"]
                grad = torch.zeros_like(p)
                grad[torch.searchsorted(rows, u)] = g
                s["rows"] = rows
                s["p0"] = _row_start(leaves[path], seed, rows, dtype)
                s["p"], s["m"], s["v"] = adam.step(t, p, m, v, grad)
            else:
                s["p"], s["m"], s["v"] = adam.step(t, s["p"], s["m"],
                                                   s["v"], g)
    steps = len(batches)
    changes = {}
    for path, leaf in leaves.items():
        s = state[path]
        d = (s["p"] - s["p0"]).double()
        sq = float(torch.dot(d.reshape(-1), d.reshape(-1)))
        if leaf.get("hashed"):
            # every other row only decayed: the whole table's decay, less
            # the touched rows' share of it, plus their real change
            p0 = s["p0"]
            mine = (adam.decayed(p0, steps) - p0).double()
            sq += _untouched_change_sq(leaf, seed, steps, adam, dtype,
                                       device) - float(torch.dot(mine, mine))
        changes[path] = max(sq, 0.0) ** 0.5
    return TrainReadings(losses, grads, changes)


def _relative(got: Dict[str, float], want: Dict[str, float],
              keep=None) -> float:
    paths = [p for p in want if keep is None or p in keep]
    median = float(np.median([want[p] for p in want]))
    return max(abs(got[p] - want[p]) / max(want[p], median) for p in paths)


def train_gaps(got: TrainReadings, want: TrainReadings) -> Dict[str, float]:
    """The three relative gaps of ``got`` (the program, or the control)
    against ``want`` (the reference)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got.losses, want.losses))
    median = float(np.median(list(want.grads.values())))
    moving = {p for p, g in want.grads.items()
              if g >= NEGLIGIBLE_GRAD * median}
    return {"loss_gap": loss_gap,
            "grad_gap": _relative(got.grads, want.grads),
            "change_gap": _relative(got.changes, want.changes, moving)}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@torch.no_grad()
def serve_reference(config, seed: int, batch: Dict[str, np.ndarray],
                    dtype=torch.float64, device="cpu",
                    block: int = 65536) -> np.ndarray:
    """The reference's ``(B, K)`` log P(click) for ``batch``, in float64
    numpy, computed in ``dtype`` a block of rows at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_module(config)
    leaves = weights.leaf_table(config)
    dense = {path: _dense_start(leaf, seed, dtype, device)
             for path, leaf in leaves.items() if not leaf.get("hashed")}
    n = len(batch["positions"])
    out = []
    for lo in range(0, n, block):
        part = {k: v[lo:lo + block] for k, v in batch.items()}
        params = dict(dense)
        for path, leaf in leaves.items():
            if leaf.get("hashed"):
                rows = torch.from_numpy(hashed_rows(
                    part[leaf["hashed"]], leaf["shape"][0])).to(device)
                params[path] = _row_start(leaf, seed, rows.reshape(-1),
                                          dtype).reshape(rows.shape)
        got = ref.marginal_log_clicks(params, _tensors(part, device))
        out.append(got.double().cpu().numpy())
    return np.concatenate(out)


def logp_gap(served: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(served.astype(np.float64) - want)))


# --------------------------------------------------------------------------
# the verdict
# --------------------------------------------------------------------------

def judge(gaps: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every gap within its limit, and each gap
    beside its limit, in the limits' order. A gap that is not a number
    fails."""
    checks = {name: {"value": gaps[name], "limit": limit}
              for name, limit in limits.items()}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks
