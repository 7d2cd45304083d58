"""Parameterizations: the "how" of each click-model variable (paper §4.2).

Port of ``repro.core.parameterization``: ``EmbeddingParameter`` (plain,
hashing trick [Weinberger 2009], quotient-remainder [Shi 2020], optional
baseline correction), ``PositionParameter``, ``UBMExaminationParameter``,
``ScalarParameter`` and ``FeatureParameter`` (Linear / MLP / DeepCrossV2
towers over feature vectors: the paper's two-tower form). Each is a module
that maps a batch to per-item logits; parameter names and shapes are those
of the JAX ``init`` tree. The tables start at the same constants; the
towers draw their random weights from a ``torch.Generator`` seeded with
the model's ``seed`` (0 by default), which gives other numbers than
``jax.random`` (parity tests carry JAX's weights over with
``repro_torch.convert``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.nn import init as initializers
from repro_torch.nn.layers import MLP, DeepCrossV2, Dense
from repro_torch.nn.module import Module

# Compressed tables round up to a multiple of this (repro: SHARD_MULTIPLE).
SHARD_MULTIPLE = 512


def _round_up(n: int, multiple: int = SHARD_MULTIPLE) -> int:
    return -(-n // multiple) * multiple


class Compression(str, enum.Enum):
    NONE = "none"
    HASH = "hash"
    QR = "quotient_remainder"


class Combination(str, enum.Enum):
    STACKED = "stacked"
    PARALLEL = "parallel"


@dataclasses.dataclass
class EmbeddingParameterConfig:
    parameters: int
    use_feature: str = "query_doc_ids"
    compression: Compression = Compression.NONE
    compression_ratio: float = 1.0
    baseline_correction: bool = False
    features: int = 1
    init_logit: float = 0.0


@dataclasses.dataclass
class ScalarParameterConfig:
    init_prob: float = 0.5
    features: int = 1


@dataclasses.dataclass
class LinearParameterConfig:
    features: int
    use_feature: str = "query_doc_features"
    out_features: int = 1


@dataclasses.dataclass
class MLPParameterConfig:
    features: int
    hidden: Sequence[int] = (64, 64)
    use_feature: str = "query_doc_features"
    out_features: int = 1


@dataclasses.dataclass
class DeepCrossParameterConfig:
    features: int
    cross_layers: int = 2
    deep_layers: int = 2
    use_feature: str = "query_doc_features"
    combination: Combination = Combination.STACKED
    out_features: int = 1


# ---------------------------------------------------------------------------
# Integer hashing for the hashing trick, bit-identical to repro's uint32
# multiply-xorshift. torch's uint32 supports few ops, so the 32-bit words
# live in int64 and every product is reduced mod 2^32 by hand.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32): the constant is split into 16-bit
    halves so no intermediate exceeds 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _splitmix(ids: torch.Tensor, salt: int = 0) -> torch.Tensor:
    x = ids.to(torch.int64) & _MASK32
    x = x ^ ((salt * 0x9E3779B9 + 0x85EBCA6B) & _MASK32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_ids(ids: torch.Tensor, table_size: int, salt: int = 0) -> torch.Tensor:
    """Hashed int64 row ids in [0, table_size)."""
    return _splitmix(ids, salt) % table_size


# ---------------------------------------------------------------------------
# Parameter modules. Each returns logits of shape ids.shape (trailing
# features dim squeezed when features == 1).
# ---------------------------------------------------------------------------

class EmbeddingParameter(Module):
    """Table-based parameter with optional compression + baseline correction.

    Baseline correction (paper §4.2): a shared scalar is added to every row's
    logit; rows start at zero so unseen ids start at the global baseline.

    ``int8`` (None unless :func:`int8_lookups` sets it) maps a table's name
    to an int8 copy ``(q, scale)``: a lookup then gathers the int8 rows and
    widens only them, ``q[rows].float() * scale``, which equals the
    dequantize-then-gather ``(q.float() * scale)[rows]`` to the bit (the
    product is elementwise). The serving registry's int8 tier reads the
    tables so, and never makes a float32 table.
    """

    int8: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None

    def __init__(self, config: EmbeddingParameterConfig, device=None):
        super().__init__()
        self.config = c = config
        self.features = c.features
        if c.compression == Compression.NONE:
            self.table_rows = c.parameters
        elif c.compression == Compression.HASH:
            self.table_rows = _round_up(
                max(int(c.parameters / max(c.compression_ratio, 1.0)), 2))
        elif c.compression == Compression.QR:
            m = _round_up(max(int(c.parameters / max(c.compression_ratio, 1.0)
                                  / 2), 2))
            self.rem_rows = m
            self.quot_rows = _round_up(int(-(-c.parameters // m)))
        else:
            raise ValueError(f"unknown compression {c.compression}")
        row_init = (initializers.zeros if c.baseline_correction
                    else initializers.constant(c.init_logit))
        if c.compression == Compression.QR:
            self.quotient = torch.nn.Parameter(
                row_init((self.quot_rows, c.features), device))
            self.remainder = torch.nn.Parameter(
                initializers.ones((self.rem_rows, c.features), device))
        else:
            self.table = torch.nn.Parameter(
                row_init((self.table_rows, c.features), device))
        if c.baseline_correction:
            self.baseline = torch.nn.Parameter(
                initializers.constant(c.init_logit)((c.features,), device))

    def row_ids(self, batch) -> torch.Tensor:
        """Table rows the batch gathers (plain and hashed tables)."""
        c = self.config
        ids = batch[c.use_feature]
        if c.compression == Compression.NONE:
            return torch.clamp(ids.to(torch.int64), 0, self.table_rows - 1)
        if c.compression == Compression.HASH:
            return hash_ids(ids, self.table_rows)
        raise NotImplementedError(
            "quotient-remainder compression has no single row-id stream")

    def _rows(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """Rows ``rows`` of the table ``name``, gathered from its int8 copy
        and widened where :attr:`int8` holds one."""
        quantized = (self.int8 or {}).get(name)
        if quantized is None:
            return getattr(self, name)[rows]
        q, scale = quantized
        return q[rows].float() * scale

    def forward(self, batch) -> torch.Tensor:
        c = self.config
        if c.compression in (Compression.NONE, Compression.HASH):
            logits = self._rows("table", self.row_ids(batch))
        else:  # QR: element-wise product of quotient and remainder rows
            ids = batch[c.use_feature].to(torch.int64)
            q = self._rows("quotient", (ids // self.rem_rows) % self.quot_rows)
            r = self._rows("remainder", ids % self.rem_rows)
            logits = q * r
        if c.baseline_correction:
            logits = logits + self.baseline
        if c.features == 1:
            logits = logits.squeeze(-1)
        return logits


@contextlib.contextmanager
def int8_lookups(tables: Iterable[Tuple[EmbeddingParameter,
                                        Dict[str, Tuple[torch.Tensor,
                                                        torch.Tensor]]]]):
    """Within the block, each ``(part, {name: (q, scale)})`` of ``tables``
    looks its named tables up in their int8 copies
    (:attr:`EmbeddingParameter.int8`); afterwards they read their float32
    tables again."""
    tables = list(tables)
    for part, copies in tables:
        part.int8 = dict(copies)
    try:
        yield
    finally:
        for part, _ in tables:
            part.int8 = None


class PositionParameter(Module):
    """Rank-indexed logit table theta_k. Positions in batches are 1-based."""

    def __init__(self, positions: int, init_logit: float = 0.0,
                 use_feature: str = "positions", device=None):
        super().__init__()
        self.positions = positions
        self.use_feature = use_feature
        self.table = torch.nn.Parameter(
            initializers.constant(init_logit)((positions,), device))

    def gather(self, values: torch.Tensor, batch) -> torch.Tensor:
        """Index per-rank ``values`` (the table or anything derived from it
        row for row) by the batch's 1-based positions."""
        pos = batch[self.use_feature].to(torch.int64) - 1
        return values[torch.clamp(pos, 0, self.positions - 1)]

    def forward(self, batch) -> torch.Tensor:
        return self.gather(self.table, batch)


class UBMExaminationParameter(Module):
    """theta_{k,k'} table: examination at rank k given last click at rank
    k'. k' == 0 encodes "no previous click". Table shape (K, K): entry
    [k-1, k'] for k in 1..K, k' in 0..K-1 (k' < k always)."""

    def __init__(self, positions: int, init_logit: float = 0.0, device=None):
        super().__init__()
        self.positions = positions
        self.table = torch.nn.Parameter(initializers.constant(init_logit)(
            (positions, positions), device))

    def logit(self, k: torch.Tensor, k_prime: torch.Tensor) -> torch.Tensor:
        """k: 1-based rank tensor; k_prime: last-click rank (0 = none)."""
        k_idx = torch.clamp(k.to(torch.int64) - 1, 0, self.positions - 1)
        kp_idx = torch.clamp(k_prime.to(torch.int64), 0, self.positions - 1)
        return self.table[k_idx, kp_idx]


class ScalarParameter(Module):
    """Single shared logit, broadcast to the batch shape."""

    def __init__(self, config: Optional[ScalarParameterConfig] = None,
                 device=None):
        super().__init__()
        self.config = config or ScalarParameterConfig()
        p = min(max(self.config.init_prob, 1e-6), 1 - 1e-6)
        v = math.log(p) - math.log1p(-p)
        self.value = torch.nn.Parameter(initializers.constant(v)((), device))

    def forward(self, batch) -> torch.Tensor:
        return self.value.expand(batch["positions"].shape)


class FeatureParameter(Module):
    """Feature-vector tower: Linear / MLP / DeepCrossV2 -> logit per item.

    ``FeatureParameter(config)`` makes the tower class for the config
    (``Dense``, ``MLP`` or ``DeepCrossV2`` under this class), so the tower's
    layers are this module's own: JAX's ``FeatureParameter.init`` returns
    the tower's tree with no level for the tower, and the names read
    ``attraction/cross_0/kernel``, ``attraction/deep/layer_0/kernel`` and
    ``attraction/head/bias`` as there. The weights come from a generator
    seeded with ``seed``.
    """

    def __new__(cls, config=None, device=None, seed: int = 0):
        if cls is FeatureParameter:
            towers = {LinearParameterConfig: _LinearTower,
                      MLPParameterConfig: _MLPTower,
                      DeepCrossParameterConfig: _DeepCrossTower}
            if type(config) not in towers:
                raise ValueError(f"unsupported feature config {config}")
            cls = towers[type(config)]
        return super().__new__(cls)

    def forward(self, batch) -> torch.Tensor:
        logits = super().forward(batch[self.config.use_feature])
        if self.config.out_features == 1:
            logits = logits.squeeze(-1)
        return logits


def _generator(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(
        seed)


class _LinearTower(FeatureParameter, Dense):
    def __init__(self, config, device=None, seed: int = 0):
        Dense.__init__(self, config.features, config.out_features,
                       _generator(device, seed), device=device)
        self.config = config


class _MLPTower(FeatureParameter, MLP):
    def __init__(self, config, device=None, seed: int = 0):
        MLP.__init__(self, config.features, list(config.hidden),
                     config.out_features, _generator(device, seed),
                     device=device)
        self.config = config


class _DeepCrossTower(FeatureParameter, DeepCrossV2):
    def __init__(self, config, device=None, seed: int = 0):
        DeepCrossV2.__init__(
            self, config.features, _generator(device, seed),
            cross_layers=config.cross_layers, deep_layers=config.deep_layers,
            out_features=config.out_features,
            combination=Combination(config.combination).value, device=device)
        self.config = config


FEATURE_CONFIGS = (LinearParameterConfig, MLPParameterConfig,
                   DeepCrossParameterConfig)

#: The parameterizations whose weights start at constants, whatever the seed.
CONSTANT_START = (EmbeddingParameter, PositionParameter,
                  UBMExaminationParameter, ScalarParameter)


def build_parameter(config, device=None, seed: int = 0):
    """Factory: config dataclass (or a ready module) -> parameter module.
    ``seed`` seeds a feature tower's weights (the tables and scalars start
    at constants, as in JAX)."""
    if isinstance(config, EmbeddingParameterConfig):
        return EmbeddingParameter(config, device)
    if isinstance(config, ScalarParameterConfig):
        return ScalarParameter(config, device)
    if isinstance(config, FEATURE_CONFIGS):
        return FeatureParameter(config, device, seed)
    if isinstance(config, torch.nn.Module):
        return config
    raise ValueError(f"cannot build parameter from {config!r}")
