"""What a loop hands back to ``run.py``."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Outcome:
    #: the end-to-end metrics by name, in their units
    e2e: Dict[str, float]
    #: what the per-layer readers read (see ``metrics/``)
    ctx: Dict[str, Any]
    #: the numbers ``correct`` is decided by
    gaps: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    #: seconds of each part of set-up, in order (printed, not reported)
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)


class Parts:
    """Set-up's parts on the host clock, from ``t0`` (the process's start)
    on: each :meth:`mark` closes the part since the last."""

    def __init__(self, t0: float):
        self.last = t0
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        self.seconds[name] = now - self.last
        self.last = now
