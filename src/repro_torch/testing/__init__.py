"""Deterministic fault injection for chaos tests and drills (port of part
of ``repro.testing``)."""
from repro_torch.testing.faults import (KillSwitch, NonFiniteBatchInjector,
                                        truncate_tail)

__all__ = ["KillSwitch", "NonFiniteBatchInjector", "truncate_tail"]
