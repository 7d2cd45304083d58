"""Deterministic fault injection for chaos tests and drills (port of part
of ``repro.testing``)."""
from repro_torch.testing.faults import (FlakyShardReads, KillSwitch,
                                        NonFiniteBatchInjector,
                                        corrupt_shard_file, truncate_tail)

__all__ = ["FlakyShardReads", "KillSwitch", "NonFiniteBatchInjector",
           "corrupt_shard_file", "truncate_tail"]
