"""Deterministic fault injection for chaos tests and drills (port of part
of ``repro.testing``): the data plane's, the train step's, the process's
and the serving engine's."""
from repro_torch.testing.faults import (POISON_MODES, FlakyShardReads,
                                        KillSwitch, NonFiniteBatchInjector,
                                        PoisonTrace, ServeFault,
                                        ServeKillSwitch, SlowModel,
                                        corrupt_shard_file, poison_request,
                                        truncate_tail)

__all__ = ["FlakyShardReads", "KillSwitch", "NonFiniteBatchInjector",
           "corrupt_shard_file", "truncate_tail", "ServeFault", "SlowModel",
           "ServeKillSwitch", "poison_request", "PoisonTrace",
           "POISON_MODES"]
