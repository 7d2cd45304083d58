"""Test-support machinery (port of ``repro.testing``): deterministic fault
injection for the data plane, the train step, the process and the serving
engine, plus the differential kernel conformance harness
(``repro_torch.testing.conformance``)."""
from repro_torch.testing.conformance import (KERNEL_SPECS, SPECS_BY_NAME,
                                             KernelSpec, check_extreme,
                                             check_grads, check_value,
                                             run_conformance)
from repro_torch.testing.faults import (POISON_MODES, FlakyShardReads,
                                        KillSwitch, NonFiniteBatchInjector,
                                        PoisonTrace, ServeFault,
                                        ServeKillSwitch, SlowModel,
                                        corrupt_shard_file, poison_request,
                                        truncate_tail)

__all__ = ["FlakyShardReads", "KillSwitch", "NonFiniteBatchInjector",
           "corrupt_shard_file", "truncate_tail", "ServeFault", "SlowModel",
           "ServeKillSwitch", "poison_request", "PoisonTrace",
           "POISON_MODES", "KernelSpec", "KERNEL_SPECS", "SPECS_BY_NAME",
           "check_value", "check_grads", "check_extreme", "run_conformance"]
