"""Training runtime (port of ``repro.train``): the Trainer, the chunked
engine, checkpointing and fault tolerance."""
from repro_torch.train.checkpoints import (CheckpointCorruptionError,
                                           CheckpointManager, select_replica,
                                           stack_replicas)
from repro_torch.train.engine import TrainEngine, discover_sparse_tables
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               StepWatchdog,
                                               drop_slowest_aggregate,
                                               run_with_restarts)
from repro_torch.train.trainer import Trainer, TrainState, default_metrics

__all__ = [
    "Trainer",
    "TrainState",
    "TrainEngine",
    "discover_sparse_tables",
    "CheckpointManager",
    "CheckpointCorruptionError",
    "select_replica",
    "stack_replicas",
    "PreemptionHandler",
    "StepWatchdog",
    "drop_slowest_aggregate",
    "run_with_restarts",
    "default_metrics",
]
