"""``repro_torch.serve`` — the resilient serving engine (port of
``repro.serve``).

A bounded admission queue with load shedding and backpressure, a
deadline-aware dynamic batcher over captured bucket shapes (one CUDA graph
per model, tier and bucket on the card), a warm multi-model registry with
an int8-quantized degraded tier that gathers before it widens and a
constant CTR-prior fallback, per-model circuit breakers, fail-closed
per-request validation, and SIGTERM drain.
"""
from repro_torch.serve.batcher import BatchPlan, DeadlineBatcher
from repro_torch.serve.breaker import (CLOSED, HALF_OPEN, OPEN,
                                       CircuitBreaker, DegradationLadder)
from repro_torch.serve.clock import ServiceModel, VirtualClock, WallClock
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.queue import (ADMIT, ADMIT_BACKPRESSURE,
                                     AdmissionQueue, SHED_OVERLOAD,
                                     SHED_QUEUE_FULL)
from repro_torch.serve.registry import (DEFAULT_BUCKETS, ModelEntry,
                                        ModelRegistry, pad_batch)
from repro_torch.serve.request import (OK, REJECTED, SHED, TIERS,
                                       ServeRequest, ServeResult,
                                       make_request, poisson_trace)
from repro_torch.serve.validation import validate_request

__all__ = [
    "ServeEngine",
    "ServeRequest",
    "ServeResult",
    "make_request",
    "poisson_trace",
    "validate_request",
    "AdmissionQueue",
    "DeadlineBatcher",
    "BatchPlan",
    "CircuitBreaker",
    "DegradationLadder",
    "ModelRegistry",
    "ModelEntry",
    "pad_batch",
    "ServiceModel",
    "VirtualClock",
    "WallClock",
    "TIERS",
    "OK",
    "REJECTED",
    "SHED",
    "ADMIT",
    "ADMIT_BACKPRESSURE",
    "SHED_OVERLOAD",
    "SHED_QUEUE_FULL",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
    "DEFAULT_BUCKETS",
]
