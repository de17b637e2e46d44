"""The failure taxonomy, stall detection and graceful preemption
(counterpart of ``resilience/``; the anomaly, chaos and device-health
modules are ROADMAP.md Queue 1 item 13)."""

from analytics_zoo_tpu_torch.resilience.errors import (
    FATAL_ERRORS, CheckpointCorrupt, ElasticPlacementError, InjectedFault,
    Preempted, PrefetchWorkerDied, ReplicaWedged, RequestTimeout,
    ServerOverloaded, ShardReadError, StallError, TrainingDiverged,
    is_retryable, retryable_errors)
from analytics_zoo_tpu_torch.resilience.preempt import PreemptionHandler
from analytics_zoo_tpu_torch.resilience.watchdog import StallWatchdog

__all__ = ["FATAL_ERRORS", "CheckpointCorrupt", "ElasticPlacementError",
           "InjectedFault", "Preempted", "PreemptionHandler",
           "PrefetchWorkerDied", "ReplicaWedged", "RequestTimeout",
           "ServerOverloaded", "ShardReadError", "StallError",
           "StallWatchdog", "TrainingDiverged", "is_retryable",
           "retryable_errors"]
