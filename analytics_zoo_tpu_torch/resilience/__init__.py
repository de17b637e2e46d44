"""The failure taxonomy, stall detection, graceful preemption and the
training anomaly sentinel (counterpart of ``resilience/``; the chaos and
device-health modules are ROADMAP.md Queue 1 item 13)."""

from analytics_zoo_tpu_torch.resilience.anomaly import (AnomalyPolicy,
                                                        AnomalySentinel,
                                                        batch_fingerprint,
                                                        decode_health,
                                                        health_sections)
from analytics_zoo_tpu_torch.resilience.errors import (
    FATAL_ERRORS, CheckpointCorrupt, ElasticPlacementError, InjectedFault,
    Preempted, PrefetchWorkerDied, ReplicaWedged, RequestTimeout,
    ServerOverloaded, ShardReadError, StallError, TrainingDiverged,
    is_retryable, retryable_errors)
from analytics_zoo_tpu_torch.resilience.preempt import PreemptionHandler
from analytics_zoo_tpu_torch.resilience.watchdog import StallWatchdog

__all__ = ["AnomalyPolicy", "AnomalySentinel", "batch_fingerprint",
           "decode_health", "health_sections",
           "FATAL_ERRORS", "CheckpointCorrupt", "ElasticPlacementError",
           "InjectedFault", "Preempted", "PreemptionHandler",
           "PrefetchWorkerDied", "ReplicaWedged", "RequestTimeout",
           "ServerOverloaded", "ShardReadError", "StallError",
           "StallWatchdog", "TrainingDiverged", "is_retryable",
           "retryable_errors"]
