"""The failure taxonomy, stall detection, graceful preemption, the
training anomaly sentinel, chaos fault injection and the device-health
sentinel (counterpart of ``resilience/``)."""

from analytics_zoo_tpu_torch.resilience.anomaly import (AnomalyPolicy,
                                                        AnomalySentinel,
                                                        batch_fingerprint,
                                                        decode_health,
                                                        health_sections)
from analytics_zoo_tpu_torch.resilience.chaos import (ChaosMonkey, FaultSpec,
                                                      corrupt_snapshot,
                                                      transient_xla_error)
from analytics_zoo_tpu_torch.resilience.errors import (
    FATAL_ERRORS, CheckpointCorrupt, DeviceQuarantine, ElasticPlacementError,
    InjectedFault, Preempted, PrefetchWorkerDied, ReplicaWedged,
    RequestTimeout, SdcDetected, ServerOverloaded, ShardReadError,
    StallError, TrainingDiverged, is_retryable, retryable_errors)
from analytics_zoo_tpu_torch.resilience.health import (AuditVerdict,
                                                       HealthPolicy,
                                                       HealthSentinel,
                                                       evict_device,
                                                       make_audit_fn,
                                                       tree_fingerprint)
from analytics_zoo_tpu_torch.resilience.preempt import PreemptionHandler
from analytics_zoo_tpu_torch.resilience.watchdog import StallWatchdog

__all__ = ["AnomalyPolicy", "AnomalySentinel", "batch_fingerprint",
           "decode_health", "health_sections",
           "ChaosMonkey", "FaultSpec", "corrupt_snapshot",
           "transient_xla_error",
           "FATAL_ERRORS", "CheckpointCorrupt", "DeviceQuarantine",
           "ElasticPlacementError", "InjectedFault", "Preempted",
           "PreemptionHandler", "PrefetchWorkerDied", "ReplicaWedged",
           "RequestTimeout", "SdcDetected", "ServerOverloaded",
           "ShardReadError", "StallError", "StallWatchdog",
           "TrainingDiverged", "is_retryable", "retryable_errors",
           "AuditVerdict", "HealthPolicy", "HealthSentinel", "evict_device",
           "make_audit_fn", "tree_fingerprint"]
