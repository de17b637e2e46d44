"""The serving runtime's failure taxonomy and stall detection
(counterpart of ``resilience/``; the checkpoint, anomaly, chaos and
device-health modules are ROADMAP.md Queue 1 items 12 and 13)."""

from analytics_zoo_tpu_torch.resilience.errors import (
    FATAL_ERRORS, ReplicaWedged, RequestTimeout, ServerOverloaded,
    StallError, is_retryable, retryable_errors)
from analytics_zoo_tpu_torch.resilience.watchdog import StallWatchdog

__all__ = ["FATAL_ERRORS", "ReplicaWedged", "RequestTimeout",
           "ServerOverloaded", "StallError", "StallWatchdog",
           "is_retryable", "retryable_errors"]
