"""The failure classes and their classification (counterpart of
``resilience/errors.py``).

The split that matters operationally is *retryable* against *fatal*:
retryable means the program was right and the world failed under it (a
full queue, a deadline, a wedged or crashed replica, a device that ran
out of memory or failed a launch); fatal means a restart cannot fix it.
Every class of the taxonomy the port raises is defined here, once, and
sits in exactly one of the two tuples: the serving classes, the training
supervisor's (``Preempted``, ``InjectedFault``, ``TrainingDiverged``),
the checkpoint's (``CheckpointCorrupt``), the input path's
(``PrefetchWorkerDied``, ``ShardReadError``, which ``data.prefetch`` and
``data.records`` import from here), the device-health sentinel's
(``DeviceQuarantine``, ``SdcDetected``) and ``ElasticPlacementError``.

``retryable_errors()`` adds torch's CUDA errors in place of the
reference's jaxlib runtime error: ``torch.cuda.OutOfMemoryError`` and
``torch.AcceleratorError``, which a failed kernel launch raises.
"""

from __future__ import annotations

from typing import Tuple, Type


class Preempted(RuntimeError):
    """The process received SIGTERM mid-training; a final checkpoint was
    taken at the step boundary before raising.  Retryable: a supervisor
    (or the job's next incarnation) resumes from that checkpoint."""


class StallError(RuntimeError):
    """A supervised unit (a train step, a validation pass, a checkpoint
    save or a replica's forward) made no progress past the
    :class:`~analytics_zoo_tpu_torch.resilience.watchdog.StallWatchdog`
    deadline.  Raised instead of hanging forever."""


class PrefetchWorkerDied(RuntimeError):
    """An input worker (the prefetch thread or a loader process) died
    without delivering its stream; retryable by restarting the epoch."""


class CheckpointCorrupt(RuntimeError):
    """A snapshot failed manifest verification (missing manifest, missing
    file, size or checksum mismatch) and no older intact snapshot could
    be restored in its place."""


class ShardReadError(IOError):
    """A shard's transient I/O errors outlasted the retry budget.
    Persistent by definition, so not retryable by a restart."""


class InjectedFault(RuntimeError):
    """The default exception of fault injection: it stands in for a lost
    device or a killed task, so it is retryable."""


class TrainingDiverged(RuntimeError):
    """The loss stayed non-finite through the failure detector's strikes.
    Fatal: a restart would resume from the same checkpoint into the same
    divergence."""


class ServerOverloaded(RuntimeError):
    """The serving admission queue is full: the request was shed at
    submit time, before it cost any device time.  Retryable with backoff
    (an immediate blind retry from every rejected client re-creates the
    overload)."""


class RequestTimeout(RuntimeError):
    """A serving request's deadline passed while it was still queued, so
    it was shed before dispatch.  Retryable with a fresh deadline."""


class ReplicaWedged(RuntimeError):
    """A serving replica's forward wedged past its StallWatchdog deadline
    or crashed mid-batch.  Fatal for the replica (the pool fences it and
    restarts it later), retryable for the requests of its batch (the
    pool re-dispatches the batch to a healthy replica exactly once; only
    if that dispatch also fails do the requests fail with this error)."""


class DeviceQuarantine(RuntimeError):
    """The device-health sentinel (``resilience/health.py``) confirmed a
    device as unhealthy (a parity-audit minority, a shadow recompute
    outvoted by a tiebreak, or a persistent straggler) and quarantined
    it.  ``device`` names the rank of the data group (or the replica id)
    being evicted.  Retryable: the culprit is attributed, so the
    survivors rebuild without it (``health.evict_device``, the
    last-known-good tier and the elastic resume) and the narrower
    restart does not re-create the fault."""

    def __init__(self, message: str, device=None):
        super().__init__(message)
        self.device = device


class SdcDetected(RuntimeError):
    """Silent data corruption was proven (the ranks' fingerprints
    diverged, or a shadow recompute disagreed with the primary) but not
    attributed to one device: a two-way split, several divergers, or no
    tiebreak.  Fatal: with no culprit there is nothing to evict, and a
    restart lands on the same silicon."""


class ElasticPlacementError(ValueError):
    """A restored state cannot be placed under the declared sharding.
    Fatal: a configuration error that a restart re-creates."""


#: Explicit classification: every class above is in exactly one tuple.
_RETRYABLE_CLASSES: Tuple[Type[BaseException], ...] = (
    Preempted,
    StallError,
    PrefetchWorkerDied,
    InjectedFault,
    ServerOverloaded,
    RequestTimeout,
    ReplicaWedged,
    DeviceQuarantine,
)

#: Fatal: restarting cannot fix these (no intact snapshot left; a shard
#: that stays unreadable; a run whose loss keeps diverging; a placement
#: the declaration cannot carry; corruption with no culprit).
FATAL_ERRORS: Tuple[Type[BaseException], ...] = (
    CheckpointCorrupt,
    ShardReadError,
    TrainingDiverged,
    ElasticPlacementError,
    SdcDetected,
)


def _device_errors() -> Tuple[Type[BaseException], ...]:
    import torch

    errs: Tuple[Type[BaseException], ...] = (torch.cuda.OutOfMemoryError,)
    accel = getattr(torch, "AcceleratorError", None)
    return errs + ((accel,) if accel is not None else ())


def retryable_errors() -> Tuple[Type[BaseException], ...]:
    """The tuple of transient, restart-recoverable failures."""
    return _RETRYABLE_CLASSES + _device_errors()


def is_retryable(exc: BaseException) -> bool:
    """Classify one failure against the taxonomy; fatal classes win over
    retryable bases."""
    if isinstance(exc, FATAL_ERRORS):
        return False
    return isinstance(exc, retryable_errors())
