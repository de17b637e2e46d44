"""The serving runtime's failure classes and their classification
(counterpart of ``resilience/errors.py``).

The split that matters operationally is *retryable* against *fatal*:
retryable means the program was right and the world failed under it (a
full queue, a deadline, a wedged or crashed replica, a device that ran
out of memory or failed a launch); fatal means a restart cannot fix it.
This module holds the serving half of the reference's taxonomy; the
checkpoint, data-shard and divergence classes come with the modules that
raise them (ROADMAP.md Queue 1 items 12 and 13).

``retryable_errors()`` adds torch's CUDA errors in place of the
reference's jaxlib runtime error: ``torch.cuda.OutOfMemoryError`` and
``torch.AcceleratorError``, which a failed kernel launch raises.
"""

from __future__ import annotations

from typing import Tuple, Type


class StallError(RuntimeError):
    """A supervised unit (a replica's forward) made no progress past the
    :class:`~analytics_zoo_tpu_torch.resilience.watchdog.StallWatchdog`
    deadline.  Raised instead of hanging forever."""


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


#: Explicit classification: every class above is in exactly one tuple.
_RETRYABLE_CLASSES: Tuple[Type[BaseException], ...] = (
    StallError,
    ServerOverloaded,
    RequestTimeout,
    ReplicaWedged,
)

#: Fatal: restarting cannot fix these.  None of the serving classes is.
FATAL_ERRORS: Tuple[Type[BaseException], ...] = ()


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
