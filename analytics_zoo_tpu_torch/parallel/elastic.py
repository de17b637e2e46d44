"""Failure detection and restart supervision for the training loop
(counterpart of ``parallel/elastic.py``).

- :class:`DivergenceDetector`: a periodic host-side check of the loss;
  a streak of non-finite readings means the run is dead even though the
  device keeps stepping.
- :func:`run_resilient`: a restart supervisor around the
  :class:`~analytics_zoo_tpu_torch.parallel.train.Optimizer`.  On a
  retryable failure (preemption, a stall, a dead input worker, an
  injected fault, a CUDA out-of-memory or launch error) it rebuilds the
  whole program through the caller's factory and resumes from the newest
  intact checkpoint, up to ``max_restarts`` times.  Rebuilding matters on
  the card: after a failed launch the old module and its buffers are not
  to be trusted; a fresh ``Optimizer`` reloads them from the snapshot.
  A chaos schedule (``resilience.chaos.ChaosMonkey``) rides along when
  the factory wraps every attempt's dataset with the same monkey: its
  batch counter runs across attempts, so each fault fires once.
- :func:`resume_after_quarantine`: after ``DeviceQuarantine`` the
  survivors go on without the named device, from the last-known-good
  tier, at the smaller width.
- :class:`FaultInjector`: a dataset wrapper that raises once, at a
  chosen global batch index.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional, Tuple, Type

from analytics_zoo_tpu_torch.resilience.errors import (InjectedFault,
                                                       TrainingDiverged,
                                                       retryable_errors)

logger = logging.getLogger("analytics_zoo_tpu_torch")


#: Failures worth a restart.  Not ``RuntimeError``: a bare RuntimeError
#: is usually a programming error and propagates on the first attempt;
#: ``TrainingDiverged`` is fatal (a restart resumes into the same
#: divergence).
RETRYABLE_ERRORS: Tuple[Type[BaseException], ...] = retryable_errors()


class DivergenceDetector:
    """Reads the loss every ``check_every`` iterations; ``max_bad_checks``
    consecutive non-finite readings raise :class:`TrainingDiverged`.  The
    check is periodic so the host waits for the device only that often."""

    def __init__(self, check_every: int = 50, max_bad_checks: int = 3):
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        self.check_every = check_every
        self.max_bad_checks = max_bad_checks
        self._bad = 0

    def should_check(self, iteration: int) -> bool:
        return iteration % self.check_every == 0

    def check(self, loss: float, iteration: int) -> None:
        if math.isfinite(loss):
            self._bad = 0
            return
        self._bad += 1
        logger.warning("non-finite loss %s at iteration %d (%d/%d strikes)",
                       loss, iteration, self._bad, self.max_bad_checks)
        if self._bad >= self.max_bad_checks:
            raise TrainingDiverged(
                f"loss non-finite for {self._bad} consecutive checks "
                f"(every {self.check_every} iterations)")

    def reset(self) -> None:
        self._bad = 0


def run_resilient(build_optimizer: Callable[[], "object"],
                  checkpoint_path: str, max_restarts: int = 3,
                  retry_on: Optional[Tuple[Type[BaseException], ...]] = None,
                  on_restart: Optional[Callable[[int, BaseException],
                                                None]] = None):
    """Supervised training: ``build_optimizer()`` returns a fresh, fully
    configured :class:`Optimizer` each attempt.  Unless the optimizer set
    its own, checkpoints go to ``checkpoint_path`` every epoch as
    ``step_N`` snapshots with ``keep_last=3``; every attempt resumes from
    the newest intact one.  Returns the trained model.

    ``retry_on`` (default :data:`RETRYABLE_ERRORS`) filters the failures
    worth a restart; anything else (a ``TypeError``, ``ValueError``, a
    bare ``RuntimeError``, ``TrainingDiverged``) propagates on the first
    attempt."""
    from analytics_zoo_tpu_torch.parallel.optim import Trigger

    if retry_on is None:
        retry_on = RETRYABLE_ERRORS
    attempt = 0
    while True:
        opt = build_optimizer()
        if opt.checkpoint_trigger is None:
            # step-tagged snapshots: a corrupt newest one falls back to
            # an older intact one instead of losing the run
            opt.set_checkpoint(checkpoint_path, Trigger.every_epoch(),
                               overwrite=False, keep_last=3)
        # resume from where checkpoints land, the optimizer's own path
        opt.set_resume(opt.checkpoint_path)
        try:
            return opt.optimize()
        except retry_on as e:  # type: ignore[misc]
            attempt += 1
            if attempt > max_restarts:
                logger.error("giving up after %d restarts: %s",
                             max_restarts, e)
                raise
            logger.warning("training attempt %d failed (%s: %s); restarting "
                           "from the newest checkpoint (%d/%d)", attempt,
                           type(e).__name__, e, attempt, max_restarts)
            if on_restart is not None:
                on_restart(attempt, e)


def resume_after_quarantine(err, mesh, checkpoint_path: str, new_root: str,
                            build_optimizer: Callable,
                            new_width: Optional[int] = None):
    """The eviction after a ``DeviceQuarantine`` ``err`` raised on every
    rank of ``mesh``: every rank calls this at the same point.  The named
    rank is evicted (``health.evict_device``, a mesh and groups over the
    survivors); it gets ``None`` back and must leave without another
    collective.  The survivors' first rank publishes the last-known-good
    tier of ``checkpoint_path`` as ``new_root``'s ``latest`` (its exact
    bytes, whose manifest carries the saved width and sample offset),
    and each survivor returns ``build_optimizer(mesh, new_root)`` set to
    resume from it: the resume re-places the whole tensors at the new
    width (as ``checkpoint.restore_elastic``) and re-seeks the stream by
    samples.  Raises ``CheckpointCorrupt`` when there is no
    last-known-good snapshot to go on from."""
    import os
    import shutil

    import torch.distributed as dist

    from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
    from analytics_zoo_tpu_torch.resilience.errors import CheckpointCorrupt
    from analytics_zoo_tpu_torch.resilience.health import evict_device

    device = getattr(err, "device", None)
    if device is None:
        raise ValueError(f"{type(err).__name__} names no device to evict")
    survivors = evict_device(mesh, int(device), new_width=new_width)
    if survivors is None:
        logger.warning("rank %d evicted as device %s: leaving the run",
                       dist.get_rank(), device)
        return None
    found = ckpt.lkg_snapshot(checkpoint_path)
    if found is None:
        raise CheckpointCorrupt(
            f"no last-known-good snapshot under {checkpoint_path} to "
            f"resume the survivors from")
    ranks = [int(r) for r in survivors.mesh.flatten().tolist()]
    if dist.get_rank() == ranks[0]:
        latest = os.path.join(os.path.abspath(new_root), "latest")
        if os.path.isdir(latest):
            shutil.rmtree(latest)
        os.makedirs(os.path.dirname(latest), exist_ok=True)
        shutil.copytree(found[0], latest)
    if len(ranks) > 1:
        dist.barrier(group=survivors.get_group(
            survivors.mesh_dim_names[0]))
    opt = build_optimizer(survivors, new_root)
    return opt.set_resume(new_root)


class FaultInjector:
    """Dataset wrapper that raises ``exc`` just before yielding global
    batch index ``fail_at`` (counted across epochs), once: a lost device
    or a preemption mid-training.  The default is
    :class:`InjectedFault` (retryable); a bare ``ValueError`` or
    ``RuntimeError`` stands for a real bug."""

    def __init__(self, dataset, fail_at: int,
                 exc: Optional[BaseException] = None):
        self.dataset = dataset
        self.fail_at = fail_at
        self.exc = exc or InjectedFault("injected fault")
        self._count = 0
        self._fired = False

    def __iter__(self):
        for batch in self.dataset:
            if not self._fired and self._count == self.fail_at:
                self._fired = True
                raise self.exc
            self._count += 1
            yield batch
