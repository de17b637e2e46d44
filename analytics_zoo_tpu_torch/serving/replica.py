"""Replica supervision, exactly-once batch failover and the pool's
resize (counterpart of ``serving/replica.py``).

A serving cell runs N replicas of the model.  A replica can fail two
ways mid-batch: its forward raises (a failed launch, an out-of-memory
device), or it wedges past its :class:`~analytics_zoo_tpu_torch.
resilience.watchdog.StallWatchdog` deadline.  Either way the pool

1. **fences** the replica: state ``fenced``, no further dispatches;
2. **re-dispatches** the batch to a healthy replica exactly once
   (``AssembledBatch.redispatched``); a batch that fails its second
   replica fails its requests with :class:`~analytics_zoo_tpu_torch.
   resilience.errors.ReplicaWedged`;
3. **restarts** the fenced replica after ``restart_s`` of runtime clock.

**Fence budget**: by default a wedged forward is observed when it
returns.  ``ReplicaPool(fence_budget_s=...)`` bounds that on a virtual
clock: every sleep inside a supervised forward goes through
:meth:`Replica.sleep_guarded`, which raises at the fence instant.

**Resize**: :meth:`ReplicaPool.resize` grows through ``replica_factory``
(a new replica joins healthy: eager PyTorch has no per-shape compile to
pre-warm); shrinking drains a replica and retires it once idle.

Supervision is pull mode on the runtime's clock: ``beat`` when the
forward starts, ``check`` when it returns.  Live-weight hot swap and its
rollout machine need checkpoints (ROADMAP.md Queue 1 item 12); the
parallel service model, quarantine and mesh-slice replicas belong to the
fleet runtime (item 13).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

from analytics_zoo_tpu_torch.resilience.errors import ReplicaWedged, StallError
from analytics_zoo_tpu_torch.resilience.watchdog import StallWatchdog
from analytics_zoo_tpu_torch.serving.batcher import AssembledBatch

logger = logging.getLogger("analytics_zoo_tpu_torch")

class Replica:
    """One supervised model replica.

    ``forward_fns[tier]`` is the tier's ``batch dict -> rows`` callable.
    ``service_hook(batch, rid)`` (the virtual-clock path) returns the
    simulated service seconds of a dispatch; with ``None`` the real
    forward's duration is what the watchdog sees."""

    def __init__(self, rid: int, forward_fns: Sequence[Callable], clock,
                 wedge_timeout_s: float,
                 service_hook: Optional[Callable[..., float]] = None,
                 fence_budget_s: Optional[float] = None):
        self.rid = rid
        self.forward_fns = list(forward_fns)
        self.clock = clock
        self.service_hook = service_hook
        self.fence_budget_s = fence_budget_s
        self.state = "healthy"       # healthy|fenced|draining
        self.restart_at: Optional[float] = None
        self.dispatches = 0
        self.wedges = 0
        self.inflight = 0            # batches currently on this replica
        self._fence_t: Optional[float] = None
        self.watchdog = StallWatchdog(timeout_s=wedge_timeout_s,
                                      name=f"replica-{rid}", clock=clock)

    def _fn_for(self, batch: AssembledBatch) -> Callable:
        try:
            return self.forward_fns[batch.tier]
        except IndexError:
            raise ReplicaWedged(f"replica {self.rid}: no forward for tier "
                                f"{batch.tier}") from None

    def sleep_guarded(self, seconds: float) -> None:
        """Advance the clock inside a supervised forward, bounded by the
        fence budget: crossing it sleeps up to the fence instant and
        raises :class:`ReplicaWedged` there.  With no budget a plain
        sleep."""
        if self._fence_t is None:
            self.clock.sleep(seconds)
            return
        now = self.clock.now()
        if now + seconds > self._fence_t:
            self.clock.sleep(max(self._fence_t - now, 0.0))
            raise ReplicaWedged(
                f"replica {self.rid}: forward wedged mid-flight — fenced "
                f"at the {self.fence_budget_s:.3f}s fence budget")
        self.clock.sleep(seconds)

    def forward(self, batch: AssembledBatch) -> Any:
        """Run one batch under stall supervision.  Raises
        :class:`ReplicaWedged` on a crash or a deadline overrun; the pool
        owns fencing and failover."""
        self.watchdog.beat()
        self.dispatches += 1
        self.inflight += 1
        t0 = self.clock.now()
        self._fence_t = (t0 + self.fence_budget_s
                         if self.fence_budget_s is not None else None)
        try:
            out = self._fn_for(batch)(batch.batch)
            if self.service_hook is not None:
                self.sleep_guarded(float(self.service_hook(batch,
                                                           self.rid)))
        except ReplicaWedged:
            raise
        except Exception as e:
            raise ReplicaWedged(
                f"replica {self.rid}: forward crashed mid-batch "
                f"({type(e).__name__}: {e})") from e
        finally:
            self.inflight -= 1
            self._fence_t = None
        try:
            self.watchdog.check()
        except StallError as e:
            raise ReplicaWedged(
                f"replica {self.rid}: forward wedged "
                f"({self.clock.now() - t0:.3f}s > "
                f"{self.watchdog.timeout_s:.3f}s deadline)") from e
        return out

    # -- lifecycle ----------------------------------------------------------
    def fence(self, restart_at: float) -> None:
        self.state = "fenced"
        self.wedges += 1
        self.restart_at = restart_at

    def maybe_restart(self, now: float) -> bool:
        """Re-admit the replica once its restart completed."""
        if self.state == "fenced" and self.restart_at is not None \
                and now >= self.restart_at:
            self.state = "healthy"
            self.restart_at = None
            # clear the latched stall and the age accumulated while fenced
            self.watchdog.reset()
            return True
        return False


class ReplicaPool:
    """Round-robin dispatch over healthy replicas with fence and
    exactly-once failover, plus :meth:`resize`.  ``events`` is the
    deterministic log of the pool.  ``fence_budget_s`` is given to every
    replica without its own; ``replica_factory(rid)`` builds growth
    replicas."""

    def __init__(self, replicas: Sequence[Replica], clock,
                 restart_s: float = 5.0,
                 fence_budget_s: Optional[float] = None,
                 replica_factory: Optional[Callable[[int], Replica]] = None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        self.clock = clock
        self.restart_s = float(restart_s)
        self.events: List[Dict[str, Any]] = []
        self.fence_budget_s = fence_budget_s
        self.replica_factory = replica_factory
        self._rr = 0
        self._rid_counter = max(r.rid for r in self.replicas) + 1
        for r in self.replicas:
            self._adopt(r)

    def _adopt(self, r: Replica) -> None:
        if r.fence_budget_s is None:
            r.fence_budget_s = self.fence_budget_s

    def _event(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)

    # -- selection -----------------------------------------------------------
    def _revive(self) -> None:
        now = self.clock.now()
        retired: List[Replica] = []
        for r in self.replicas:
            if r.maybe_restart(now):
                self._event({"kind": "replica_restarted",
                             "replica": r.rid, "t": round(now, 6)})
            elif r.state == "draining" and r.inflight == 0:
                retired.append(r)
        for r in retired:
            self.replicas.remove(r)
            self._event({"kind": "replica_retired", "replica": r.rid,
                         "t": round(now, 6)})

    def healthy(self) -> List[Replica]:
        self._revive()
        return [r for r in self.replicas if r.state == "healthy"]

    @property
    def size(self) -> int:
        """Replicas that are, or will come back as, dispatchable
        (healthy, or fenced with a restart pending)."""
        return sum(r.state != "draining" for r in self.replicas)

    def pick(self, exclude: Optional[int] = None) -> Optional[Replica]:
        """Deterministic round-robin over healthy replicas, skipping
        ``exclude`` (the replica that just failed this batch)."""
        ready = [r for r in self.healthy() if r.rid != exclude]
        if not ready:
            return None
        r = ready[self._rr % len(ready)]
        self._rr += 1
        return r

    def next_event_t(self, now: float) -> Optional[float]:
        """The next instant pool state changes (a restart completes)."""
        ts = [r.restart_at for r in self.replicas
              if r.state == "fenced" and r.restart_at is not None
              and r.restart_at > now]
        return min(ts) if ts else None

    # -- resize --------------------------------------------------------------
    def resize(self, n: int) -> Dict[str, List[int]]:
        """Grow or shrink the pool to ``n`` non-draining replicas.

        Growth builds replicas through ``replica_factory``; they join
        healthy.  Shrinking drains victims (fenced first, then the
        highest-rid healthy replica) and retires them once idle.
        Returns the rids acted on."""
        if n < 1:
            raise ValueError(f"pool size must be >= 1, got {n}")
        self._revive()
        actions: Dict[str, List[int]] = {"grown": [], "drained": []}
        while self.size < n:
            if self.replica_factory is None:
                raise RuntimeError("pool growth needs a replica_factory")
            rid = self._rid_counter
            self._rid_counter += 1
            r = self.replica_factory(rid)
            self._adopt(r)
            self.replicas.append(r)
            self._event({"kind": "replica_joined", "replica": rid,
                         "t": round(self.clock.now(), 6),
                         "state": r.state})
            actions["grown"].append(rid)
        while self.size > n:
            victims = [r for r in self.replicas if r.state == "fenced"]
            if not victims:
                victims = sorted((r for r in self.replicas
                                  if r.state == "healthy"),
                                 key=lambda r: -r.rid)
            victim = victims[0]
            victim.state = "draining"
            self._event({"kind": "replica_draining",
                         "replica": victim.rid,
                         "t": round(self.clock.now(), 6),
                         "inflight": victim.inflight})
            actions["drained"].append(victim.rid)
        self._revive()                  # idle victims retire at once
        return actions

    def hot_swap(self, *args, **kwargs):
        raise NotImplementedError(
            "ReplicaPool.hot_swap (live weights and the rollout machine) "
            "needs checkpoints: ROADMAP.md Queue 1 item 12")

    # -- dispatch with failover ----------------------------------------------
    def _fence(self, replica: Replica, err: ReplicaWedged) -> None:
        t = self.clock.now()
        restart_at = t + self.restart_s
        replica.fence(restart_at)
        self._event({"kind": "replica_fenced", "replica": replica.rid,
                     "t": round(t, 6),
                     "restart_at": round(restart_at, 6),
                     "error": str(err).split("\n")[0][:160]})
        logger.warning("serving: fenced replica %d (%s); restart at t=%.3f",
                       replica.rid, err, restart_at)

    def dispatch(self, batch: AssembledBatch) -> Any:
        """Run ``batch`` on a healthy replica; on :class:`ReplicaWedged`
        fence the replica and re-dispatch exactly once.  Raises
        :class:`ReplicaWedged` when the retry is spent or no healthy
        replica remains."""
        replica = self.pick()
        if replica is None:
            raise ReplicaWedged("no healthy replica available")
        try:
            return self.dispatch_on(replica, batch)
        except ReplicaWedged as err:
            self._fence(replica, err)
            if batch.redispatched:
                raise
            batch.redispatched = True
            backup = self.pick(exclude=replica.rid)
            if backup is None:
                raise ReplicaWedged(
                    f"batch failover from replica {replica.rid}: no healthy "
                    f"replica left") from err
            self._event({"kind": "failover", "from": replica.rid,
                         "to": backup.rid,
                         "t": round(self.clock.now(), 6),
                         "requests": [r.rid for r in batch.requests]})
            try:
                return self.dispatch_on(backup, batch)
            except ReplicaWedged as err2:
                self._fence(backup, err2)
                raise

    def dispatch_on(self, replica: Replica, batch: AssembledBatch) -> Any:
        for req in batch.requests:
            req.attempts += 1
        return replica.forward(batch)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "replicas": [{"rid": r.rid, "state": r.state,
                          "dispatches": r.dispatches, "wedges": r.wedges}
                         for r in self.replicas],
            "healthy": sum(r.state == "healthy" for r in self.replicas),
        }
