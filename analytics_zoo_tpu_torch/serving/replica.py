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

**Mesh slices and the device budget**: a :class:`ReplicaSlice` occupies
``width`` devices (a sub-mesh of its own); ``ReplicaPool(device_budget=
...)`` clamps growth so that the width of the non-draining replicas never
exceeds it, and :meth:`ReplicaPool.quarantine` (the device-health
eviction) drains a replica, retires it and lowers the budget by its
width, once.

**The parallel service model**: a runtime on a virtual clock can give
each replica a busy horizon (``busy_until``): replicas serve
concurrently, each one batch at a time, and :meth:`ReplicaPool.pick_free`,
:meth:`~ReplicaPool.least_busy` and :meth:`~ReplicaPool.next_event_t`
schedule on those horizons.

**Sessions**: a batch with an ``affinity`` (a streaming session's
chunks) runs on its pinned replica or fails; it never fails over, since
the session's carry lives on that replica.  ``resize`` never drains a
replica in ``protected`` (the runtime's session-pinned set) while another
victim exists.

**Live weights**: :meth:`ReplicaPool.hot_swap` runs the rollout
machine: one replica at a time drains (``swap_drain``: never retired),
takes the new weights through ``install(replica)`` once idle, and
rejoins before the next one drains.  The machine advances from
``_revive``, on every ordinary dispatch cycle.  Replicas in ``last``
swap at the tail and those in ``swap_defer`` (the runtime's
session-pinned set) wait; a replica grown mid-rollout joins with the new
weights installed, one retired mid-rollout drops out of the order.

Supervision is pull mode on the runtime's clock: ``beat`` when the
forward starts, ``check`` when it returns.  The compile-cost model of
pre-warming is not ported (eager PyTorch compiles nothing per shape).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from analytics_zoo_tpu_torch.resilience.errors import ReplicaWedged, StallError
from analytics_zoo_tpu_torch.resilience.watchdog import StallWatchdog
from analytics_zoo_tpu_torch.serving.batcher import AssembledBatch
from analytics_zoo_tpu_torch.serving.request import DEFAULT_MODEL

logger = logging.getLogger("analytics_zoo_tpu_torch")


class Replica:
    """One supervised model replica.

    ``forward_fns`` maps the tier index to the tier's ``batch dict ->
    rows`` callable: a list for a single-model runtime, or ``{model:
    [tier fns]}`` for a multiplexed one.  ``service_hook(batch, rid)``
    (the virtual-clock path) returns the simulated service seconds of a
    dispatch; with ``None`` the real forward's duration is what the
    watchdog sees.  ``tier_objs`` (set by the runtime) holds the
    per-model :class:`~analytics_zoo_tpu_torch.serving.ladder.
    ServingTier` instances this replica serves, through which a dead
    session's state is evicted."""

    #: devices this replica occupies (a :class:`ReplicaSlice` sets its
    #: sub-mesh width): the unit of the pool's ``device_budget``
    width: int = 1

    def __init__(self, rid: int, forward_fns, clock,
                 wedge_timeout_s: float,
                 service_hook: Optional[Callable[..., float]] = None,
                 fence_budget_s: Optional[float] = None):
        self.rid = rid
        if isinstance(forward_fns, dict):
            self.forward_fns: Dict[str, List[Callable]] = {
                m: list(fns) for m, fns in forward_fns.items()}
        else:
            self.forward_fns = {DEFAULT_MODEL: list(forward_fns)}
        self.tier_objs: Dict[str, List[Any]] = {}
        self.clock = clock
        self.service_hook = service_hook
        self.fence_budget_s = fence_budget_s
        self.state = "healthy"       # healthy|fenced|draining
        #: draining for a live-weight swap, not for retirement: the
        #: rollout machine re-admits it with the new weights installed
        self.swap_drain = False
        self.restart_at: Optional[float] = None
        self.dispatches = 0
        self.wedges = 0
        self.inflight = 0            # batches currently on this replica
        #: the parallel service model: the instant this replica's last
        #: assigned batch completes
        self.busy_until = 0.0
        self._fence_t: Optional[float] = None
        self.watchdog = StallWatchdog(timeout_s=wedge_timeout_s,
                                      name=f"replica-{rid}", clock=clock)

    def _fn_for(self, batch: AssembledBatch) -> Callable:
        try:
            return self.forward_fns[batch.model][batch.tier]
        except (KeyError, IndexError):
            raise ReplicaWedged(
                f"replica {self.rid}: no forward for model "
                f"{batch.model!r} tier {batch.tier}") from None

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

    def forward(self, batch: AssembledBatch,
                fault: Optional[Callable[["Replica"], None]] = None) -> Any:
        """Run one batch under stall supervision.  ``fault`` (chaos) runs
        just before the tier: it may raise (a crash) or advance the
        clock through :meth:`sleep_guarded` (a slow forward).  Raises
        :class:`ReplicaWedged` on a crash or a deadline overrun; the pool
        owns fencing and failover."""
        self.watchdog.beat()
        self.dispatches += 1
        self.inflight += 1
        t0 = self.clock.now()
        self._fence_t = (t0 + self.fence_budget_s
                         if self.fence_budget_s is not None else None)
        try:
            if fault is not None:
                fault(self)
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


class ReplicaSlice(Replica):
    """A replica that is a mesh slice: its tiers run over a width-``w``
    sub-mesh (``specs``, the tiers' ``SpecSet`` on that sub-mesh through
    ``SpecSet.replace_mesh``), so one pool entry occupies ``w`` devices.
    A width-1 slice behaves as a plain :class:`Replica`."""

    def __init__(self, rid: int, forward_fns, clock,
                 wedge_timeout_s: float, width: int = 1,
                 specs: Optional[Any] = None, **kwargs):
        if width < 1:
            raise ValueError(f"slice width must be >= 1, got {width}")
        super().__init__(rid, forward_fns, clock, wedge_timeout_s,
                         **kwargs)
        self.width = int(width)
        self.specs = specs


class ReplicaPool:
    """Round-robin dispatch over healthy replicas with fence and
    exactly-once failover, plus :meth:`resize`.  ``events`` is the
    deterministic log of the pool; ``observer`` (set by the runtime) sees
    each event as it is appended (the flight recorder hangs off it).
    ``fence_budget_s`` is given to every replica without its own;
    ``replica_factory(rid)`` builds growth replicas; ``device_budget``
    caps the devices the non-draining replicas occupy."""

    def __init__(self, replicas: Sequence[Replica], clock,
                 restart_s: float = 5.0,
                 fence_budget_s: Optional[float] = None,
                 replica_factory: Optional[Callable[[int], Replica]] = None,
                 observer: Optional[Callable[[Dict[str, Any]], None]]
                 = None,
                 device_budget: Optional[int] = None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        self.clock = clock
        self.restart_s = float(restart_s)
        self.events: List[Dict[str, Any]] = []
        self.observer = observer
        self.fence_budget_s = fence_budget_s
        self.replica_factory = replica_factory
        #: the device ceiling: growth stops where the non-draining
        #: replicas' width would exceed it; a quarantine lowers it
        self.device_budget = device_budget
        self._rr = 0
        self._rid_counter = max(r.rid for r in self.replicas) + 1
        #: the active rollout (None between rollouts), see hot_swap
        self._swap: Optional[Dict[str, Any]] = None
        #: rids the rollout must not drain yet (the runtime refreshes it
        #: with the session-pinned set every pump)
        self.swap_defer: Set[int] = set()
        self.swaps_completed = 0
        self.swaps_started = 0
        self.last_rollout: Optional[Dict[str, Any]] = None
        for r in self.replicas:
            self._adopt(r)

    def _adopt(self, r: Replica) -> None:
        if r.fence_budget_s is None:
            r.fence_budget_s = self.fence_budget_s

    def _event(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)
        if self.observer is not None:
            self.observer(ev)

    # -- selection -----------------------------------------------------------
    def _revive(self) -> None:
        now = self.clock.now()
        retired: List[Replica] = []
        for r in self.replicas:
            if r.maybe_restart(now):
                self._event({"kind": "replica_restarted",
                             "replica": r.rid, "t": round(now, 6)})
            elif r.state == "draining" and not r.swap_drain \
                    and r.inflight == 0 and r.busy_until <= now:
                retired.append(r)
        for r in retired:
            self.replicas.remove(r)
            self._event({"kind": "replica_retired", "replica": r.rid,
                         "t": round(now, 6)})
        self._step_rollout(now)

    def healthy(self) -> List[Replica]:
        self._revive()
        return [r for r in self.replicas if r.state == "healthy"]

    @property
    def size(self) -> int:
        """Replicas that are, or will come back as, dispatchable
        (healthy, or fenced with a restart pending)."""
        return sum(r.state != "draining" for r in self.replicas)

    @property
    def devices_used(self) -> int:
        """Devices the non-draining replicas occupy (their widths)."""
        return sum(r.width for r in self.replicas
                   if r.state != "draining")

    def pick(self, exclude: Optional[int] = None) -> Optional[Replica]:
        """Deterministic round-robin over healthy replicas, skipping
        ``exclude`` (the replica that just failed this batch)."""
        ready = [r for r in self.healthy() if r.rid != exclude]
        if not ready:
            return None
        r = ready[self._rr % len(ready)]
        self._rr += 1
        return r

    def replica_by_rid(self, rid: int) -> Optional[Replica]:
        for r in self.replicas:
            if r.rid == rid:
                return r
        return None

    def quarantine(self, rid: int, reason: str = "device_health") -> bool:
        """Evict a replica's devices from the fleet: drain then retire
        (in-flight work finishes or fails over once) and lower
        ``device_budget`` by its width, so that nothing is seated on the
        quarantined devices again.  False when ``rid`` is unknown or
        already draining (the budget is lowered exactly once)."""
        r = self.replica_by_rid(rid)
        if r is None or r.state == "draining":
            return False
        width = r.width
        r.state = "draining"
        if self.device_budget is not None:
            self.device_budget = max(self.device_budget - width, 0)
        self._event({"kind": "replica_quarantined", "replica": rid,
                     "reason": reason, "width": width,
                     "device_budget": self.device_budget,
                     "t": round(self.clock.now(), 6)})
        logger.warning("pool: replica %d quarantined (%s) — draining; "
                       "device budget now %s", rid, reason,
                       self.device_budget)
        return True

    # -- the parallel service model -----------------------------------------
    def any_free(self, now: float) -> bool:
        return any(r.busy_until <= now for r in self.healthy())

    def pick_free(self, now: float,
                  exclude: Optional[int] = None) -> Optional[Replica]:
        """Round-robin over the healthy replicas free at ``now``."""
        ready = [r for r in self.healthy()
                 if r.busy_until <= now and r.rid != exclude]
        if not ready:
            return None
        r = ready[self._rr % len(ready)]
        self._rr += 1
        return r

    def least_busy(self) -> Optional[Replica]:
        """The healthy replica with the earliest busy horizon (where a
        forced drain queues work when none is free)."""
        ready = self.healthy()
        if not ready:
            return None
        return min(ready, key=lambda r: (r.busy_until, r.rid))

    def next_event_t(self, now: float) -> Optional[float]:
        """The next instant pool state changes: a busy replica frees or a
        restart completes."""
        ts: List[float] = []
        for r in self.replicas:
            if r.busy_until > now:
                ts.append(r.busy_until)
            if r.state == "fenced" and r.restart_at is not None \
                    and r.restart_at > now:
                ts.append(r.restart_at)
        return min(ts) if ts else None

    # -- resize --------------------------------------------------------------
    def resize(self, n: int, prewarm: bool = True,
               protected: Sequence[int] = ()) -> Dict[str, List[int]]:
        """Grow or shrink the pool to ``n`` non-draining replicas.

        Growth builds replicas through ``replica_factory``; they join
        healthy (``prewarm`` is recorded in the event), and growth stops
        where ``device_budget`` would be exceeded (a
        ``resize_budget_clamped`` event).  Shrinking drains victims (fenced first, then the
        highest-rid healthy replica; never one in ``protected``, the
        session-pinned replicas) and retires them once idle.  Returns
        the rids acted on."""
        if n < 1:
            raise ValueError(f"pool size must be >= 1, got {n}")
        self._revive()
        protected_set = set(protected)
        actions: Dict[str, List[int]] = {"grown": [], "drained": []}
        while self.size < n:
            if self.replica_factory is None:
                raise RuntimeError("pool growth needs a replica_factory")
            rid = self._rid_counter
            self._rid_counter += 1
            r = self.replica_factory(rid)
            if self.device_budget is not None \
                    and self.devices_used + r.width > self.device_budget:
                # clamped at the actuator, whatever the policy asked
                self._rid_counter -= 1
                self._event({"kind": "resize_budget_clamped",
                             "t": round(self.clock.now(), 6),
                             "requested": int(n), "size": self.size,
                             "devices_used": self.devices_used,
                             "width": r.width,
                             "device_budget": self.device_budget})
                break
            self._adopt(r)
            self.replicas.append(r)
            now = self.clock.now()
            if self._swap is not None:
                # growth mid-rollout joins with the new weights installed:
                # it must not serve the retiring checkpoint, and the
                # rollout must not drain it again
                self._swap["install"](r)
                self._swap["swapped"].append(rid)
                self._event({"kind": "swap_installed", "replica": rid,
                             "t": round(now, 6),
                             "checkpoint": self._swap["checkpoint"],
                             "grown": True})
            self._event({"kind": "replica_joined", "replica": rid,
                         "t": round(now, 6), "prewarm": bool(prewarm),
                         "state": r.state})
            actions["grown"].append(rid)
        while self.size > n:
            # a fenced replica is the cheapest victim, unless sessions are
            # pinned to it: it restarts with their state intact
            victims = [r for r in self.replicas if r.state == "fenced"
                       and r.rid not in protected_set]
            if not victims:
                victims = sorted((r for r in self.replicas
                                  if r.state == "healthy"
                                  and r.rid not in protected_set),
                                 key=lambda r: -r.rid)
            if not victims:
                break                   # everything left is protected
            victim = victims[0]
            victim.state = "draining"
            self._event({"kind": "replica_draining",
                         "replica": victim.rid,
                         "t": round(self.clock.now(), 6),
                         "inflight": victim.inflight})
            actions["drained"].append(victim.rid)
        self._revive()                  # idle victims retire at once
        return actions

    # -- live-weight hot swap (the rollout machine) ---------------------------
    @property
    def rollout_active(self) -> bool:
        return self._swap is not None

    def hot_swap(self, checkpoint: str, install: Callable[[Replica], None],
                 warm_s: Optional[float] = None,
                 last: Sequence[int] = (),
                 verified: bool = False) -> Dict[str, Any]:
        """Start a rollout: one replica at a time drains (``draining``
        with the ``swap_drain`` mark), ``install(replica)`` swaps its
        weights once it is idle, and it rejoins before the next one
        drains.  ``checkpoint`` is the snapshot the weights came from;
        its manifest is verified here unless the caller already did
        (``verified=True``, as ``ServingRuntime.hot_swap`` after its
        verified load), so a truncated publish never starts a drain.
        ``last`` rids go to the tail of the order.
        In-flight batches on a draining replica finish or take the
        exactly-once failover: ``accounting()`` conserves every request.
        ``warm_s`` is the reference's re-warm time, which needs the
        compile-cost model (a Known deviation of item 13): only ``None``
        is accepted."""
        if self._swap is not None:
            raise RuntimeError(
                f"hot_swap: rollout of {self._swap['checkpoint']!r} "
                f"still in progress")
        if warm_s is not None:
            raise NotImplementedError(
                "ReplicaPool.hot_swap(warm_s=...) needs the compile-cost "
                "model of pre-warming, which eager PyTorch does not have "
                "(ROADMAP.md Known deviations, item 13)")
        if not verified:
            from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt

            ckpt.verify_snapshot(checkpoint)
        last_set = set(last)
        order = sorted(r.rid for r in self.replicas
                       if r.state != "draining" and r.rid not in last_set)
        order += sorted(r.rid for r in self.replicas
                        if r.state != "draining" and r.rid in last_set)
        self._swap = {"checkpoint": checkpoint, "install": install,
                      "pending": order, "current": None, "swapped": []}
        self.swaps_started += 1
        self._event({"kind": "swap_rollout_started",
                     "checkpoint": checkpoint, "order": list(order),
                     "t": round(self.clock.now(), 6)})
        self._step_rollout(self.clock.now())
        return dict(self._swap, install=None)

    def _step_rollout(self, now: float) -> None:
        """Advance the active rollout; idempotent, called from
        ``_revive`` so the machine moves whenever pool state is read."""
        sw = self._swap
        if sw is None:
            return
        cur = self.replica_by_rid(sw["current"]) \
            if sw["current"] is not None else None
        if sw["current"] is not None and cur is None:
            sw["current"] = None     # the victim retired mid-drain (resize)
        if cur is not None:
            if cur.state == "healthy":
                # fenced mid-drain and restarted: resume the drain
                cur.state = "draining"
            if cur.state == "draining" and cur.inflight == 0 \
                    and cur.busy_until <= now:
                sw["install"](cur)
                cur.swap_drain = False
                sw["swapped"].append(cur.rid)
                self._event({"kind": "swap_installed", "replica": cur.rid,
                             "t": round(now, 6),
                             "checkpoint": sw["checkpoint"]})
                cur.state = "healthy"
                cur.watchdog.reset()
                self._event({"kind": "swap_rejoined", "replica": cur.rid,
                             "t": round(now, 6)})
                sw["current"] = None
            return              # one replica at a time
        # the next victim (deferred rids wait, retired ones drop out)
        while sw["pending"]:
            rid = sw["pending"][0]
            r = self.replica_by_rid(rid)
            if r is None or (r.state == "draining" and not r.swap_drain):
                sw["pending"].pop(0)    # retired or retiring
                continue
            if rid in self.swap_defer:
                later = [x for x in sw["pending"]
                         if x not in self.swap_defer
                         and self.replica_by_rid(x) is not None]
                if not later:
                    return              # everything left is deferred
                rid = later[0]
                r = self.replica_by_rid(rid)
                sw["pending"].remove(rid)
            else:
                sw["pending"].pop(0)
            if r.state != "healthy":
                # fenced: back to the head of the queue until it restarts
                sw["pending"].insert(0, rid)
                return
            r.state = "draining"
            r.swap_drain = True
            sw["current"] = rid
            self._event({"kind": "swap_drain", "replica": rid,
                         "t": round(now, 6), "inflight": r.inflight})
            self._step_rollout(now)     # an idle victim installs at once
            return
        self.swaps_completed += 1
        self.last_rollout = {"checkpoint": sw["checkpoint"],
                             "swapped": list(sw["swapped"])}
        self._event({"kind": "swap_rollout_complete",
                     "checkpoint": sw["checkpoint"],
                     "swapped": list(sw["swapped"]), "t": round(now, 6)})
        self._swap = None

    def abort_rollout(self) -> List[int]:
        """Stop the rollout (the rollback path): the draining victim is
        re-admitted unswapped, and the rids that already took the new
        weights are returned for the caller to revert.  Empty when no
        rollout is active."""
        sw = self._swap
        if sw is None:
            return []
        cur = self.replica_by_rid(sw["current"]) \
            if sw["current"] is not None else None
        if cur is not None and cur.swap_drain:
            cur.swap_drain = False
            if cur.state == "draining":
                cur.state = "healthy"
                cur.watchdog.reset()
        swapped = list(sw["swapped"])
        self._event({"kind": "swap_rollout_aborted",
                     "checkpoint": sw["checkpoint"], "swapped": swapped,
                     "t": round(self.clock.now(), 6)})
        self._swap = None
        return swapped

    # -- dispatch with failover ----------------------------------------------
    def _fence(self, replica: Replica, err: ReplicaWedged,
               at: Optional[float] = None) -> None:
        """Fence ``replica``; ``at`` pins the fence instant (the parallel
        service model detects a failure on the replica's own horizon,
        which the clock has not reached)."""
        t = self.clock.now() if at is None else float(at)
        restart_at = t + self.restart_s
        replica.fence(restart_at)
        self._event({"kind": "replica_fenced", "replica": replica.rid,
                     "t": round(t, 6),
                     "restart_at": round(restart_at, 6),
                     "error": str(err).split("\n")[0][:160]})
        logger.warning("serving: fenced replica %d (%s); restart at t=%.3f",
                       replica.rid, err, restart_at)

    def dispatch(self, batch: AssembledBatch,
                 fault_for: Optional[Callable[[Replica], Optional[
                     Callable[[Replica], None]]]] = None) -> Any:
        """Run ``batch`` on a healthy replica; on :class:`ReplicaWedged`
        fence the replica and re-dispatch exactly once.  Raises
        :class:`ReplicaWedged` when the retry is spent or no healthy
        replica remains.  A batch with an ``affinity`` runs on that
        replica or fails: failing over would decode its sessions from
        zeroed state.  ``fault_for(replica)`` (chaos) gives the fault
        hook of a dispatch to ``replica``, or None."""
        if batch.affinity is not None:
            self._revive()
            replica = self.replica_by_rid(batch.affinity)
            if replica is None or replica.state != "healthy":
                raise ReplicaWedged(
                    f"session replica {batch.affinity} unavailable "
                    f"(state: {replica.state if replica else 'retired'})"
                    f" — session state lost")
            fault = fault_for(replica) if fault_for is not None else None
            try:
                return self.dispatch_on(replica, batch, fault)
            except ReplicaWedged as err:
                self._fence(replica, err)
                raise
        replica = self.pick()
        if replica is None:
            raise ReplicaWedged("no healthy replica available")
        try:
            fault = fault_for(replica) if fault_for is not None else None
            return self.dispatch_on(replica, batch, fault)
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
            fault = fault_for(backup) if fault_for is not None else None
            try:
                return self.dispatch_on(backup, batch, fault)
            except ReplicaWedged as err2:
                self._fence(backup, err2)
                raise

    def dispatch_on(self, replica: Replica, batch: AssembledBatch,
                    fault: Optional[Callable[[Replica], None]] = None
                    ) -> Any:
        for req in batch.requests:
            req.attempts += 1
        return replica.forward(batch, fault=fault)

    def snapshot(self) -> Dict[str, Any]:
        out = {
            "replicas": [{"rid": r.rid, "state": r.state,
                          "dispatches": r.dispatches, "wedges": r.wedges}
                         for r in self.replicas],
            "healthy": sum(r.state == "healthy" for r in self.replicas),
        }
        if self.swaps_started:          # keyed in once a rollout ran
            out["rollouts"] = {
                "started": self.swaps_started,
                "completed": self.swaps_completed,
                "active": self._swap is not None,
                "last": dict(self.last_rollout) if self.last_rollout
                else None,
            }
        return out
