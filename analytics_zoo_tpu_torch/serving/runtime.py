"""The online serving runtime: a request-level API over the predictors
(counterpart of ``serving/runtime.py``, its single-model serial path).

One synchronous, clock-driven scheduler over

- :class:`~analytics_zoo_tpu_torch.serving.request.AdmissionQueue`:
  bounded, EDF, shed-before-dispatch;
- :class:`~analytics_zoo_tpu_torch.serving.batcher.DeadlineBatcher`:
  flush on full or urgent, over fixed geometries only;
- :class:`~analytics_zoo_tpu_torch.serving.replica.ReplicaPool`:
  StallWatchdog supervision, fence, exactly-once failover, restart;
- :class:`~analytics_zoo_tpu_torch.serving.ladder.DegradationLadder`:
  tier step-down under sustained overload, step-up with hysteresis;
- :class:`~analytics_zoo_tpu_torch.serving.metrics.ServingMetrics`.

Every scheduling decision happens inside :meth:`ServingRuntime.pump`,
reading time only through the injected clock.  On the card the loop
runs on a :class:`~analytics_zoo_tpu_torch.utils.clock.MonotonicClock`
and each tier forward ends in its readback; under a
:class:`~analytics_zoo_tpu_torch.utils.clock.VirtualClock` plus a
``service_time`` model the overload and failover story replays the same
way every run.

Usage::

    tiers = ssd_serving_tiers(model, param)       # pipelines.ssd
    rt = ServingRuntime(tiers, n_replicas=2, max_batch=8,
                        queue_capacity=64, default_deadline_s=0.2)
    req = rt.submit({"input": img})               # may raise ServerOverloaded
    rt.pump()                                     # run due scheduling work
    ...
    rt.drain()                                    # flush everything queued
    print(rt.metrics.snapshot())

Not ported, each refused where it is asked for: the fleet mode
(``models=``, ``parallel_replicas``, ``slice_width > 1``,
``device_budget``), the SLO engine, autoscaler, chaos injection,
telemetry spans and device-health sentinel, the compile-cost model of
pre-warming (``compile_s``), streaming sessions (ROADMAP.md Queue 1
item 13), and sharded serving (``specs=``) and live
weight swaps (item 12).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.resilience.errors import ReplicaWedged
from analytics_zoo_tpu_torch.serving.batcher import (AssembledBatch,
                                                     DeadlineBatcher,
                                                     ModelPlan)
from analytics_zoo_tpu_torch.serving.clock import Clock, MonotonicClock
from analytics_zoo_tpu_torch.serving.ladder import (DegradationLadder,
                                                    LadderPolicy, ServingTier)
from analytics_zoo_tpu_torch.serving.metrics import ServingMetrics
from analytics_zoo_tpu_torch.serving.replica import Replica, ReplicaPool
from analytics_zoo_tpu_torch.serving.request import AdmissionQueue, Request

#: the model name a single-model runtime serves under
DEFAULT_MODEL = "default"

# keyword → the ROADMAP item that ports it; a non-default value raises
_FLEET = "the fleet runtime, ROADMAP.md Queue 1 item 13"
_REFUSED = {
    "models": _FLEET, "parallel_replicas": _FLEET, "slice_width": _FLEET,
    "device_budget": _FLEET,
    "slo": "the SLO engine, ROADMAP.md Queue 1 item 13",
    "slo_params": "the SLO engine, ROADMAP.md Queue 1 item 13",
    "autoscaler": "the autoscaler, ROADMAP.md Queue 1 item 13",
    "chaos": "chaos injection, ROADMAP.md Queue 1 item 13",
    "obs": "telemetry spans, ROADMAP.md Queue 1 item 13",
    "health": "the device-health sentinel, ROADMAP.md Queue 1 item 13",
    "specs": "sharded serving, ROADMAP.md Queue 1 item 12",
    "compile_s": "the per-geometry compile cost of pre-warming, "
                 "ROADMAP.md Queue 1 item 13",
}


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} is not ported yet ({where})")


@dataclasses.dataclass
class ModelConfig:
    """One model's serving configuration: its degradation rungs
    (cheapest last), its batching plan and its ladder policy.  A
    single-model runtime builds one from its own arguments; several on
    one pool (``models=``) are the fleet runtime."""

    name: str
    tiers: Sequence[ServingTier]
    bucket_edges: Optional[Sequence[int]] = None
    pad_key: str = "input"
    length_key: Optional[str] = "n_frames"
    ladder_policy: Optional[LadderPolicy] = None

    def __post_init__(self):
        if not self.tiers:
            raise ValueError(f"model {self.name!r} needs at least one tier")

    def plan(self) -> ModelPlan:
        return ModelPlan(bucket_edges=self.bucket_edges,
                         pad_key=self.pad_key, length_key=self.length_key)


class ServingRuntime:
    """Deadline-aware serving over N supervised replicas.

    ``tiers``: degradation rungs, cheapest last (``pipelines.ssd.
    ssd_serving_tiers``).  ``service_time(edge, n, tier)``: estimated
    service seconds; required with a virtual clock (it also advances
    it); with the monotonic clock it may be ``None``, and the batcher
    learns a per-(edge, tier) EWMA from observed forwards.

    ``fence_budget_s`` bounds wedge detection (see
    :mod:`~analytics_zoo_tpu_torch.serving.replica`).
    ``retain_requests=False`` drops request objects once terminal;
    the accounting stays exact through counters.  The keywords of the
    parts not ported (module docstring) accept only their defaults."""

    def __init__(self, tiers: Optional[Sequence[ServingTier]] = None,
                 n_replicas: int = 2,
                 clock: Optional[Clock] = None,
                 queue_capacity: int = 64, max_batch: int = 8,
                 bucket_edges: Optional[Sequence[int]] = None,
                 pad_key: str = "input",
                 length_key: Optional[str] = "n_frames",
                 default_deadline_s: float = 1.0,
                 wedge_timeout_s: float = 10.0,
                 restart_s: float = 5.0,
                 service_time: Optional[Callable[..., float]] = None,
                 slack_margin_s: float = 0.0,
                 ladder_policy: Optional[LadderPolicy] = None,
                 decision_every: int = 8,
                 shed_expired: bool = True,
                 chaos=None, obs=None, specs=None, slo=None,
                 models=None, autoscaler=None,
                 fence_budget_s: Optional[float] = None,
                 compile_s: float = 0.0,
                 slo_params: Optional[Dict[str, Any]] = None,
                 retain_requests: bool = True,
                 parallel_replicas: bool = False,
                 slice_width: int = 1,
                 device_budget: Optional[int] = None,
                 health=None):
        given = {"models": models, "parallel_replicas": parallel_replicas,
                 "slice_width": slice_width != 1,
                 "device_budget": device_budget, "slo": slo,
                 "slo_params": slo_params, "autoscaler": autoscaler,
                 "chaos": chaos, "obs": obs, "health": health,
                 "specs": specs, "compile_s": compile_s != 0}
        for key, value in given.items():
            if value is not None and value is not False:
                _not_ported(f"ServingRuntime({key}=...)", _REFUSED[key])
        if not tiers:
            raise ValueError("need at least one ServingTier")
        self.tiers = list(tiers)
        self.model = ModelConfig(name=DEFAULT_MODEL, tiers=self.tiers,
                                 bucket_edges=bucket_edges, pad_key=pad_key,
                                 length_key=length_key,
                                 ladder_policy=ladder_policy)
        self.clock = clock or MonotonicClock()
        self.default_deadline_s = float(default_deadline_s)
        self.max_batch = int(max_batch)
        self.decision_every = int(decision_every)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.retain_requests = bool(retain_requests)
        self.metrics = ServingMetrics()
        self.requests: List[Request] = []      # every request submitted
        self._rid = itertools.count()
        self._window_shed = 0
        self._since_decision = 0
        # incremental accounting, exact when request objects are dropped
        self._submitted = 0
        self._by_state: Dict[str, int] = {}

        self.queue = AdmissionQueue(queue_capacity, self.clock,
                                    on_shed=self._on_shed,
                                    shed_expired=shed_expired)
        plan = self.model.plan()
        self.batcher = DeadlineBatcher(
            self.queue, max_batch, bucket_edges=plan.bucket_edges,
            pad_key=plan.pad_key, length_key=plan.length_key,
            service_time=service_time, slack_margin_s=slack_margin_s)

        def service_hook(batch: AssembledBatch, rid: int) -> float:
            return service_time(batch.edge, batch.n_valid, batch.tier)

        self._service_hook = (service_hook if service_time is not None
                              else None)
        self.pool = ReplicaPool(
            [self._make_replica(r) for r in range(n_replicas)],
            self.clock, restart_s=restart_s,
            fence_budget_s=fence_budget_s,
            replica_factory=self._make_replica)
        self.ladder = DegradationLadder(len(self.tiers),
                                        self.model.ladder_policy)

    # -- construction helpers ------------------------------------------------
    def _make_replica(self, rid: int) -> Replica:
        """Build one replica (also the pool's growth factory)."""
        return Replica(rid, [tier.forward for tier in self.tiers],
                       self.clock, self.wedge_timeout_s,
                       service_hook=self._service_hook)

    # -- shed observer -------------------------------------------------------
    def _on_shed(self, req: Request, cause: str) -> None:
        self.metrics.on_shed(cause)
        self._window_shed += 1
        self._account_terminal(req)

    def _account_terminal(self, req: Request) -> None:
        self._by_state[req.state] = self._by_state.get(req.state, 0) + 1

    # -- client API ----------------------------------------------------------
    def submit(self, payload: Any, deadline_s: Optional[float] = None,
               length: Optional[int] = None,
               model: Optional[str] = None) -> Request:
        """Admit one request; raises
        :class:`~analytics_zoo_tpu_torch.resilience.errors.ServerOverloaded`
        on a full queue (the request is still accounted, state ``shed``).
        ``length``: variable-axis length for bucket assignment."""
        if model is not None and model != DEFAULT_MODEL:
            raise KeyError(f"unknown model {model!r} (a single-model "
                           f"runtime serves {DEFAULT_MODEL!r})")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = self.clock.now()
        req = Request(rid=next(self._rid), payload=payload, arrival_t=now,
                      deadline_t=now + deadline_s, length=length)
        self._submitted += 1
        if self.retain_requests:
            self.requests.append(req)
        self.metrics.on_submit()
        self.queue.submit(req)          # may raise; _on_shed accounts it
        return req

    def open_session(self, *args, **kwargs):
        _not_ported("ServingRuntime.open_session (streaming sessions)",
                    "ROADMAP.md Queue 1 item 13")

    def submit_chunk(self, *args, **kwargs):
        _not_ported("ServingRuntime.submit_chunk (streaming sessions)",
                    "ROADMAP.md Queue 1 item 13")

    def close_session(self, *args, **kwargs):
        _not_ported("ServingRuntime.close_session (streaming sessions)",
                    "ROADMAP.md Queue 1 item 13")

    def hot_swap(self, *args, **kwargs):
        _not_ported("ServingRuntime.hot_swap (live weights from a "
                    "checkpoint)", "ROADMAP.md Queue 1 item 12")

    # -- scheduler -----------------------------------------------------------
    def pump(self, force: bool = False) -> int:
        """Run all currently due scheduling work: shed expired requests,
        assemble and dispatch every flush-ready batch.  Returns the
        number of batches dispatched.  Call after submits and after the
        clock moves."""
        dispatched = 0
        while True:
            batch = self.batcher.next_batch(self.ladder.tier, force=force)
            if batch is None:
                break
            self._dispatch(batch)
            dispatched += 1
        return dispatched

    def next_event_t(self) -> Optional[float]:
        """The next instant the pool changes state on its own (a restart
        completes)."""
        return self.pool.next_event_t(self.clock.now())

    def drain(self, max_batches: int = 10_000_000) -> None:
        """Force-flush everything still queued: every pending request
        reaches a terminal state."""
        for _ in range(max_batches):
            if self.pump(force=True) == 0 and len(self.queue) == 0:
                return
        raise RuntimeError("drain did not converge")

    # -- internals -----------------------------------------------------------
    def _dispatch(self, batch: AssembledBatch) -> None:
        self.metrics.on_batch(batch.n_valid, self.max_batch,
                              self.queue.depth)
        t0 = self.clock.now()
        try:
            out = self.pool.dispatch(batch)
        except ReplicaWedged as err:
            now = self.clock.now()
            for req in batch.requests:
                req.finish("failed", now, error=err)
                self._account_terminal(req)
                self.metrics.on_fail()
            self._after_dispatch(batch, t0, failed=True)
            return
        now = self.clock.now()
        rows = np.asarray(out)
        for i, req in enumerate(batch.requests):
            req.tier = batch.tier
            req.finish("done", now,
                       result=rows[i] if self.retain_requests else None)
            self._account_terminal(req)
            self.metrics.on_complete(now - req.arrival_t, batch.tier,
                                     missed=now > req.deadline_t)
        self._after_dispatch(batch, t0, failed=False)

    def _after_dispatch(self, batch: AssembledBatch, t0: float,
                        failed: bool) -> None:
        dt = self.clock.now() - t0
        if not failed and self.batcher.service_time is None:
            self.batcher.observe_service_s(batch.edge, dt, tier=batch.tier)
        if batch.redispatched:
            self.metrics.redispatches += 1
        self._since_decision += 1
        if self._since_decision >= self.decision_every:
            self._decide_window()

    def _decide_window(self) -> None:
        detail = {"shed_in_window": self._window_shed,
                  "queue_depth": self.queue.depth}
        depth_high = self.ladder.policy.depth_high * self.max_batch
        overloaded = (self._window_shed > 0
                      or self.queue.depth > depth_high)
        self.ladder.observe_window(overloaded, detail=detail)
        self._window_shed = 0
        self._since_decision = 0

    # -- observability -------------------------------------------------------
    def accounting(self) -> Dict[str, Any]:
        """Request conservation: once drained, every submitted request is
        in exactly one terminal state (``unaccounted == 0``)."""
        if self.retain_requests:
            by_state: Dict[str, int] = {}
            for r in self.requests:
                by_state[r.state] = by_state.get(r.state, 0) + 1
        else:
            by_state = dict(sorted(self._by_state.items()))
        terminal = sum(v for k, v in by_state.items()
                       if k in ("done", "shed", "timeout", "failed"))
        return {"submitted": self._submitted, "by_state": by_state,
                "terminal": terminal,
                "unaccounted": self._submitted - terminal}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "mesh": None,
            "metrics": self.metrics.snapshot(),
            "queue": self.queue.snapshot(),
            "replicas": self.pool.snapshot(),
            "accounting": self.accounting(),
            "ladder": self.ladder.snapshot(),
            "tiers": [{"name": t.name, "speed": t.speed,
                       "quality_note": t.quality_note}
                      for t in self.tiers],
        }
