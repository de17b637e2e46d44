"""The online serving runtime: a request-level API over the predictors
(counterpart of ``serving/runtime.py``, its serial path).

One synchronous, clock-driven scheduler over

- :class:`~analytics_zoo_tpu_torch.serving.request.AdmissionQueue`:
  bounded, EDF, shed-before-dispatch;
- :class:`~analytics_zoo_tpu_torch.serving.batcher.DeadlineBatcher`:
  flush on full or urgent, over fixed geometries only;
- :class:`~analytics_zoo_tpu_torch.serving.replica.ReplicaPool`:
  StallWatchdog supervision, fence, exactly-once failover, restart;
- :class:`~analytics_zoo_tpu_torch.serving.ladder.DegradationLadder`:
  tier step-down under sustained overload, step-up with hysteresis;
- :class:`~analytics_zoo_tpu_torch.serving.metrics.ServingMetrics`;
- optionally :class:`~analytics_zoo_tpu_torch.obs.slo.SloEvaluator`:
  the ladder then steps on SLO burn instead of the raw shed flag.

Every scheduling decision happens inside :meth:`ServingRuntime.pump`,
reading time only through the injected clock.  On the card the loop
runs on a :class:`~analytics_zoo_tpu_torch.utils.clock.MonotonicClock`
and each tier forward ends in its readback; under a
:class:`~analytics_zoo_tpu_torch.utils.clock.VirtualClock` plus a
``service_time`` model the overload and failover story replays the same
way every run.

**Multiplexed mode**: ``models=[ModelConfig(...), ...]`` in place of
``tiers`` schedules several models on the shared replica pool: per-model
batching geometry (models never share a batch), ladders, SLOs whose burn
rates weight the EDF dispatch order, and service-time EWMAs.  A
streaming session model (``ModelConfig(streaming=True)``) is served
through :meth:`ServingRuntime.open_session`, which pins the session to a
replica (where its carry lives), :meth:`ServingRuntime.submit_chunk`,
whose per-chunk deadlines are incremental and monotone (so EDF keeps the
chunks in order), and :meth:`ServingRuntime.close_session`.

Usage::

    tiers = ssd_serving_tiers(model, param)       # pipelines.ssd
    rt = ServingRuntime(tiers, n_replicas=2, max_batch=8,
                        queue_capacity=64, default_deadline_s=0.2)
    req = rt.submit({"input": img})               # may raise ServerOverloaded
    rt.pump()                                     # run due scheduling work
    ...
    rt.drain()                                    # flush everything queued
    print(rt.metrics.snapshot())

**Live weights**: :meth:`ServingRuntime.hot_swap` rolls a published
checkpoint out to the pool with no downtime: verify and load onto the
card, a seeded canary mirror of live traffic judged by its own
``SloEvaluator``, the pool's one-replica-at-a-time rollout, an
exactly-once rollback to the previous weights (or ``serve-lkg``), and
the ``serve-lkg`` promotion after clean decision windows.  A model swaps
through its ``ModelConfig.weights_to_tiers``.

**Telemetry**: ``obs=`` (an :class:`~analytics_zoo_tpu_torch.obs.
Observability`, which follows the runtime's clock) records each
request's trace ``req-<rid>`` (a ``request`` root opened at submit, its
``queue`` span until the batch is assembled, its ``dispatch`` span
until the batch returns), a ``batch-<n>`` trace a dispatch, every pool
event (fences, failovers, restarts, swaps), sessions opened, closed and
failed, swaps and SLO decisions in the flight recorder; the runtime's
metrics go to the bundle's registry, and a replica fence dumps the
black box when ``obs.dump_path`` is set.
:class:`~analytics_zoo_tpu_torch.obs.trace.TraceStore` splits each
request's latency over the recording.

**Sharded tiers**: ``specs=`` (the ``SpecSet`` the tiers were built
with, ``ssd_serving_tiers(specs=...)`` and the others) runs this runtime
on the mesh's first rank and :func:`~analytics_zoo_tpu_torch.serving.
follower.serve_follower` on every other rank: each dispatch announces
its rung and batch to the followers before it runs, a hot swap's tier
builds send them the loaded state, a follower's exception fails the
dispatch here (fenced or failed over as any failed forward), and
:meth:`ServingRuntime.close` stops them (``serving/follower.py``).
``snapshot()["mesh"]`` records the mesh.

**The fleet**: ``parallel_replicas=True`` (with a ``service_time``
model on a virtual clock) serves the replicas concurrently, each batch
completing on its replica's own busy horizon while the real forwards
run; ``autoscaler=`` (an :class:`~analytics_zoo_tpu_torch.serving.
autoscale.Autoscaler`) turns each SLO decision's ``scale_hint`` into
``ReplicaPool.resize`` calls (shrink drains, session-pinned replicas
are spared) or a width :class:`~analytics_zoo_tpu_torch.serving.
autoscale.Reshape`; ``chaos=`` (a :class:`~analytics_zoo_tpu_torch.
resilience.chaos.ChaosMonkey`) applies its ``slow_forward``,
``replica_crash`` and ``slow_device`` windows by dispatch index;
``health=`` (a :class:`~analytics_zoo_tpu_torch.resilience.health.
HealthSentinel`) takes each parallel completion's service time (never a
chaos delay) into its straggler ladder, and a flagged replica is
quarantined (drained, retired, ``device_budget`` lowered by its width).
``slice_width=w`` makes each replica a
:class:`~analytics_zoo_tpu_torch.serving.replica.ReplicaSlice` of ``w``
devices; over processes each slice is a sub-mesh of its own, cut by
:class:`~analytics_zoo_tpu_torch.serving.follower.SliceLayout` on every
rank (``serving/follower.py``).

Not ported: the compile-cost model of pre-warming (``compile_s``, a
swap's ``warm_s``): eager PyTorch compiles nothing per shape, so both
are refused (ROADMAP.md Known deviations, item 13).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from analytics_zoo_tpu_torch.obs.slo import SloEvaluator
from analytics_zoo_tpu_torch.resilience.errors import (ReplicaWedged,
                                                       ServerOverloaded)
from analytics_zoo_tpu_torch.serving.autoscale import OCCUPANCY_KNEE, Reshape
from analytics_zoo_tpu_torch.serving.batcher import (AssembledBatch,
                                                     DeadlineBatcher,
                                                     ModelPlan)
from analytics_zoo_tpu_torch.serving.clock import Clock, MonotonicClock
from analytics_zoo_tpu_torch.serving.ladder import (DegradationLadder,
                                                    LadderPolicy, ServingTier)
from analytics_zoo_tpu_torch.serving.metrics import ServingMetrics
from analytics_zoo_tpu_torch.serving.replica import (Replica, ReplicaPool,
                                                     ReplicaSlice)
from analytics_zoo_tpu_torch.serving.request import (DEFAULT_MODEL,
                                                     AdmissionQueue, Request)

logger = logging.getLogger("analytics_zoo_tpu_torch")

_ITEM_13 = "ROADMAP.md Known deviations, item 13"
# keyword → what it is and where the deviation is recorded; a non-default
# value raises
_REFUSED = {
    "compile_s": ("the per-geometry compile cost of pre-warming",
                  _ITEM_13),
}


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} is not served: eager PyTorch has "
                              f"no per-shape compile cost ({where})")


@dataclasses.dataclass
class ModelConfig:
    """One model on the shared pool.

    ``tiers``: its degradation rungs, cheapest last.  ``tier_factory``
    (optional): ``replica rid -> [ServingTier]`` building per-replica
    tier instances, so that each replica has its own session store;
    ``tiers`` stays the template (names, speeds).  ``bucket_edges``,
    ``pad_key``, ``length_key``, ``max_batch``: the batching plan
    (:class:`~analytics_zoo_tpu_torch.serving.batcher.ModelPlan`).
    ``default_deadline_s``: the model's deadline when ``submit`` passes
    none (``None`` = the runtime's).  ``slos``: its objectives (e.g.
    :func:`~analytics_zoo_tpu_torch.obs.slo.model_slos`), whose burn
    rates drive its ladder and its dispatch weight.  ``streaming``: a
    session model, served through ``open_session``/``submit_chunk``,
    with ``chunk_deadline_s`` the per-chunk incremental deadline.
    ``weights_to_tiers``: ``(loaded_state, rid) -> [ServingTier]``, how
    :meth:`ServingRuntime.hot_swap` turns a checkpoint's state (loaded
    onto the swap's device) into this model's tier stack for replica
    ``rid``; ``rid == -1`` builds the canary mirror.  Without it the
    model cannot live-swap."""

    name: str
    tiers: Sequence[ServingTier]
    tier_factory: Optional[Callable[[int], Sequence[ServingTier]]] = None
    weights_to_tiers: Optional[Callable[..., Sequence[ServingTier]]] = None
    bucket_edges: Optional[Sequence[int]] = None
    pad_key: str = "input"
    length_key: Optional[str] = "n_frames"
    max_batch: Optional[int] = None
    default_deadline_s: Optional[float] = None
    slos: Sequence[Any] = ()
    streaming: bool = False
    chunk_deadline_s: float = 0.5
    ladder_policy: Optional[LadderPolicy] = None

    def __post_init__(self):
        if not self.tiers:
            raise ValueError(f"model {self.name!r} needs at least one tier")
        if self.streaming and self.tier_factory is None:
            raise ValueError(
                f"streaming model {self.name!r} needs a tier_factory — "
                f"session carry state must live per replica for session "
                f"affinity to mean anything")
        if self.streaming and self.bucket_edges \
                and len(self.bucket_edges) > 1:
            # chunk order rests on EDF within ONE (model, affinity, edge)
            # group: with several edges a later chunk's bucket could
            # flush first
            raise ValueError(
                f"streaming model {self.name!r} may declare at most one "
                f"bucket edge — multiple edges would let a later chunk's "
                f"bucket flush before an earlier chunk's, breaking "
                f"in-order decode")

    def plan(self) -> ModelPlan:
        return ModelPlan(bucket_edges=self.bucket_edges,
                         pad_key=self.pad_key, length_key=self.length_key,
                         max_batch=self.max_batch, streaming=self.streaming)


class ServingRuntime:
    """Deadline-aware serving over N supervised replicas (module docstring:
    "The fleet" for ``parallel_replicas``, ``autoscaler``, ``chaos``,
    ``health``, ``slice_width`` and ``device_budget``).

    ``tiers``: degradation rungs, cheapest last (``pipelines.ssd.
    ssd_serving_tiers``, ``pipelines.deepspeech2.ds2_serving_tiers``):
    the single-model path.  ``models``: a list of :class:`ModelConfig`
    instead (``tiers`` then ``None``), the multiplexed path.
    ``service_time(edge, n, tier)`` (single model) or
    ``service_time(model, edge, n, tier)`` (multiplexed): estimated
    service seconds; required with a virtual clock (it also advances
    it); with the monotonic clock it may be ``None``, and the batcher
    learns a per-(model, edge, tier) EWMA from observed forwards.

    ``slo``: an :class:`~analytics_zoo_tpu_torch.obs.slo.SloEvaluator`;
    each decision window then feeds the registry through its burn-rate
    evaluation and the ladder steps on ``SloDecision.overloaded``.
    Multiplexed, the runtime builds it from the models' ``slos`` when
    none is given (``slo_params`` are its keywords), maps each burning
    SLO to its model's ladder, and sets each model's dispatch weight to
    ``1 + its worst fast burn``, capped at ``weight_cap``.

    ``fence_budget_s`` bounds wedge detection (see
    :mod:`~analytics_zoo_tpu_torch.serving.replica`).
    ``retain_requests=False`` drops request objects once terminal;
    the accounting stays exact through counters.  ``obs``: an
    :class:`~analytics_zoo_tpu_torch.obs.Observability` (module
    docstring, "Telemetry"); its registry then holds the metrics.
    ``compile_s`` accepts only 0 (module docstring)."""

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
                 models: Optional[Sequence[ModelConfig]] = None,
                 autoscaler=None,
                 fence_budget_s: Optional[float] = None,
                 compile_s: float = 0.0,
                 slo_params: Optional[Dict[str, Any]] = None,
                 weight_cap: float = 4.0,
                 retain_requests: bool = True,
                 parallel_replicas: bool = False,
                 slice_width: int = 1,
                 device_budget: Optional[int] = None,
                 health=None):
        if compile_s != 0:
            what, where = _REFUSED["compile_s"]
            _not_ported(f"ServingRuntime(compile_s=...) ({what})", where)
        if models is not None:
            if tiers is not None:
                raise ValueError("pass tiers= OR models=, not both")
            if not models:
                raise ValueError("models= must name at least one model")
            self.models: Dict[str, ModelConfig] = {}
            for cfg in models:
                if cfg.name in self.models:
                    raise ValueError(f"duplicate model name {cfg.name!r}")
                self.models[cfg.name] = cfg
            self._multi = True
            self.tiers = None
        else:
            if not tiers:
                raise ValueError("need at least one ServingTier")
            self.tiers = list(tiers)
            self.models = {DEFAULT_MODEL: ModelConfig(
                name=DEFAULT_MODEL, tiers=self.tiers,
                bucket_edges=bucket_edges, pad_key=pad_key,
                length_key=length_key)}
            self._multi = False
        self.specs = specs
        self._leaders: Dict[int, Any] = {}
        if slice_width < 1:
            raise ValueError(f"slice_width must be >= 1, got {slice_width}")
        self.slice_width = int(slice_width)
        self._layout = None
        self._slice_of: Dict[int, int] = {}     # rid -> slice of the layout
        self._dead_slices: Set[int] = set()     # slices quarantined
        if specs is not None:
            self._lead(specs, device_budget)
        self.clock = clock or MonotonicClock()
        self.default_deadline_s = float(default_deadline_s)
        self.max_batch = int(max_batch)
        self.decision_every = int(decision_every)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.weight_cap = float(weight_cap)
        self.retain_requests = bool(retain_requests)
        self.chaos = chaos
        # the device-health sentinel: parallel completions feed its
        # straggler ladder; a flagged replica is quarantined
        self.health = health
        # the parallel service model: a batch goes to a free replica and
        # completes on that replica's busy horizon; replicas serve
        # concurrently, so the pool's size is its capacity
        self.parallel = bool(parallel_replicas)
        if self.parallel and service_time is None:
            raise ValueError("parallel_replicas needs a service_time "
                             "model (it is a virtual-time mode)")
        # the telemetry spine: request spans into the flight recorder,
        # metrics into the bundle's registry
        self.obs = obs
        if obs is not None:
            obs.adopt_clock(self.clock)
        self.metrics = ServingMetrics(
            registry=obs.registry if obs is not None else None)
        self._slo_params = dict(slo_params or {})
        self._service_time = service_time
        # live-weight swaps: one rollout at a time (canary, then the
        # pool's machine); _swap_ctl is None between rollouts, _swap_log
        # keeps the history, _lkg the pending serve-lkg hysteresis
        self._swap_ctl: Optional[Dict[str, Any]] = None
        self._swap_counter = 0
        self._swap_log: List[Dict[str, Any]] = []
        self._swap_stats = {"completed": 0, "rollbacks": 0, "trips": 0,
                            "lkg_promotions": 0}
        self._lkg: Optional[Dict[str, Any]] = None
        self.autoscaler = autoscaler
        if autoscaler is not None and autoscaler.registry is None:
            autoscaler.registry = self.metrics.registry
        # each model's current slice width (a reshape moves one wider);
        # the service model divides by the occupancy-limited speedup
        self._model_width: Dict[str, int] = {
            name: self.slice_width for name in self.models}
        #: per-model batch-fill EWMA, the autoscaler's saturation signal
        self._fill_ewma: Dict[str, float] = {}
        self._reshape_log: List[Dict[str, Any]] = []
        # the SLO engine: built from the models' declared SLOs when none
        # is passed; each SLO maps back to its model's ladder
        self._slo_model: Dict[str, str] = {
            s.name: cfg.name for cfg in self.models.values()
            for s in cfg.slos}
        if slo is None and self._slo_model:
            slo = SloEvaluator(
                slos=[s for cfg in self.models.values() for s in cfg.slos],
                registry=self.metrics.registry, **(slo_params or {}))
        self.slo = slo
        self.requests: List[Request] = []      # every request submitted
        self._rid = itertools.count()
        self._spans: Dict[int, Dict[str, Any]] = {}   # rid -> open spans
        self._dispatch_idx = 0
        self._window_shed = 0
        self._window_shed_by: Dict[str, int] = {}
        self._since_decision = 0
        # incremental accounting, exact when request objects are dropped
        self._submitted = 0
        self._by_state: Dict[str, int] = {}
        # live sessions only (sid -> model, replica, open, chunks); the
        # history is in the counters
        self._sessions: Dict[int, Dict[str, Any]] = {}
        self._next_sid = 0
        self._sessions_opened = 0
        self._sessions_failed = 0
        self._open_sessions = 0
        # sessions with work outstanding per replica rid: where the next
        # session goes, and what a shrink must not drain
        self._session_load: Dict[int, int] = {}

        self.queue = AdmissionQueue(queue_capacity, self.clock,
                                    on_shed=self._on_shed,
                                    shed_expired=shed_expired)
        if self._multi:
            self.batcher = DeadlineBatcher(
                self.queue, max_batch, service_time=service_time,
                slack_margin_s=slack_margin_s,
                plans={name: cfg.plan() for name, cfg in self.models.items()})
        else:
            self.batcher = DeadlineBatcher(
                self.queue, max_batch, bucket_edges=bucket_edges,
                pad_key=pad_key, length_key=length_key,
                service_time=service_time, slack_margin_s=slack_margin_s)

        def service_hook(batch: AssembledBatch, rid: int) -> float:
            if self._multi:
                s = service_time(batch.model, batch.edge, batch.n_valid,
                                 batch.tier)
            else:
                s = service_time(batch.edge, batch.n_valid, batch.tier)
            w = self._model_width.get(batch.model, 1)
            if w > 1:
                # a width-w slice serves the batch w ways, only as fast
                # as per-device occupancy allows
                s = s / self._width_speedup(batch.n_valid, w)
            return s

        self._service_hook = (service_hook if service_time is not None
                              else None)
        self.pool = ReplicaPool(
            [self._make_replica(r) for r in range(n_replicas)],
            self.clock, restart_s=restart_s,
            fence_budget_s=fence_budget_s,
            replica_factory=self._make_replica,
            observer=self._on_pool_event, device_budget=device_budget)
        self.ladders: Dict[str, DegradationLadder] = {
            name: DegradationLadder(len(cfg.tiers),
                                    cfg.ladder_policy or ladder_policy)
            for name, cfg in self.models.items()}
        #: the single-model ladder (``None`` when multiplexed)
        self.ladder = (self.ladders[DEFAULT_MODEL] if not self._multi
                       else None)

    # -- construction helpers ------------------------------------------------
    def _lead(self, specs, device_budget) -> None:
        """Over ranks of several processes: this rank leads, each model's
        tiers and tier builder announced to the followers
        (``serving/follower.py``).  With ``slice_width > 1`` each slice
        of the layout :class:`~analytics_zoo_tpu_torch.serving.follower.
        SliceLayout` cut has its own leader: the slice holding this rank
        runs the tiers here too, another slice is driven remotely over a
        control group of this rank and the slice's ranks."""
        from analytics_zoo_tpu_torch.parallel.mesh import spans_processes
        from analytics_zoo_tpu_torch.serving.follower import (Leader,
                                                              layout_of)

        if not spans_processes(specs.mesh):
            return
        for cfg in self.models.values():
            if cfg.tier_factory is not None:
                raise ValueError(
                    f"model {cfg.name!r}: per-replica tiers (tier_factory) "
                    "hold per-replica state and cannot be sharded "
                    "(specs=)")
        templates = dict(self.models)
        if self.slice_width == 1:
            leaders = {0: Leader(specs)}
        else:
            layout = layout_of(specs)
            if layout is None or layout.width != self.slice_width:
                raise ValueError(
                    f"slice_width={self.slice_width} over processes: cut "
                    f"the mesh with serving.follower.SliceLayout(specs, "
                    f"{self.slice_width}) on every rank and pass this "
                    f"rank's slice specs")
            if device_budget is None \
                    or device_budget > layout.n_slices * layout.width:
                raise ValueError(
                    f"slices over processes need device_budget <= the "
                    f"{layout.n_slices * layout.width} ranks the layout "
                    f"holds (a replica beyond them has no slice)")
            self._layout = layout
            leaders = {k: Leader(layout.slices[k], channel=layout.channel(k))
                       for k in range(layout.n_slices)}
        self._leaders = leaders
        self._slice_cfgs = {}
        for k, leader in leaders.items():
            self._slice_cfgs[k] = {
                name: dataclasses.replace(
                    cfg, tiers=leader.register(cfg.tiers),
                    weights_to_tiers=(None if cfg.weights_to_tiers is None
                                      else leader.builder(
                                          name, cfg.weights_to_tiers,
                                          template=cfg.tiers)))
                for name, cfg in templates.items()}
        self.models = dict(self._slice_cfgs[0])
        if not self._multi:
            self.tiers = self.models[DEFAULT_MODEL].tiers

    def close(self) -> None:
        """Stop the follower ranks (``specs=`` over several processes;
        nothing otherwise).  The runtime dispatches nothing after it."""
        for leader in self._leaders.values():
            leader.stop()
        self._leaders = {}

    def _free_slice(self) -> Optional[int]:
        """The lowest slice of the layout that no live replica holds and
        no quarantine retired."""
        held = set(self._slice_of.values()) | self._dead_slices
        return next((k for k in range(self._layout.n_slices)
                     if k not in held), None)

    def _make_replica(self, rid: int) -> Replica:
        """Build one replica (also the pool's growth factory): the
        per-model tier table, with per-replica tier instances where a
        model declares a ``tier_factory``; a :class:`ReplicaSlice` of
        ``slice_width`` devices when that is above 1 (over processes, on
        the lowest free slice of the layout; with none free its tiers
        raise, and the pool's ``device_budget`` keeps it from joining)."""
        models = self.models
        k = None
        if self._layout is not None:
            k = self._free_slice()
            if k is not None:
                models = self._slice_cfgs[k]
        fwd: Dict[str, List[Callable]] = {}
        tier_objs: Dict[str, List[ServingTier]] = {}
        for name, cfg in models.items():
            t = cfg.tier_factory(rid) if cfg.tier_factory else cfg.tiers
            if len(t) != len(cfg.tiers):
                raise ValueError(
                    f"model {name!r}: tier_factory built {len(t)} tiers, "
                    f"template declares {len(cfg.tiers)}")
            fwd[name] = [tier.forward for tier in t]
            tier_objs[name] = list(t)
        if self.slice_width > 1:
            specs = self.specs
            if self._layout is not None:
                specs = self._layout.slices[k] if k is not None else None
                if k is None:
                    def no_slice(batch, _rid=rid):
                        raise ReplicaWedged(f"replica {_rid}: no free mesh "
                                            "slice")
                    fwd = {name: [no_slice] * len(f)
                           for name, f in fwd.items()}
            replica = ReplicaSlice(rid, fwd, self.clock,
                                   self.wedge_timeout_s,
                                   width=self.slice_width, specs=specs,
                                   service_hook=self._service_hook)
            if k is not None:
                self._slice_of[rid] = k
        else:
            replica = Replica(rid, fwd, self.clock, self.wedge_timeout_s,
                              service_hook=self._service_hook)
        replica.tier_objs = tier_objs
        return replica

    @staticmethod
    def _width_speedup(n_valid: int, width: int) -> float:
        """The occupancy-limited speedup of a width-``width`` slice on a
        batch of ``n_valid``: each shard serves ``n_valid / width`` rows
        at ``min(1, rows / knee)`` occupancy, against the width-1
        baseline's ``min(1, n_valid / knee)``; exactly ``width`` when
        saturated, exactly 1 below the knee (:data:`OCCUPANCY_KNEE`)."""
        n = max(float(n_valid), 1.0)
        base = min(1.0, n / OCCUPANCY_KNEE)
        wide = min(1.0, (n / width) / OCCUPANCY_KNEE) * width
        return wide / base

    # -- telemetry -----------------------------------------------------------
    def _note(self, kind: str, **fields: Any) -> None:
        """A point event in the flight recorder, at the runtime's time."""
        if self.obs is not None:
            self.obs.recorder.note(kind, t=round(self.clock.now(), 6),
                                   **fields)

    def _on_pool_event(self, ev: Dict[str, Any]) -> None:
        """Every pool event lands in the flight recorder; a fence is a
        terminal condition and dumps the black box when one is armed.
        A retired replica frees its mesh slice, a quarantined one's
        slice is never seated again."""
        if ev["kind"] == "replica_retired":
            self._slice_of.pop(ev["replica"], None)
        elif ev["kind"] == "replica_quarantined" \
                and ev["replica"] in self._slice_of:
            self._dead_slices.add(self._slice_of[ev["replica"]])
        if self.obs is None:
            return
        self.obs.recorder.record(ev)
        if ev["kind"] == "replica_fenced" and self.obs.dump_path:
            self.obs.dump("replica_fenced")

    def _end_request_spans(self, req: Request, status: str,
                           at: Optional[float] = None,
                           **attrs: Any) -> None:
        """Close a request's dispatch span and its root at one instant
        (one clock read), so that its critical path tiles the root span
        on a real clock too."""
        if self.obs is None:
            return
        spans = self._spans.pop(req.rid, None)
        if spans is None:
            return
        if at is None:
            at = self.clock.now()
        d = spans.get("dispatch")
        if d is not None:
            d.end(status=status, at=at, **attrs)
        spans["root"].end(status=status, at=at)

    # -- shed observer -------------------------------------------------------
    def _on_shed(self, req: Request, cause: str) -> None:
        self.metrics.on_shed(cause, model=req.model if self._multi
                             else None)
        self._window_shed += 1
        self._window_shed_by[req.model] = \
            self._window_shed_by.get(req.model, 0) + 1
        self._account_terminal(req)
        if req.session is not None:
            # a gap in the chunk stream would corrupt the session's carry:
            # a shed chunk fails the whole session
            self._kill_session(req, f"chunk shed ({cause})")
        if self.obs is not None:
            spans = self._spans.pop(req.rid, None)
            if spans is not None:
                q = spans.get("queue")
                if q is not None:
                    q.end(status=cause)
                spans["root"].end(status=req.state, cause=cause)

    def _account_terminal(self, req: Request) -> None:
        self._by_state[req.state] = self._by_state.get(req.state, 0) + 1

    # -- client API ----------------------------------------------------------
    def _resolve_model(self, model: Optional[str]) -> ModelConfig:
        if model is None:
            if self._multi and len(self.models) > 1:
                raise ValueError(
                    f"multiplexed runtime serves {sorted(self.models)} — "
                    f"submit(model=...) is required")
            return next(iter(self.models.values()))
        try:
            return self.models[model]
        except KeyError:
            raise KeyError(f"unknown model {model!r} (registered: "
                           f"{sorted(self.models)})") from None

    def submit(self, payload: Any, deadline_s: Optional[float] = None,
               length: Optional[int] = None,
               model: Optional[str] = None) -> Request:
        """Admit one request; raises
        :class:`~analytics_zoo_tpu_torch.resilience.errors.ServerOverloaded`
        on a full queue (the request is still accounted, state ``shed``).
        ``length``: variable-axis length for bucket assignment.
        ``model``: which model (required when several are served)."""
        cfg = self._resolve_model(model)
        if cfg.streaming:
            raise ValueError(
                f"model {cfg.name!r} is a streaming session model — use "
                f"open_session()/submit_chunk()")
        if deadline_s is None:
            deadline_s = (cfg.default_deadline_s
                          if cfg.default_deadline_s is not None
                          else self.default_deadline_s)
        return self._submit(payload, deadline_s, length, cfg.name)

    def _submit(self, payload: Any, deadline_s: float,
                length: Optional[int], model: str,
                session: Optional[int] = None,
                affinity: Optional[int] = None,
                final: bool = False) -> Request:
        now = self.clock.now()
        req = Request(rid=next(self._rid), payload=payload, arrival_t=now,
                      deadline_t=now + deadline_s, length=length,
                      model=model, session=session, affinity=affinity,
                      final=final)
        self._submitted += 1
        if self.retain_requests:
            self.requests.append(req)
        self.metrics.on_submit(model=model if self._multi else None)
        if self.obs is not None:
            # the root of this request's trace, closed at whatever
            # terminal state it reaches
            root = self.obs.tracer.start(
                "request", f"req-{req.rid}", rid=req.rid,
                deadline_s=round(req.deadline_t - now, 6))
            self._spans[req.rid] = {"root": root}
        self.queue.submit(req)          # may raise; _on_shed accounts it
        if self.obs is not None and req.rid in self._spans:
            spans = self._spans[req.rid]
            spans["queue"] = self.obs.tracer.start(
                "queue", spans["root"].trace_id, parent=spans["root"])
        return req


    # -- live weights: hot swap with canary and rollback ---------------------
    def hot_swap(self, checkpoint_path: str, model: Optional[str] = None, *,
                 canary_fraction: float = 0.25, canary_min: int = 32,
                 divergence_budget: float = 1e-3,
                 latency_budget_s: Optional[float] = None,
                 canary_seed: int = 0, lkg_after: int = 2,
                 warm_s: Optional[float] = None,
                 device=None) -> Dict[str, Any]:
        """Start a zero-downtime rollout of a published snapshot:

        1. **verify and load**: the snapshot's sha256 manifest is
           verified and its state loaded onto ``device`` (the GPU unless
           ``device="cpu"``);
        2. **canary**: a seeded ``canary_fraction`` of this model's live
           requests is mirrored to the new weights (one extra forward per
           touched batch, never in ``accounting()``); per-row divergence
           and modeled latency go to rollout-labeled ``serve/canary/*``
           metrics, and an ``SloEvaluator`` over ``canary_slos`` trips
           the stage when either crosses its budget;
        3. **rollout**: after ``canary_min`` clean mirrored requests the
           pool's one-replica-at-a-time machine takes over
           (session-pinned replicas last);
        4. **rollback**: a tripped canary or a mid-rollout SLO trip
           reverts to the previous weights exactly once; a healthy
           rollout promotes the snapshot to ``serve-lkg`` after
           ``lkg_after`` clean decision windows.

        The old tier stacks stay alive in the rollout's stash until it
        completes or rolls back.  Returns the rollout record.  Raises
        :class:`CheckpointCorrupt` on a bad manifest before any drain.
        ``warm_s`` needs the compile-cost model (a Known deviation of item
        13)."""
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
        from analytics_zoo_tpu_torch.resilience.errors import (
            CheckpointCorrupt)
        from analytics_zoo_tpu_torch.utils.device import resolve_device

        if warm_s is not None:
            _not_ported("ServingRuntime.hot_swap(warm_s=...) (the "
                        "compile-cost model of re-warming)", _ITEM_13)
        cfg = self._resolve_model(model)
        if cfg.weights_to_tiers is None:
            raise ValueError(
                f"model {cfg.name!r} declares no weights_to_tiers — the "
                f"runtime cannot build its tier stack from a checkpoint")
        if self.swap_active:
            raise RuntimeError(
                f"hot_swap: rollout of "
                f"{self._swap_ctl['checkpoint']!r} still in progress")
        now = self.clock.now()
        dev = resolve_device(device)
        try:
            state = ckpt.load(checkpoint_path, verify=True, device=dev)
        except CheckpointCorrupt as e:
            self._note("swap_rejected", checkpoint=checkpoint_path,
                       error=str(e)[:160])
            raise
        mirror = list(cfg.weights_to_tiers(state, -1))
        if len(mirror) != len(cfg.tiers):
            raise ValueError(
                f"model {cfg.name!r}: weights_to_tiers built "
                f"{len(mirror)} tiers, template declares "
                f"{len(cfg.tiers)}")
        k = self._swap_counter
        self._swap_counter += 1
        from analytics_zoo_tpu_torch.obs.slo import canary_slos

        window_params = {key: v for key, v in self._slo_params.items()
                         if key in ("fast_window_s", "slow_window_s",
                                    "time_scale", "timeline_cap")}
        evaluator = SloEvaluator(
            slos=canary_slos(cfg.name, divergence_budget,
                             latency_budget_s, rollout=k),
            registry=self.metrics.registry,
            fast_burn=1.0, slow_burn=1.0, **window_params)
        self._lkg = None        # a new rollout supersedes a pending one
        self._swap_ctl = {
            "phase": "canary", "model": cfg.name, "rollout": k,
            "checkpoint": checkpoint_path, "state": state, "device": dev,
            "mirror": mirror, "fraction": float(canary_fraction),
            "min": int(canary_min), "seed": int(canary_seed),
            "mirrored": 0, "evaluator": evaluator,
            "lkg_after": int(lkg_after), "rolled_back": False,
            "stash": {}, "t_started": now,
        }
        self.metrics.registry.counter("serve/swap/rollouts").inc()
        if self.autoscaler is not None:
            # a canary's verdict must not be masked by fresh capacity:
            # the loop observes, its actuations are swallowed
            self.autoscaler.hold = True
        self._note("swap_started", model=cfg.name, rollout=k,
                   checkpoint=checkpoint_path,
                   canary_fraction=float(canary_fraction),
                   canary_min=int(canary_min),
                   divergence_budget=divergence_budget)
        record = {"rollout": k, "model": cfg.name,
                  "checkpoint": checkpoint_path, "outcome": None,
                  "t_started": round(now, 6)}
        self._swap_log.append(record)
        if canary_fraction <= 0 or canary_min <= 0:
            self._begin_roll()          # canary disabled
        return record

    @property
    def swap_active(self) -> bool:
        """Whether a rollout is in flight (canary or rolling): one
        rollout at a time."""
        return (self._swap_ctl is not None
                and self._swap_ctl["phase"] in ("canary", "rolling"))

    @property
    def lkg_pending(self) -> bool:
        """Whether a completed rollout is still inside its serve-lkg
        hysteresis; a ``hot_swap`` now supersedes the promotion."""
        return self._lkg is not None

    def _swap_install(self, replica: Replica) -> None:
        """The rollout's install hook: stash the replica's live tier stack
        of this model (the rollback inventory), then mount the tiers built
        for this rid from the loaded state."""
        ctl = self._swap_ctl
        name = ctl["model"]
        ctl["stash"][replica.rid] = (replica.forward_fns.get(name),
                                     replica.tier_objs.get(name))
        tiers = list(self.models[name].weights_to_tiers(ctl["state"],
                                                        replica.rid))
        replica.forward_fns[name] = [t.forward for t in tiers]
        replica.tier_objs[name] = tiers
        self.metrics.registry.counter("serve/swap/replicas_swapped").inc()

    def _begin_roll(self) -> None:
        ctl = self._swap_ctl
        ctl["phase"] = "rolling"
        self.pool.swap_defer = set(self._session_rids())
        # the weights installed are the state loaded, and verified, above
        self.pool.hot_swap(ctl["checkpoint"], install=self._swap_install,
                           last=sorted(self._session_rids()), verified=True)
        if self.autoscaler is not None:
            self.autoscaler.hold = False
        self._note("swap_rolling", model=ctl["model"],
                   rollout=ctl["rollout"], mirrored=ctl["mirrored"])

    def _swap_tick(self) -> None:
        """Once a pump: refresh the deferred (session-pinned) rids, step
        the pool's machine and notice the rollout's completion, which
        arms the serve-lkg hysteresis and drops the stash."""
        ctl = self._swap_ctl
        if ctl is None or ctl["phase"] != "rolling":
            return
        self.pool.swap_defer = set(self._session_rids())
        self.pool.healthy()             # _revive steps the rollout
        if self.pool.rollout_active:
            return
        ctl["phase"] = "complete"
        ctl["stash"] = {}
        self._swap_stats["completed"] += 1
        self._swap_log[-1]["outcome"] = "complete"
        self._lkg = {"ctl": ctl, "clean": 0, "after": ctl["lkg_after"]}
        self._note("swap_complete", model=ctl["model"],
                   rollout=ctl["rollout"],
                   replicas=list((self.pool.last_rollout or {})
                                 .get("swapped", [])))

    def _maybe_canary(self, batch: AssembledBatch, rows, now: float) -> None:
        """Mirror a seeded fraction of this model's requests to the new
        weights; their per-row divergence and modeled latency feed the
        canary evaluator, which trips the stage on budget.  The mirror
        never touches a request's lifecycle."""
        ctl = self._swap_ctl
        if ctl is None or ctl["phase"] != "canary" \
                or batch.model != ctl["model"]:
            return
        gate = int(ctl["fraction"] * 1000)
        sel = [i for i, r in enumerate(batch.requests)
               if not r.finished
               and (r.rid * 1_000_003 + ctl["seed"]) % 1000 < gate]
        if not sel:
            return
        m, k = ctl["model"], ctl["rollout"]
        reg = self.metrics.registry
        reg.counter(f"serve/canary/mirrored/model={m}").inc(len(sel))
        ctl["mirrored"] += len(sel)
        div_h = reg.histogram(f"serve/canary/divergence/model={m}/swap={k}")
        mirror_tier = ctl["mirror"][batch.tier]
        try:
            mrows = np.asarray(mirror_tier.forward(batch.batch))
            for i in sel:
                a, b = rows[i], mrows[i]
                if isinstance(a, (str, bytes, np.str_)):
                    div = 0.0 if a == b else 1.0
                else:
                    d = np.abs(np.asarray(a, dtype=np.float64)
                               - np.asarray(b, dtype=np.float64))
                    div = float(np.max(d)) if d.size else 0.0
                div_h.observe(div)
        except Exception as err:
            # a crashing canary forward is itself a trip
            div_h.observe(float("inf"))
            self._note("canary_error", model=m, rollout=k,
                       error=f"{type(err).__name__}: {err}"[:160])
        if self._service_time is not None:
            live = float(self._service_hook(batch, -1))
            template = self.models[m].tiers[batch.tier]
            ratio = (template.speed / mirror_tier.speed
                     if getattr(mirror_tier, "speed", 0) else 1.0)
            reg.histogram(f"serve/canary/latency_s/model={m}/swap={k}"
                          ).observe(live * ratio)
        ev = ctl["evaluator"]
        ev.observe_registry(reg, now)
        decision = ev.decide(now)
        if decision.burning:
            self._swap_stats["trips"] += 1
            reg.counter("serve/canary/trips").inc()
            self._note("canary_trip", model=m, rollout=k,
                       burning=list(decision.burning),
                       mirrored=ctl["mirrored"])
            self._swap_rollback("canary_trip: " + ",".join(decision.burning))
        elif ctl["mirrored"] >= ctl["min"]:
            self._begin_roll()

    def _swap_rollback(self, reason: str) -> None:
        """Revert the rollout to the previous weights exactly once (the
        ``rolled_back`` latch).  Swapped replicas get their stashed tier
        stacks back; one with no stash (grown mid-rollout) is rebuilt from
        the verified ``serve-lkg`` snapshot when there is one."""
        ctl = self._swap_ctl
        if ctl is None or ctl["rolled_back"]:
            return
        ctl["rolled_back"] = True
        swapped = self.pool.abort_rollout()
        missing: List[int] = []
        for rid in swapped:
            r = self.pool.replica_by_rid(rid)
            if r is None:
                continue
            stash = ctl["stash"].get(rid)
            if stash is not None and stash[0] is not None:
                r.forward_fns[ctl["model"]] = stash[0]
                r.tier_objs[ctl["model"]] = stash[1]
            else:
                missing.append(rid)
        lkg_path = None
        if missing:
            from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt

            base = os.path.dirname(os.path.abspath(ctl["checkpoint"]))
            found = ckpt.tier_snapshot(base, "serve-lkg")
            if found is not None:
                lkg_path = found[0]
                state = ckpt.load(found[0], verify=False,
                                  device=ctl["device"])
                for rid in missing:
                    r = self.pool.replica_by_rid(rid)
                    tiers = list(self.models[ctl["model"]]
                                 .weights_to_tiers(state, rid))
                    r.forward_fns[ctl["model"]] = [t.forward for t in tiers]
                    r.tier_objs[ctl["model"]] = tiers
        ctl["phase"] = "rolled_back"
        ctl["stash"] = {}
        self._swap_stats["rollbacks"] += 1
        self._swap_log[-1]["outcome"] = "rolled_back"
        self._swap_log[-1]["reason"] = reason[:160]
        self.metrics.registry.counter("serve/swap/rollbacks").inc()
        self._lkg = None
        if self.autoscaler is not None:
            self.autoscaler.hold = False
        self._note("swap_rollback", model=ctl["model"],
                   rollout=ctl["rollout"], reason=reason[:160],
                   reverted=list(swapped), lkg=lkg_path)
        if self.obs is not None and self.obs.dump_path:
            self.obs.dump("swap_rollback")

    def _maybe_promote_lkg(self, decision) -> None:
        """The serve-lkg hysteresis: after a completed rollout,
        ``lkg_after`` consecutive clean decision windows promote the
        swapped snapshot into the ``serve-lkg`` slot; a window with the
        model's SLOs burning restarts the count."""
        pend = self._lkg
        if pend is None:
            return
        model = pend["ctl"]["model"]
        if any(self._slo_model.get(s) == model for s in decision.burning):
            pend["clean"] = 0
            return
        pend["clean"] += 1
        if pend["clean"] < pend["after"]:
            return
        from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt
        from analytics_zoo_tpu_torch.resilience.errors import (
            CheckpointCorrupt)

        snap = pend["ctl"]["checkpoint"]
        base = os.path.dirname(os.path.abspath(snap))
        self._lkg = None
        try:
            target = ckpt.promote_tier(base, snap, "serve-lkg")
        except (CheckpointCorrupt, OSError) as e:
            # the trainer may have collected the step snapshot already: a
            # missed promotion is not a serving fault
            self._note("swap_lkg_failed", checkpoint=snap,
                       error=str(e)[:160])
            return
        self._swap_stats["lkg_promotions"] += 1
        self.metrics.registry.counter("serve/swap/lkg_promotions").inc()
        self._note("swap_lkg_promoted", checkpoint=snap, tier=target,
                   rollout=pend["ctl"]["rollout"])

    # -- streaming sessions --------------------------------------------------
    def open_session(self, model: Optional[str] = None) -> int:
        """Open a streaming session on the healthy replica with the
        fewest sessions (ties to the lower rid): every chunk of the
        session runs there, where its carry lives.  Raises
        :class:`ServerOverloaded` when no replica is healthy."""
        cfg = self._resolve_model(model)
        if not cfg.streaming:
            raise ValueError(f"model {cfg.name!r} is not a streaming "
                             f"session model")
        healthy = self.pool.healthy()
        if not healthy:
            raise ServerOverloaded("no healthy replica to pin a "
                                   "session to; retry with backoff")
        rid = min((r.rid for r in healthy),
                  key=lambda r: (self._session_load.get(r, 0), r))
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = {"model": cfg.name, "replica": rid,
                               "open": True, "chunks": 0}
        self._sessions_opened += 1
        self._open_sessions += 1
        self._session_load[rid] = self._session_load.get(rid, 0) + 1
        self.metrics.registry.counter("serve/sessions/opened").inc()
        self.metrics.registry.gauge("serve/sessions_open").set(
            float(self._open_sessions))
        self._note("session_opened", session=sid, model=cfg.name,
                   replica=rid)
        return sid

    def submit_chunk(self, sid: int, payload: Any,
                     length: Optional[int] = None,
                     deadline_s: Optional[float] = None,
                     final: bool = False) -> Request:
        """Feed one chunk of an open session.  Its deadline is anchored at
        this submit (``deadline_s`` or the model's ``chunk_deadline_s``)
        and clamped up to the session's last chunk deadline, so chunk
        deadlines are monotone and EDF serves them in order.
        ``final=True`` flushes the session and closes it once admitted; a
        final chunk shed at the door kills the session instead."""
        sess = self._sessions.get(sid)
        if sess is None:
            if 0 <= sid < self._next_sid:
                raise RuntimeError(f"session {sid} is closed")
            raise KeyError(f"unknown session {sid}")
        if not sess["open"]:
            raise RuntimeError(f"session {sid} is closed")
        cfg = self.models[sess["model"]]
        if deadline_s is None:
            deadline_s = cfg.chunk_deadline_s
        now = self.clock.now()
        deadline_s = max(deadline_s,
                         sess.get("last_deadline_t", 0.0) - now)
        # submit first: a shed at the door goes through _on_shed, which
        # kills the session; only an admitted final chunk closes it
        req = self._submit(payload, deadline_s, length, cfg.name,
                           session=sid, affinity=sess["replica"],
                           final=final)
        sess["chunks"] += 1
        sess["last_deadline_t"] = req.deadline_t
        if final:
            self._close_session_books(sess)
        return req

    def close_session(self, sid: int) -> None:
        """Abandon an open session without a flush chunk: its books close,
        its replica pin is released and the pinned replica's store entry
        evicted.  No-op on a session already closed and released."""
        sess = self._sessions.get(sid)
        if sess is None:
            return
        self._close_session_books(sess)
        self._release_session(sid)
        self._evict(sess["replica"], sess["model"], sid)
        self._note("session_closed", session=sid)

    def _evict(self, rid: Optional[int], model: str, sid: int) -> None:
        replica = (self.pool.replica_by_rid(rid) if rid is not None
                   else None)
        if replica is not None:
            for tier in replica.tier_objs.get(model, []):
                if tier.evict_session is not None:
                    tier.evict_session(sid)

    def _close_session_books(self, sess: Dict[str, Any]) -> None:
        if not sess["open"]:
            return
        sess["open"] = False
        self._open_sessions -= 1
        self.metrics.registry.counter("serve/sessions/closed").inc()
        self.metrics.registry.gauge("serve/sessions_open").set(
            float(self._open_sessions))

    def _session_rids(self) -> Set[int]:
        """Replicas pinned by sessions with work outstanding (open, or
        closed with the final chunk in flight)."""
        return {rid for rid, n in self._session_load.items() if n > 0}

    def _release_session(self, sid: int) -> None:
        """The session's last outcome landed (its final chunk terminal, or
        the session killed): drop the live entry and its pin."""
        sess = self._sessions.pop(sid, None)
        if sess is None:
            return
        rid = sess["replica"]
        n = self._session_load.get(rid, 0) - 1
        if n > 0:
            self._session_load[rid] = n
        else:
            self._session_load.pop(rid, None)

    def _kill_session(self, req: Request, reason: str) -> None:
        """A chunk died unserved (shed, failed dispatch, replica lost):
        the session's carry has a gap, so the whole session fails — books
        closed, entry released, the pinned replica's store entry evicted.
        Its chunks still queued fail before their dispatch
        (:meth:`_scrub_dead_session_rows`)."""
        sid = req.session
        sess = self._sessions.get(sid)
        if sess is None:
            return
        self._close_session_books(sess)
        self._release_session(sid)
        self._sessions_failed += 1
        self._evict(req.affinity, req.model, sid)
        self._note("session_failed", session=sid, reason=reason[:160])

    def _scrub_dead_session_rows(self, batch: AssembledBatch) -> None:
        """Fail a killed session's chunks that were admitted before the
        kill, before the forward, and mask their rows (session -1, final
        0): they neither return garbage marked ``done`` nor recreate the
        evicted store entry."""
        if batch.affinity is None:
            return
        for i, req in enumerate(batch.requests):
            if req.session is None or req.session in self._sessions:
                continue
            req.finish("failed", self.clock.now(), error=ReplicaWedged(
                f"session {req.session} already failed"))
            self._account_terminal(req)
            self.metrics.on_fail(model=batch.model if self._multi
                                 else None)
            self._end_request_spans(req, "failed", attempts=req.attempts)
            batch.batch["session"][i] = -1
            batch.batch["final"][i] = 0

    # -- scheduler -----------------------------------------------------------
    def _tier_arg(self):
        if self._multi:
            return {name: ladder.tier
                    for name, ladder in self.ladders.items()}
        return self.ladder.tier

    def pump(self, force: bool = False) -> int:
        """Run all currently due scheduling work: shed expired requests,
        assemble and dispatch every flush-ready batch.  Returns the
        number of batches dispatched.  Call after submits and after the
        clock moves."""
        self._swap_tick()
        dispatched = 0
        while True:
            if self.parallel and not force \
                    and not self.pool.any_free(self.clock.now()):
                # every replica is busy: assembling a batch now would
                # only burn its members' slack (expiry still runs)
                self.queue.expire()
                break
            batch = self.batcher.next_batch(self._tier_arg(), force=force)
            if batch is None:
                break
            self._dispatch(batch)
            dispatched += 1
        return dispatched

    def next_event_t(self) -> Optional[float]:
        """The next instant the pool changes state on its own (a busy
        replica frees, a restart completes): where an event-driven load
        loop advances the clock when :meth:`pump` has nothing to do."""
        return self.pool.next_event_t(self.clock.now())

    def drain(self, max_batches: int = 10_000_000) -> None:
        """Force-flush everything still queued: every pending request
        reaches a terminal state."""
        for _ in range(max_batches):
            if self.pump(force=True) == 0 and len(self.queue) == 0:
                return
        raise RuntimeError("drain did not converge")

    # -- internals -----------------------------------------------------------
    def _open_batch_spans(self, batch: AssembledBatch):
        """The batch's own trace (it belongs to all its requests); each
        member's ``queue`` span closes and its ``dispatch`` span opens."""
        if self.obs is None:
            return None
        batch_span = self.obs.tracer.start(
            "batch", f"batch-{self._dispatch_idx}",
            requests=[r.rid for r in batch.requests],
            edge=str(batch.edge), n_valid=batch.n_valid, tier=batch.tier)
        for req in batch.requests:
            spans = self._spans.get(req.rid)
            if spans is None:
                continue
            q = spans.pop("queue", None)
            if q is not None:
                q.end(status="assembled", edge=str(batch.edge))
            spans["dispatch"] = self.obs.tracer.start(
                "dispatch", spans["root"].trace_id, parent=spans["root"],
                tier=batch.tier, batch=self._dispatch_idx)
        return batch_span

    def _fault_for(self, replica: Replica) -> Optional[Callable]:
        """The chaos hooks aimed at ``replica`` at the current dispatch
        index (None when nothing is due): a ``slow_forward`` sleeps
        through the replica's fence-budget guard, a ``replica_crash``
        raises."""
        if self.chaos is None:
            return None
        idx = self._dispatch_idx
        hooks: List[Callable] = []
        spec = self.chaos.serving_active("slow_forward", idx, consume=False)
        if spec is not None and spec.detail.get(
                "replica", replica.rid) == replica.rid:
            self.chaos.serving_active("slow_forward", idx)  # record+consume
            delay = float(spec.detail.get("delay_s", 2.0))
            hooks.append(lambda r: r.sleep_guarded(delay))
        spec = self.chaos.serving_active("replica_crash", idx, consume=False)
        if spec is not None and spec.detail.get(
                "replica", replica.rid) == replica.rid:
            self.chaos.serving_active("replica_crash", idx)

            def crash(r):
                from analytics_zoo_tpu_torch.resilience.errors import (
                    InjectedFault)

                raise InjectedFault(
                    f"chaos: replica {r.rid} killed mid-batch")

            hooks.append(crash)
        if not hooks:
            return None

        def fault(r):
            for h in hooks:
                h(r)

        return fault

    def _note_fill(self, batch: AssembledBatch) -> None:
        """The per-model batch-fill EWMA (0..1 of the model's batch), the
        autoscaler's saturation signal."""
        cap = max(self.batcher.model_batch(batch.model), 1)
        fill = min(1.0, batch.n_valid / cap)
        prev = self._fill_ewma.get(batch.model)
        self._fill_ewma[batch.model] = (
            fill if prev is None else 0.8 * prev + 0.2 * fill)

    def _dispatch(self, batch: AssembledBatch) -> None:
        self._scrub_dead_session_rows(batch)
        if self.parallel:
            self._dispatch_parallel(batch)
            return
        self._dispatch_idx += 1
        self.metrics.on_batch(batch.n_valid,
                              self.batcher.model_batch(batch.model),
                              self.queue.depth)
        self._note_fill(batch)
        model_label = batch.model if self._multi else None
        t0 = self.clock.now()
        batch_span = self._open_batch_spans(batch)
        try:
            out = self.pool.dispatch(batch, fault_for=self._fault_for)
        except ReplicaWedged as err:
            now = self.clock.now()
            for req in batch.requests:
                if req.finished:        # a scrubbed dead-session row
                    continue
                req.finish("failed", now, error=err)
                self._account_terminal(req)
                self.metrics.on_fail(model=model_label)
                self._end_request_spans(req, "failed",
                                        attempts=req.attempts)
                if req.session is not None:
                    # the pinned replica is gone or wedged: the session's
                    # carry is lost
                    self._kill_session(req, str(err))
            if batch_span is not None:
                batch_span.end(status="failed",
                               redispatched=batch.redispatched)
            self._after_dispatch(batch, t0, failed=True)
            return
        now = self.clock.now()
        rows = np.asarray(out)
        self._maybe_canary(batch, rows, now)
        for i, req in enumerate(batch.requests):
            if req.finished:            # a scrubbed dead-session row
                continue
            req.tier = batch.tier
            req.finish("done", now,
                       result=rows[i] if self.retain_requests else None)
            self._account_terminal(req)
            missed = now > req.deadline_t
            self.metrics.on_complete(now - req.arrival_t, batch.tier,
                                     missed=missed, model=model_label)
            self._end_request_spans(req, "done", attempts=req.attempts,
                                    missed=missed)
            if req.final and req.session is not None:
                self._release_session(req.session)
        if batch_span is not None:
            batch_span.end(status="done", redispatched=batch.redispatched)
        self._after_dispatch(batch, t0, failed=False)

    def _parallel_fault(self, replica: Replica
                        ) -> Tuple[bool, float, float]:
        """The chaos windows at the current dispatch index against
        ``replica`` under the parallel service model: ``(crash, delay_s,
        slow_x)``, applied to the replica's own busy horizon.
        ``slow_x`` (``slow_device``) stretches the service itself and is
        not chaotic: no wedge check sees it, only the straggler ladder."""
        if self.chaos is None:
            return False, 0.0, 1.0
        idx = self._dispatch_idx
        delay = 0.0
        spec = self.chaos.serving_active("slow_forward", idx, consume=False)
        if spec is not None and spec.detail.get(
                "replica", replica.rid) == replica.rid:
            self.chaos.serving_active("slow_forward", idx)  # record+consume
            delay = float(spec.detail.get("delay_s", 2.0))
        crash = False
        spec = self.chaos.serving_active("replica_crash", idx, consume=False)
        if spec is not None and spec.detail.get(
                "replica", replica.rid) == replica.rid:
            self.chaos.serving_active("replica_crash", idx)
            crash = True
        slow_x = 1.0
        spec = self.chaos.serving_active("slow_device", idx, consume=False)
        if spec is not None and spec.detail.get(
                "replica", replica.rid) == replica.rid:
            self.chaos.serving_active("slow_device", idx)
            slow_x = float(spec.detail.get("slow_x", 4.0))
        return crash, delay, slow_x

    def _dispatch_parallel(self, batch: AssembledBatch) -> None:
        """Parallel-service dispatch: the batch goes to a free replica
        (a session's pinned one; with none free under a forced drain, the
        least busy), its forward runs now and its completion lands at
        ``start + delay + service`` on that replica's busy horizon while
        the clock stands still.  A chaos crash or wedge fences the
        replica at the instant computed on its horizon and the batch
        fails over exactly once (``redispatched``), as in the serial
        path; request spans end at the computed instants."""
        self._dispatch_idx += 1
        self.metrics.on_batch(batch.n_valid,
                              self.batcher.model_batch(batch.model),
                              self.queue.depth)
        self._note_fill(batch)
        now = self.clock.now()
        model_label = batch.model if self._multi else None
        batch_span = self._open_batch_spans(batch)

        def window_done() -> None:
            if batch.redispatched:
                self.metrics.redispatches += 1
            self._since_decision += 1
            if self._since_decision >= self.decision_every:
                self._decide_window()

        def fail_batch(err: BaseException, at: float) -> None:
            for req in batch.requests:
                if req.finished:        # a scrubbed dead-session row
                    continue
                req.finish("failed", at, error=err)
                self._account_terminal(req)
                self.metrics.on_fail(model=model_label)
                self._end_request_spans(req, "failed", at=at,
                                        attempts=req.attempts)
                if req.session is not None:
                    self._kill_session(req, str(err))
            if batch_span is not None:
                batch_span.end(status="failed", at=at,
                               redispatched=batch.redispatched)
            window_done()

        def complete(replica: Replica, out: Any, start: float,
                     elapsed: float, service: float) -> None:
            completion = start + elapsed
            replica.busy_until = completion
            if self.health is not None:
                # the service component only: a chaos delay is not the
                # device's speed, and eviction cannot be undone
                self._note_device_health(replica, service)
            rows = np.asarray(out)
            self._maybe_canary(batch, rows, now)
            for i, req in enumerate(batch.requests):
                if req.finished:        # a scrubbed dead-session row
                    continue
                req.tier = batch.tier
                req.finish("done", completion,
                           result=rows[i] if self.retain_requests
                           else None)
                self._account_terminal(req)
                missed = completion > req.deadline_t
                self.metrics.on_complete(completion - req.arrival_t,
                                         batch.tier, missed=missed,
                                         model=model_label)
                self._end_request_spans(req, "done", at=completion,
                                        attempts=req.attempts,
                                        missed=missed)
                if req.final and req.session is not None:
                    self._release_session(req.session)
            if batch_span is not None:
                batch_span.end(status="done", at=completion,
                               redispatched=batch.redispatched)
            window_done()

        def wedge(replica: Replica, err: ReplicaWedged, at: float,
                  is_backup: bool) -> None:
            replica.busy_until = at
            self.pool._fence(replica, err, at=at)
            failover(replica, err, at, is_backup)

        def fenced_at_budget(replica: Replica) -> ReplicaWedged:
            return ReplicaWedged(
                f"replica {replica.rid}: forward wedged mid-flight — "
                f"fenced at the {replica.fence_budget_s:.3f}s fence budget")

        def serve_on(replica: Replica, t_avail: float,
                     is_backup: bool) -> None:
            """One attempt on ``replica``'s horizon, in the serial
            forward's order: the injected delay, the tier, the service;
            the fence budget cuts the elapsed time where
            ``sleep_guarded`` would."""
            for req in batch.requests:
                req.attempts += 1
            replica.dispatches += 1
            crash, delay, slow_x = self._parallel_fault(replica)
            start = max(t_avail, replica.busy_until)
            budget = replica.fence_budget_s
            chaotic = crash or delay > 0
            if chaotic and budget is not None and delay > budget:
                # the injected stall alone crosses the budget
                wedge(replica, fenced_at_budget(replica), start + budget,
                      is_backup)
                return
            if crash:
                # the slow_forward hook sleeps first, then the crash
                wedge(replica, ReplicaWedged(
                    f"replica {replica.rid}: forward crashed mid-batch "
                    f"(InjectedFault: chaos: replica {replica.rid} "
                    f"killed mid-batch)"), start + delay, is_backup)
                return
            try:
                out = replica._fn_for(batch)(batch.batch)
            except Exception as e:
                err = e if isinstance(e, ReplicaWedged) else ReplicaWedged(
                    f"replica {replica.rid}: forward crashed mid-batch "
                    f"({type(e).__name__}: {e})")
                fail_batch(err, start)
                return
            service = float(self._service_hook(batch, replica.rid)) * slow_x
            elapsed = delay + service
            if chaotic and budget is not None and elapsed > budget:
                wedge(replica, fenced_at_budget(replica), start + budget,
                      is_backup)
                return
            if chaotic and elapsed > replica.watchdog.timeout_s:
                # no budget: the wedge is seen when the forward returns
                wedge(replica, ReplicaWedged(
                    f"replica {replica.rid}: forward wedged "
                    f"({elapsed:.3f}s > "
                    f"{replica.watchdog.timeout_s:.3f}s deadline)"),
                    start + elapsed, is_backup)
                return
            complete(replica, out, start, elapsed, service)

        def failover(failed: Replica, err: ReplicaWedged,
                     t_detect: float, is_backup: bool) -> None:
            if is_backup or batch.redispatched \
                    or batch.affinity is not None:
                # the latch is spent, or a session batch (its carry was
                # on the failed replica)
                fail_batch(err, t_detect)
                return
            batch.redispatched = True
            backup = self.pool.pick_free(t_detect, exclude=failed.rid)
            if backup is None:
                backup = self.pool.least_busy()
            if backup is None:
                fail_batch(ReplicaWedged(
                    f"batch failover from replica {failed.rid}: no "
                    f"healthy replica left"), t_detect)
                return
            self.pool._event({"kind": "failover", "from": failed.rid,
                              "to": backup.rid, "t": round(t_detect, 6),
                              "requests": [r.rid for r in batch.requests]})
            serve_on(backup, t_detect, is_backup=True)

        if batch.affinity is not None:
            self.pool._revive()
            replica = self.pool.replica_by_rid(batch.affinity)
            if replica is None or replica.state != "healthy":
                replica = None
        else:
            replica = self.pool.pick_free(now)
            if replica is None:
                # a forced drain: queue on the least busy replica
                replica = self.pool.least_busy()
        if replica is None:
            fail_batch(ReplicaWedged(
                f"no replica available for model {batch.model!r}"
                + (f" (session pinned to {batch.affinity})"
                   if batch.affinity is not None else "")), now)
            return
        serve_on(replica, now, is_backup=False)

    def _note_device_health(self, replica: Replica, elapsed: float) -> None:
        """Feed one completion's service time into the straggler ladder;
        a flagged replica is quarantined (drained, retired, the device
        budget lowered by its width) while the eviction budget lasts."""
        flagged = self.health.observe_step_time(replica.rid, float(elapsed))
        if flagged is None:
            return
        pol = self.health.policy
        if not (pol.evict and self.health.eviction_budget_left):
            logger.warning("health: replica %d flagged as straggler but "
                           "eviction is %s — serving continues degraded",
                           flagged,
                           "off" if not pol.evict else "budget-exhausted")
            return
        victim = self.pool.replica_by_rid(flagged)
        width = victim.width if victim is not None else 1
        if self.pool.quarantine(flagged, reason="straggler"):
            self.health.note_quarantine(flagged, "straggler")
            if self.autoscaler is not None:
                self.autoscaler.note_quarantine(flagged, width)

    def _after_dispatch(self, batch: AssembledBatch, t0: float,
                        failed: bool) -> None:
        dt = self.clock.now() - t0
        if not failed and self.batcher.service_time is None:
            self.batcher.observe_service_s(batch.edge, dt, tier=batch.tier,
                                           model=batch.model)
        if batch.redispatched:
            self.metrics.redispatches += 1
        self._since_decision += 1
        if self._since_decision >= self.decision_every:
            self._decide_window()

    def _decide_window(self) -> None:
        detail = {"shed_in_window": self._window_shed,
                  "queue_depth": self.queue.depth}
        if self.slo is not None:
            # window verdicts from multi-window burn rates over the
            # registry, not the raw shed flag
            now = self.clock.now()
            self.slo.observe_registry(self.metrics.registry, now)
            decision = self.slo.decide(now)
            if self.obs is not None:
                # the decision lands in the black box beside its effects
                self.obs.recorder.note(
                    "slo_decision", t=round(now, 6),
                    overloaded=decision.overloaded,
                    burning=list(decision.burning),
                    new_trips=list(decision.new_trips),
                    recovered=list(decision.recovered),
                    scale_hint=decision.scale_hint)
            if self._multi:
                self._observe_multi(decision, detail)
            else:
                self.ladder.observe_decision(decision, detail=detail)
            # a fresh trip of the swapped model's SLOs while replicas are
            # being swapped rolls the rollout back
            ctl = self._swap_ctl
            if ctl is not None and ctl["phase"] == "rolling" \
                    and decision.new_trips:
                hit = [s for s in decision.new_trips
                       if self._slo_model.get(s) == ctl["model"]]
                if hit:
                    self._swap_rollback(
                        "mid_rollout_anomaly: " + ",".join(hit))
            self._maybe_promote_lkg(decision)
            if self.autoscaler is not None:
                self._actuate(decision)
        elif self._multi:
            for name, ladder in self.ladders.items():
                depth_high = ladder.policy.depth_high * self.max_batch
                overloaded = (self._window_shed_by.get(name, 0) > 0
                              or self.queue.depth > depth_high)
                ladder.observe_window(overloaded, detail=dict(detail))
        else:
            depth_high = self.ladder.policy.depth_high * self.max_batch
            overloaded = (self._window_shed > 0
                          or self.queue.depth > depth_high)
            self.ladder.observe_window(overloaded, detail=detail)
        self._window_shed = 0
        self._window_shed_by = {}
        self._since_decision = 0

    def _observe_multi(self, decision, detail: Dict[str, Any]) -> None:
        """Fan one SLO decision out to the per-model ladders and set the
        weighted-EDF weights: each model's ladder sees only its own SLOs'
        burn, and its weight follows its worst fast-window burn."""
        burning_by_model: Dict[str, List[str]] = {}
        for slo_name in decision.burning:
            m = self._slo_model.get(slo_name)
            if m is not None:
                burning_by_model.setdefault(m, []).append(slo_name)
        for name, ladder in self.ladders.items():
            cfg = self.models[name]
            if not cfg.slos:
                # a model with no SLOs steps on its own shed flag
                ladder.observe_window(
                    self._window_shed_by.get(name, 0) > 0,
                    detail=dict(detail))
                continue
            burning = burning_by_model.get(name, [])
            ladder.observe_window(bool(burning), detail={
                "slo_burning": burning,
                "scale_hint": decision.scale_hint, **detail})
            worst = max((decision.per_slo[s.name]["fast"]["burn"]
                         for s in cfg.slos if s.name in decision.per_slo),
                        default=0.0)
            w = min(max(1.0, 1.0 + worst), self.weight_cap)
            self.batcher.set_model_weight(name, w)
            self.metrics.registry.gauge(
                f"serve/model_weight/model={name}").set(w)

    def _actuate(self, decision) -> None:
        """The autoscaler's loop, then the actuation: a target resizes
        the pool (shrink drains, session-pinned replicas and a rollout's
        current victim spared); a :class:`Reshape` moves a model onto
        wider slices."""
        target = self.autoscaler.observe_decision(
            decision, self.pool.size,
            saturation=dict(self._fill_ewma) or None,
            widths=dict(self._model_width))
        if target is None:
            return
        if isinstance(target, Reshape):
            self._do_reshape(target)
            return
        protected = self._session_rids()
        if self.pool._swap is not None \
                and self.pool._swap["current"] is not None:
            protected.add(self.pool._swap["current"])
        actions = self.pool.resize(target,
                                   prewarm=self.autoscaler.policy.prewarm,
                                   protected=sorted(protected))
        self._note("autoscale", target=target, grown=actions["grown"],
                   drained=actions["drained"],
                   burning=list(decision.burning))

    def _do_reshape(self, decision: Reshape) -> None:
        """A width reshape: the model's service model moves to
        ``to_width``-way slices (eager PyTorch holds no per-geometry
        programs to drop, so ``geometries_dropped`` is 0)."""
        self._model_width[decision.model] = decision.to_width
        ev = {"kind": "autoscale_reshape", "model": decision.model,
              "from_width": decision.from_width,
              "to_width": decision.to_width,
              "fill": round(decision.fill, 6),
              "geometries_dropped": 0,
              "t": round(self.clock.now(), 6),
              "rationale": decision.rationale}
        self._reshape_log.append(ev)
        self.pool._event(ev)
        self._note("autoscale", reshape=decision.model,
                   to_width=decision.to_width,
                   fill=round(decision.fill, 6))

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
        mesh_info = None
        if self.specs is not None:
            from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
            names = mesh_lib.axis_names(self.specs.mesh)
            mesh_info = {
                "axes": {n: mesh_lib.axis_size(self.specs.mesh, n)
                         for n in names},
                "data_axis_size": self.specs.data_axis_size,
            }
        out = {
            "mesh": mesh_info,
            "metrics": self.metrics.snapshot(),
            "queue": self.queue.snapshot(),
            "replicas": self.pool.snapshot(),
            "accounting": self.accounting(),
        }
        if self._multi:
            out["models"] = {
                name: {
                    "ladder": self.ladders[name].snapshot(),
                    "weight": self.batcher.model_weight(name),
                    "outcomes": self.metrics.model_snapshot(name),
                    "tiers": [{"name": t.name, "speed": t.speed}
                              for t in cfg.tiers],
                }
                for name, cfg in self.models.items()}
            out["sessions"] = {
                "opened": self._sessions_opened,
                "open": self._open_sessions,
                "failed": self._sessions_failed,
            }
            if self.autoscaler is not None:
                out["autoscale"] = self.autoscaler.snapshot()
                out["pool_size"] = self.pool.size
                # the reference's count of cold compiles: none in eager
                # PyTorch
                out["cold_compiles"] = 0
        else:
            out["ladder"] = self.ladder.snapshot()
            out["tiers"] = [{"name": t.name, "speed": t.speed,
                             "quality_note": t.quality_note}
                            for t in self.tiers]
        if self.slice_width > 1 or self._reshape_log:
            out["slices"] = {
                "slice_width": self.slice_width,
                "devices_used": self.pool.devices_used,
                "device_budget": self.pool.device_budget,
                "model_width": dict(sorted(self._model_width.items())),
                "reshapes": [dict(e) for e in self._reshape_log],
            }
        if self.slo is not None:
            r = self.slo.report()
            out["slo"] = {k: r[k] for k in
                          ("slos", "windows", "decisions", "trips",
                           "peak_burns")}
        if self._swap_counter:          # keyed in once hot_swap was used
            out["swap"] = {
                "rollouts": self._swap_counter,
                "completed": self._swap_stats["completed"],
                "rollbacks": self._swap_stats["rollbacks"],
                "trips": self._swap_stats["trips"],
                "lkg_promotions": self._swap_stats["lkg_promotions"],
                "history": [dict(h) for h in self._swap_log],
            }
        return out
