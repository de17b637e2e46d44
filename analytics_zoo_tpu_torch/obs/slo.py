"""Online SLO evaluation: declarative objectives and multi-window burn
rates (counterpart of ``obs/slo.py``).

The :class:`~analytics_zoo_tpu_torch.obs.registry.MetricRegistry` says
what happened; an **SLO** says what was promised, and a burn rate how
fast the promise's error budget is being spent.

- :class:`SLO`: one objective over registry metric names, a **ratio**
  (bad-event fraction <= ``budget`` over counters, ``prefix*`` patterns
  allowed) or a **threshold** (an observed histogram field <= ``budget``);
- :class:`SloEvaluator`: takes a sliding window of registry snapshots
  (``observe``) and evaluates every SLO over two windows at once
  (:meth:`SloEvaluator.decide`): a **fast** one (5-minute-equivalent)
  that reacts to a burn and a **slow** one (1-hour-equivalent) that
  confirms it.  An SLO burns only when both exceed their thresholds.
  ``time_scale`` maps the windows onto the caller's clock, so a
  seconds-long virtual-clock run exercises the same window logic.

Burn rate: for a ratio, ``window_bad_fraction / budget``; for a
threshold, ``window_mean_value / budget``; 1.0 spends the budget exactly
at its sustainable rate.  Counters are taken to be zero when the
evaluator attaches.

Consumers: the runtime feeds :meth:`SloEvaluator.decide` to
:meth:`~analytics_zoo_tpu_torch.serving.ladder.DegradationLadder.
observe_decision` and, multiplexed, sets each model's weighted-EDF
weight from its fast burn.  :attr:`SloDecision.scale_hint` (+1 while an
SLO burns, -1 when every burn is far under budget, else 0) is the
autoscaler's input (``serving/autoscale.py``); the burns are mirrored
into the registry (``slo/fast_burn/slo=*`` gauges, ``slo/trips/slo=*``
counters).

The evaluator reads no clock (the caller passes each instant) and draws
no random number, so a virtual-clock run gives the same timeline every
time.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: default multi-window geometry (wall-clock-equivalent seconds) and
#: burn thresholds — fast trips at 2× budget consumption, slow confirms
#: at 1× (sustained), per the SRE multiwindow/multi-burn-rate pattern
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
FAST_BURN = 2.0
SLOW_BURN = 1.0


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective over registry metric names.

    ``kind="ratio"``: ``bad``/``total`` are counter-name patterns
    (exact names, or ``prefix*`` wildcards summing every match, e.g.
    ``serve/shed/cause=*``); the objective is windowed
    ``Δbad / Δtotal ≤ budget``.

    ``kind="threshold"``: ``value`` selects a histogram field as
    ``<name-pattern>:<field>`` (e.g. ``serve/latency_s/tier=*:p99`` —
    the worst matching tier is taken); the objective is windowed mean
    ``≤ budget`` (budget in the value's own unit, e.g. seconds).
    """

    name: str
    kind: str                       # "ratio" | "threshold"
    budget: float
    bad: Tuple[str, ...] = ()
    total: Tuple[str, ...] = ()
    value: str = ""
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("ratio", "threshold"):
            raise ValueError(f"SLO {self.name}: unknown kind {self.kind!r}")
        if self.budget <= 0:
            raise ValueError(f"SLO {self.name}: budget must be > 0")
        if self.kind == "ratio" and (not self.bad or not self.total):
            raise ValueError(
                f"SLO {self.name}: ratio kind needs bad= and total= "
                f"counter patterns")
        if self.kind == "threshold" and ":" not in self.value:
            raise ValueError(
                f"SLO {self.name}: threshold kind needs value= "
                f"'<histogram-pattern>:<field>'")


def deadline_miss_slo(budget: float = 0.2) -> SLO:
    """Deadline-miss rate ≤ ``budget`` over terminal requests — a shed,
    failed, or completed-late request all count as missed (the
    ``ServingMetrics.miss_rate`` definition, windowed)."""
    return SLO(
        name="deadline-miss-rate", kind="ratio", budget=budget,
        bad=("serve/deadline_misses_completed_late", "serve/failed",
             "serve/shed/cause=*"),
        total=("serve/completed", "serve/failed", "serve/shed/cause=*"),
        description="fraction of terminal requests that missed their "
                    "deadline (shed | failed | completed late)")


def shed_rate_slo(budget: float = 0.1) -> SLO:
    """Shed fraction of submitted requests ≤ ``budget``."""
    return SLO(
        name="shed-rate", kind="ratio", budget=budget,
        bad=("serve/shed/cause=*",), total=("serve/submitted",),
        description="fraction of submitted requests shed before "
                    "device dispatch")


def p99_latency_slo(target_s: float) -> SLO:
    """Worst-tier p99 latency ≤ ``target_s`` (read off the bounded
    reservoirs — cumulative over the reservoir, windowed over the
    snapshot stream)."""
    return SLO(
        name="p99-latency", kind="threshold", budget=target_s,
        value="serve/latency_s/tier=*:p99",
        description=f"p99 completion latency <= {target_s}s on every "
                    f"serving tier")


def default_serving_slos() -> List[SLO]:
    """The default serving objectives: miss rate, shed rate, tail
    latency."""
    return [deadline_miss_slo(0.2), shed_rate_slo(0.15),
            p99_latency_slo(0.5)]


def model_deadline_miss_slo(model: str, budget: float = 0.2) -> SLO:
    """Per-model deadline-miss rate ≤ ``budget`` over ONE multiplexed
    model's terminal requests (the model-labeled counters
    ``ServingRuntime(models=...)`` maintains) — the per-model SLO whose
    burn rate drives that model's ladder and weighted-EDF weight."""
    return SLO(
        name=f"deadline-miss-rate/model={model}", kind="ratio",
        budget=budget,
        bad=(f"serve/deadline_misses_completed_late/model={model}",
             f"serve/failed/model={model}",
             f"serve/shed/model={model}/cause=*"),
        total=(f"serve/completed/model={model}",
               f"serve/failed/model={model}",
               f"serve/shed/model={model}/cause=*"),
        description=f"fraction of {model} terminal requests that missed "
                    f"their deadline (shed | failed | completed late)")


def model_shed_rate_slo(model: str, budget: float = 0.1) -> SLO:
    """Per-model shed fraction of submitted requests ≤ ``budget``."""
    return SLO(
        name=f"shed-rate/model={model}", kind="ratio", budget=budget,
        bad=(f"serve/shed/model={model}/cause=*",),
        total=(f"serve/submitted/model={model}",),
        description=f"fraction of submitted {model} requests shed "
                    f"before device dispatch")


def model_slos(model: str, miss_budget: float = 0.2,
               shed_budget: float = 0.15) -> List[SLO]:
    """The per-model objective pair a multiplexed
    ``ServingRuntime(models=[ModelConfig(slos=model_slos(name))])``
    declares per family: miss rate + shed rate over the model-labeled
    counters.  SLO names embed ``model=`` so the mirrored ``slo/*``
    gauges carry the model as a label."""
    return [model_deadline_miss_slo(model, miss_budget),
            model_shed_rate_slo(model, shed_budget)]


def canary_divergence_slo(model: str, budget: float,
                          rollout: int = 0) -> SLO:
    """Canary output divergence ≤ ``budget`` — the worst per-row
    divergence between the live tier and the mirrored new-weights tier
    (``:max`` off the rollout-labeled reservoir: ONE poisoned row must
    trip, a percentile could hide it).  The name is rollout-scoped so a
    previous rollout's divergence history can never trip — or mask — the
    next canary."""
    return SLO(
        name=f"canary-divergence/model={model}", kind="threshold",
        budget=budget,
        value=f"serve/canary/divergence/model={model}/swap={rollout}:max",
        description=f"worst mirrored-output divergence of the {model} "
                    f"canary <= {budget}")


def canary_latency_slo(model: str, budget_s: float,
                       rollout: int = 0) -> SLO:
    """Canary modeled service latency p99 ≤ ``budget_s`` — catches a new
    checkpoint whose tiers got slower even when outputs match."""
    return SLO(
        name=f"canary-latency/model={model}", kind="threshold",
        budget=budget_s,
        value=f"serve/canary/latency_s/model={model}/swap={rollout}:p99",
        description=f"p99 modeled canary service latency of {model} "
                    f"<= {budget_s}s")


def canary_slos(model: str, divergence_budget: float,
                latency_budget_s: Optional[float] = None,
                rollout: int = 0) -> List[SLO]:
    """The objectives one hot-swap canary stage evaluates (a fresh
    evaluator per rollout, over rollout-labeled metric names)."""
    out = [canary_divergence_slo(model, divergence_budget, rollout)]
    if latency_budget_s is not None:
        out.append(canary_latency_slo(model, latency_budget_s, rollout))
    return out


def _match_sum(counters: Dict[str, Any],
               patterns: Sequence[str]) -> float:
    total = 0.0
    for p in patterns:
        if p.endswith("*"):
            prefix = p[:-1]
            total += sum(float(v) for k, v in counters.items()
                         if k.startswith(prefix))
        else:
            v = counters.get(p)
            if v is not None:
                total += float(v)
    return total


def _match_value(histograms: Dict[str, Any], selector: str
                 ) -> Optional[float]:
    pattern, field = selector.rsplit(":", 1)
    vals: List[float] = []
    if pattern.endswith("*"):
        names = [k for k in histograms if k.startswith(pattern[:-1])]
    else:
        names = [pattern] if pattern in histograms else []
    for n in names:
        v = histograms[n].get(field)
        if v is not None:
            vals.append(float(v))
    return max(vals) if vals else None


@dataclasses.dataclass
class SloDecision:
    """One :meth:`SloEvaluator.decide` verdict.

    ``overloaded`` is the ladder input; ``burning`` names every SLO over
    threshold on BOTH windows; ``new_trips`` the subset that just
    transitioned into burning; ``scale_hint`` the autoscaler signal (+1 grow / 0 hold /
    −1 shrink)."""

    t: float
    overloaded: bool
    burning: List[str]
    new_trips: List[str]
    recovered: List[str]
    scale_hint: int
    per_slo: Dict[str, Dict[str, Any]]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "t": round(self.t, 6),
            "overloaded": self.overloaded,
            "burning": list(self.burning),
            "new_trips": list(self.new_trips),
            "recovered": list(self.recovered),
            "scale_hint": self.scale_hint,
            "per_slo": {k: dict(v) for k, v in self.per_slo.items()},
        }


class SloEvaluator:
    """Sliding-window burn-rate evaluation over registry snapshots.

    ``observe(snapshot, t)`` ingests one
    ``MetricRegistry.snapshot()`` at clock instant ``t``;
    ``decide(t)`` evaluates every SLO over the fast and slow windows
    and appends to ``timeline``.  ``time_scale`` shrinks the
    wall-clock-equivalent windows onto the caller's (virtual) clock:
    at ``time_scale=1/100`` the 5 min / 1 h windows become 3 s / 36 s.

    ``registry`` (optional): burns and trips are mirrored into it under
    ``slo/*`` names, for consumers that read only the registry.

    Memory is bounded: observations are pruned to the slow window, and
    ``timeline`` is a ring of the last ``timeline_cap`` decisions
    (evictions counted); peak burns and trip counts are kept
    incrementally, so :meth:`report` stays correct at any uptime.
    """

    def __init__(self, slos: Optional[Sequence[SLO]] = None,
                 fast_window_s: float = FAST_WINDOW_S,
                 slow_window_s: float = SLOW_WINDOW_S,
                 time_scale: float = 1.0,
                 fast_burn: float = FAST_BURN,
                 slow_burn: float = SLOW_BURN,
                 recover_burn: float = 0.5,
                 timeline_cap: int = 4096,
                 registry=None):
        self.slos = list(slos) if slos is not None \
            else default_serving_slos()
        if not self.slos:
            raise ValueError("need at least one SLO")
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        if time_scale <= 0:
            raise ValueError("time_scale must be > 0")
        if fast_window_s * time_scale >= slow_window_s * time_scale:
            raise ValueError("fast window must be shorter than slow")
        self.fast_window_s = float(fast_window_s) * float(time_scale)
        self.slow_window_s = float(slow_window_s) * float(time_scale)
        self.time_scale = float(time_scale)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.recover_burn = float(recover_burn)
        self.registry = registry
        #: (t, {slo: (bad, total)}, {slo: value}) observations, t-ordered
        if timeline_cap < 1:
            raise ValueError("timeline_cap must be >= 1")
        self._obs: List[Tuple[float, Dict[str, Tuple[float, float]],
                              Dict[str, Optional[float]]]] = []
        self._burning: Dict[str, bool] = {s.name: False for s in self.slos}
        #: last ``timeline_cap`` decisions (ring; evictions counted)
        self.timeline: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=int(timeline_cap))
        self.timeline_evicted = 0
        # incrementally-maintained aggregates, so report() never
        # rescans (and eviction never corrupts) the decision history
        self._decisions = 0
        self._trip_counts: Dict[str, int] = {s.name: 0 for s in self.slos}
        self._peaks: Dict[str, Dict[str, float]] = {
            s.name: {"fast": 0.0, "slow": 0.0} for s in self.slos}

    # -- feed ----------------------------------------------------------------
    def observe_registry(self, registry, t: float) -> None:
        """Ingest directly from a live :class:`MetricRegistry` with a
        PARTIAL snapshot: counters always (integer reads), histogram
        reservoirs sorted only when a threshold-kind SLO actually needs
        them (the full ``registry.snapshot()`` sorts every reservoir
        for percentiles the ratio SLOs never read).  The runtime's
        decision window calls this; stored snapshots go through
        :meth:`observe`."""
        metrics = registry.metrics()
        counters = {name: m.value for name, m in metrics.items()
                    if m.kind == "counter"}
        hists: Dict[str, Any] = {}
        if any(s.kind == "threshold" for s in self.slos):
            hists = {name: m.snapshot() for name, m in metrics.items()
                     if m.kind == "histogram"}
        self.observe({"counters": counters, "gauges": {},
                      "histograms": hists}, t)

    def observe(self, snapshot: Dict[str, Any], t: float) -> None:
        """Ingest one registry snapshot taken at clock instant ``t``
        (monotonically non-decreasing)."""
        if self._obs and t < self._obs[-1][0]:
            raise ValueError(
                f"observation at t={t} is older than the last "
                f"({self._obs[-1][0]}) — one clock, forward only")
        counters = snapshot.get("counters", {})
        hists = snapshot.get("histograms", {})
        ratios: Dict[str, Tuple[float, float]] = {}
        values: Dict[str, Optional[float]] = {}
        for slo in self.slos:
            if slo.kind == "ratio":
                ratios[slo.name] = (_match_sum(counters, slo.bad),
                                    _match_sum(counters, slo.total))
            else:
                values[slo.name] = _match_value(hists, slo.value)
        self._obs.append((t, ratios, values))
        self._prune(t)

    def _prune(self, now: float) -> None:
        """Drop observations older than the slow window, keeping the
        newest one at-or-before the window start as the delta
        baseline."""
        cutoff = now - self.slow_window_s
        keep_from = 0
        for i, (t, _, _) in enumerate(self._obs):
            if t <= cutoff:
                keep_from = i
            else:
                break
        self._obs = self._obs[keep_from:]

    # -- windowed math -------------------------------------------------------
    def _window(self, slo: SLO, window_s: float, now: float
                ) -> Dict[str, Any]:
        """One SLO over one window ending at ``now``: the measured
        fraction/value and its burn rate.  No observations (or an empty
        total) reads as burn 0 — absence of traffic is not a burn."""
        start = now - window_s
        if slo.kind == "ratio":
            cur: Optional[Tuple[float, float]] = None
            base = (0.0, 0.0)   # counters are zero before attach
            for t, ratios, _ in self._obs:
                if t <= start:
                    base = ratios[slo.name]
                if t <= now:
                    cur = ratios[slo.name]
            if cur is None:
                return {"fraction": None, "burn": 0.0}
            d_bad = cur[0] - base[0]
            d_total = cur[1] - base[1]
            if d_total <= 0:
                return {"fraction": None, "burn": 0.0}
            frac = d_bad / d_total
            return {"fraction": round(frac, 6),
                    "burn": round(frac / slo.budget, 4)}
        vals = [values[slo.name] for t, _, values in self._obs
                if start < t <= now and values.get(slo.name) is not None]
        if not vals:
            return {"value": None, "burn": 0.0}
        mean = sum(vals) / len(vals)
        return {"value": round(mean, 6),
                "burn": round(mean / slo.budget, 4)}

    # -- verdicts ------------------------------------------------------------
    def decide(self, t: float) -> SloDecision:
        """Evaluate every SLO at instant ``t``; returns (and logs to
        ``timeline``) the multi-window verdict.  An SLO burns when
        fast-burn ≥ ``fast_burn`` AND slow-burn ≥ ``slow_burn``; it
        recovers as soon as either window drops below its threshold
        (the fast window releases first in practice — recovery is not
        held hostage by the slow window's memory)."""
        per: Dict[str, Dict[str, Any]] = {}
        burning: List[str] = []
        new_trips: List[str] = []
        recovered: List[str] = []
        for slo in self.slos:
            fast = self._window(slo, self.fast_window_s, t)
            slow = self._window(slo, self.slow_window_s, t)
            is_burning = (fast["burn"] >= self.fast_burn
                          and slow["burn"] >= self.slow_burn)
            was = self._burning[slo.name]
            if is_burning and not was:
                new_trips.append(slo.name)
            elif was and not is_burning:
                recovered.append(slo.name)
            self._burning[slo.name] = is_burning
            if is_burning:
                burning.append(slo.name)
            per[slo.name] = {"fast": fast, "slow": slow,
                             "burning": is_burning,
                             "budget": slo.budget, "kind": slo.kind}
        if burning:
            hint = 1
        elif all(p["fast"]["burn"] <= self.recover_burn
                 and p["slow"]["burn"] <= self.recover_burn
                 for p in per.values()):
            hint = -1
        else:
            hint = 0
        decision = SloDecision(t=t, overloaded=bool(burning),
                               burning=burning, new_trips=new_trips,
                               recovered=recovered, scale_hint=hint,
                               per_slo=per)
        self._decisions += 1
        for name in new_trips:
            self._trip_counts[name] += 1
        for name, p in per.items():
            pk = self._peaks[name]
            pk["fast"] = max(pk["fast"], p["fast"]["burn"])
            pk["slow"] = max(pk["slow"], p["slow"]["burn"])
        if len(self.timeline) == self.timeline.maxlen:
            self.timeline_evicted += 1
        self.timeline.append(decision.as_dict())
        self._export(decision)
        return decision

    def _export(self, d: SloDecision) -> None:
        if self.registry is None:
            return
        for name, p in d.per_slo.items():
            self.registry.gauge(
                f"slo/fast_burn/slo={name}").set(p["fast"]["burn"])
            self.registry.gauge(
                f"slo/slow_burn/slo={name}").set(p["slow"]["burn"])
        for name in d.new_trips:
            self.registry.counter(f"slo/trips/slo={name}").inc()

    # -- read ----------------------------------------------------------------
    def trips(self) -> List[Dict[str, Any]]:
        """Timeline entries that tripped at least one SLO into burning
        (the fast-window trip edges)."""
        return [e for e in self.timeline if e["new_trips"]]

    def report(self) -> Dict[str, Any]:
        """The SLO report: objectives, window geometry, trip
        counts, peak burns (incrementally maintained — correct past
        timeline eviction), and the retained decision timeline."""
        return {
            "slos": [{"name": s.name, "kind": s.kind, "budget": s.budget,
                      "description": s.description} for s in self.slos],
            "windows": {
                "fast_s": self.fast_window_s, "slow_s": self.slow_window_s,
                "time_scale": self.time_scale,
                "fast_equivalent_s": self.fast_window_s / self.time_scale,
                "slow_equivalent_s": self.slow_window_s / self.time_scale,
                "fast_burn_threshold": self.fast_burn,
                "slow_burn_threshold": self.slow_burn,
            },
            "decisions": self._decisions,
            "trips": dict(self._trip_counts),
            "peak_burns": {k: dict(v)
                           for k, v in sorted(self._peaks.items())},
            "timeline": list(self.timeline),
            "timeline_evicted": self.timeline_evicted,
        }
