"""Closed-loop autoscaling (counterpart of ``serving/autoscale.py``): the
SLO engine's burn-rate signal actuates the pool.

- :class:`AutoscalePolicy`: pool bounds, how many consecutive burning
  decisions grow the pool, how many consecutive well-under-budget
  decisions (``scale_hint == -1``) shrink it, and a cooldown after each
  actuation.  Growing is cheap and urgent; shrinking into marginal load
  re-creates the burn, so the shrink streak is long and any other hint
  resets it.  With mesh-slice replicas the bounds count slices of
  ``slice_width`` devices and ``device_budget`` is the device ceiling
  they must fit (validated at construction); ``reshape_width`` arms the
  width-grow decision :class:`Reshape`.
- :class:`Autoscaler`: decisions in (``observe_decision``, or a raw
  registry snapshot's ``slo/*`` gauges through ``observe_registry``),
  target pool sizes out.  The runtime executes a target through
  ``ReplicaPool.resize``; ``hold`` freezes actuation during a hot swap's
  canary; ``note_quarantine`` logs devices lost to health evictions.

The ``+1`` hint comes only while an SLO burns on both windows, ``-1``
only when every SLO is far under budget on both (``obs/slo.py``); the
streaks and the cooldown come on top, so one noisy decision never
bounces the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

#: the gauge prefixes the snapshot-only observer reads (the SLO engine's
#: ``slo/fast_burn/slo=<name>`` and ``slo/slow_burn/slo=<name>``)
_FAST_PREFIX = "slo/fast_burn/slo="
_SLOW_PREFIX = "slo/slow_burn/slo="


@dataclasses.dataclass
class AutoscalePolicy:
    """Bounds and hysteresis of the policy loop.

    ``grow_after`` consecutive burning decisions (``scale_hint == +1``)
    grow the pool by ``step``; ``shrink_after`` consecutive idle ones
    (``scale_hint == -1``) shrink it by ``step``; for ``cooldown``
    decisions after an actuation the streaks are ignored.  ``prewarm``
    is recorded on each growth (eager PyTorch has no per-shape compile
    to pre-warm, so a new replica joins ready).

    **Slice units**: with mesh-slice replicas (:class:`~analytics_zoo_
    tpu_torch.serving.replica.ReplicaSlice`) ``min_replicas``,
    ``max_replicas`` and ``step`` count slices of ``slice_width``
    devices, and ``device_budget`` (when set) is the device ceiling the
    bounds must fit, checked here, so a policy whose ``max_replicas ×
    slice_width`` over-subscribes the fleet is refused up front.

    **Width against count**: ``reshape_width`` arms the other
    actuation: when growth is due and a model's batch-fill EWMA shows
    it batch-saturated (``fill >= reshape_fill``), more narrow replicas
    would split full batches, so the loop returns a :class:`Reshape`
    (that model onto width-``reshape_width`` slices) instead of a count
    target.  ``None`` (the default) disables it.
    """

    min_replicas: int = 1
    max_replicas: int = 8
    grow_after: int = 1
    shrink_after: int = 6
    cooldown: int = 2
    step: int = 1
    prewarm: bool = True
    slice_width: int = 1
    device_budget: Optional[int] = None
    reshape_width: Optional[int] = None
    reshape_fill: float = 0.9

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.grow_after < 1 or self.shrink_after < 1 or self.step < 1:
            raise ValueError("grow_after/shrink_after/step must be >= 1")
        if self.cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        if self.slice_width < 1:
            raise ValueError("slice_width must be >= 1")
        if self.device_budget is not None:
            if self.min_replicas * self.slice_width > self.device_budget:
                raise ValueError(
                    f"min_replicas={self.min_replicas} slices of width "
                    f"{self.slice_width} need "
                    f"{self.min_replicas * self.slice_width} devices — "
                    f"over device_budget={self.device_budget}: the "
                    f"floor itself does not fit")
            if self.max_replicas * self.slice_width > self.device_budget:
                raise ValueError(
                    f"max_replicas={self.max_replicas} × slice_width="
                    f"{self.slice_width} = "
                    f"{self.max_replicas * self.slice_width} devices "
                    f"exceeds device_budget={self.device_budget} — "
                    f"bounds are in SLICE units; set max_replicas <= "
                    f"device_budget // slice_width so a width-"
                    f"{self.slice_width} grow cannot over-subscribe "
                    f"the fleet silently")
        if not (0.0 < self.reshape_fill <= 1.0):
            raise ValueError("reshape_fill must be in (0, 1]")
        if self.reshape_width is not None:
            if self.reshape_width <= self.slice_width:
                raise ValueError(
                    f"reshape_width={self.reshape_width} must exceed "
                    f"slice_width={self.slice_width} — a reshape swaps "
                    f"a saturated model onto WIDER slices")
            if self.device_budget is not None \
                    and self.reshape_width > self.device_budget:
                raise ValueError(
                    f"reshape_width={self.reshape_width} exceeds "
                    f"device_budget={self.device_budget}: one reshaped "
                    f"slice would not fit the fleet")

    @property
    def max_devices(self) -> int:
        """The pool ceiling in DEVICE units — what the bounds actually
        spend (``device_budget`` when set, else max_replicas slices)."""
        if self.device_budget is not None:
            return self.device_budget
        return self.max_replicas * self.slice_width


#: the per-device batch past which the reference's serving matmuls stop
#: gaining from more batch (its accelerator's 128-wide matrix unit); not
#: measured on a GPU
OCCUPANCY_KNEE = 128


@dataclasses.dataclass(frozen=True)
class Reshape:
    """The width-grow decision: move ``model``'s tier ladder from
    width-``from_width`` replicas onto width-``to_width`` ones instead
    of adding more narrow replicas, taken when the batch-fill EWMA
    (``fill``) shows the model batch-saturated.  ``rationale`` records
    the occupancy arithmetic behind it."""

    model: str
    from_width: int
    to_width: int
    fill: float
    rationale: str


class Autoscaler:
    """The policy loop: decisions in, target pool sizes out.

    ``registry`` (optional): actuations and the current/target sizes
    are mirrored into it (``autoscale/*`` — see ``obs/names.py``) so a
    scrape shows what the loop did and why-shaped counters
    (grow/shrink/hold) accumulate.  ``events`` is the deterministic
    action log.
    """

    def __init__(self, policy: Optional[AutoscalePolicy] = None,
                 registry=None):
        self.policy = policy or AutoscalePolicy()
        self.registry = registry
        self.grow_streak = 0
        self.shrink_streak = 0
        self.cooldown_left = 0
        self.decisions = 0
        self.grows = 0
        self.shrinks = 0
        self.holds = 0
        self.reshapes = 0
        #: actuation freeze (the hot-swap canary stage sets this): the
        #: loop keeps observing — streaks and cooldown advance normally —
        #: but no target is returned while held.  A canary burn must
        #: trip the ROLLBACK, not mask itself behind fresh capacity.
        self.hold = False
        #: devices lost to health quarantines (note_quarantine) — the
        #: scaler's record of why its ceiling shrank: the pool's
        #: device_budget decrement is the enforcement, this is the log
        self.evicted_devices = 0
        self.events: List[Dict[str, Any]] = []

    # -- feed ----------------------------------------------------------------
    def observe_decision(self, decision, current_size: int,
                         t: Optional[float] = None,
                         saturation: Optional[Dict[str, float]] = None,
                         widths: Optional[Dict[str, int]] = None,
                         ) -> Union[int, Reshape, None]:
        """Feed one :class:`~analytics_zoo_tpu_torch.obs.slo.SloDecision`;
        returns the new TARGET pool size when an actuation is due,
        else ``None`` (hold).  ``saturation``/``widths`` (per-model
        batch-fill EWMA and current slice width — fed by the runtime)
        enable the :class:`Reshape` alternative when the policy arms
        ``reshape_width``."""
        return self.observe_hint(decision.scale_hint, current_size,
                                 t=decision.t if t is None else t,
                                 burning=list(decision.burning),
                                 saturation=saturation, widths=widths)

    def observe_registry(self, snapshot: Dict[str, Any],
                         current_size: int,
                         t: float,
                         fast_burn: float = 2.0, slow_burn: float = 1.0,
                         recover_burn: float = 0.5) -> Optional[int]:
        """Snapshot-only path: reconstruct the hint from the mirrored
        ``slo/*_burn`` gauges of one ``MetricRegistry.snapshot()`` (no
        evaluator object needed).
        Burning = fast ≥ ``fast_burn`` AND slow ≥ ``slow_burn`` per
        SLO; idle = every burn ≤ ``recover_burn`` on both windows."""
        gauges = snapshot.get("gauges", {})
        fast = {k[len(_FAST_PREFIX):]: float(v)
                for k, v in gauges.items() if k.startswith(_FAST_PREFIX)}
        slow = {k[len(_SLOW_PREFIX):]: float(v)
                for k, v in gauges.items() if k.startswith(_SLOW_PREFIX)}
        burning = [name for name in fast
                   if fast[name] >= fast_burn
                   and slow.get(name, 0.0) >= slow_burn]
        if burning:
            hint = 1
        elif fast and all(v <= recover_burn for v in fast.values()) \
                and all(v <= recover_burn for v in slow.values()):
            hint = -1
        else:
            hint = 0
        return self.observe_hint(hint, current_size, t=t, burning=burning)

    def observe_hint(self, hint: int, current_size: int, t: float = 0.0,
                     burning: Optional[List[str]] = None,
                     saturation: Optional[Dict[str, float]] = None,
                     widths: Optional[Dict[str, int]] = None,
                     ) -> Union[int, Reshape, None]:
        """The core loop on a bare ``scale_hint``.  Streak discipline:
        +1 grows the grow streak and kills the shrink streak; −1 the
        inverse; 0 (a fast-only spike, or mixed signals) kills BOTH —
        holding is the correct response to an unconfirmed burn.

        With ``reshape_width`` armed and ``saturation`` provided, a due
        grow first checks width-vs-count: a model whose batch-fill EWMA
        is at/above ``reshape_fill`` (and not yet at ``reshape_width``)
        gets a :class:`Reshape` instead of a count target — more narrow
        replicas would split its already-full batches below the
        occupancy knee (:data:`OCCUPANCY_KNEE`), while one wider slice
        serves the full batch at knee occupancy.  The rationale string
        is the reference's, so that the two loops' logs compare equal.
        """
        self.decisions += 1
        p = self.policy
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self._export(current_size)
            return None
        if hint > 0:
            self.shrink_streak = 0
            self.grow_streak += 1
        elif hint < 0:
            self.grow_streak = 0
            self.shrink_streak += 1
        else:
            self.grow_streak = 0
            self.shrink_streak = 0
        target: Optional[int] = None
        action = None
        if self.grow_streak >= p.grow_after \
                and current_size < p.max_replicas:
            target = min(current_size + p.step, p.max_replicas)
            action = "grow"
        elif self.shrink_streak >= p.shrink_after \
                and current_size > p.min_replicas:
            target = max(current_size - p.step, p.min_replicas)
            action = "shrink"
        if target is not None and self.hold:
            # held (mid-canary): swallow the actuation, keep the streak
            # reset + cooldown so release doesn't fire a stale decision
            self.holds += 1
            self.events.append({
                "kind": "scale_held", "t": round(t, 6),
                "from": current_size, "would": target,
                "action": action, "burning": list(burning or [])})
            self.grow_streak = 0
            self.shrink_streak = 0
            self.cooldown_left = p.cooldown
            self._export(current_size)
            return None
        if action == "grow" and p.reshape_width is not None \
                and saturation:
            # width-vs-count: the most batch-saturated model decides.
            # At/above the fill bar, count-growth splits a full batch
            # below the occupancy knee — swap THIS model onto wider
            # slices instead (the runtime actuates via its reshape
            # path; pool size is unchanged, so no count target).
            model = max(sorted(saturation), key=lambda m: saturation[m])
            fill = float(saturation[model])
            from_w = int((widths or {}).get(model, p.slice_width))
            if fill >= p.reshape_fill and from_w < p.reshape_width:
                self.reshapes += 1
                self.grow_streak = 0
                self.shrink_streak = 0
                self.cooldown_left = p.cooldown
                rationale = (
                    f"batch-fill EWMA {fill:.3f} >= {p.reshape_fill:.2f}"
                    f": {model!r} is batch-saturated — +{p.step} width-"
                    f"{from_w} replica(s) would split full batches "
                    f"below the ~B/{OCCUPANCY_KNEE} occupancy knee "
                    f"(docs/MFU_CEILING.md), while a width-"
                    f"{p.reshape_width} slice serves them at knee "
                    f"occupancy for ~{p.reshape_width / from_w:.0f}x "
                    f"service")
                self.events.append({
                    "kind": "scale_reshape", "t": round(t, 6),
                    "model": model, "from_width": from_w,
                    "to_width": p.reshape_width,
                    "fill": round(fill, 6),
                    "burning": list(burning or []),
                    "rationale": rationale})
                if self.registry is not None:
                    self.registry.counter("autoscale/reshape").inc()
                self._export(current_size)
                return Reshape(model=model, from_width=from_w,
                               to_width=p.reshape_width, fill=fill,
                               rationale=rationale)
        if target is not None:
            if action == "grow":
                self.grows += 1
            else:
                self.shrinks += 1
            self.grow_streak = 0
            self.shrink_streak = 0
            self.cooldown_left = p.cooldown
            self.events.append({
                "kind": f"scale_{action}", "t": round(t, 6),
                "from": current_size, "to": target,
                "burning": list(burning or []),
                "prewarm": p.prewarm})
            if self.registry is not None:
                if action == "grow":
                    self.registry.counter("autoscale/grow").inc()
                else:
                    self.registry.counter("autoscale/shrink").inc()
        self._export(current_size if target is None else target)
        return target

    def note_quarantine(self, replica: int, width: int = 1) -> None:
        """The runtime quarantined ``replica`` (health eviction): its
        ``width`` devices left the fleet permanently, unlike a scale-in
        the next grow could reverse.  Logged so a postmortem can tell an
        autoscaler decision from a health eviction; the hard ceiling
        lives in the pool's decremented ``device_budget``."""
        self.evicted_devices += int(width)
        self.events.append({"kind": "quarantine", "replica": int(replica),
                            "width": int(width),
                            "evicted_devices": self.evicted_devices})

    def _export(self, size: int) -> None:
        if self.registry is not None:
            self.registry.gauge("autoscale/replicas").set(float(size))

    # -- read ----------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "policy": dataclasses.asdict(self.policy),
            "decisions": self.decisions,
            "grows": self.grows,
            "shrinks": self.shrinks,
            "holds": self.holds,
            "reshapes": self.reshapes,
            "evicted_devices": self.evicted_devices,
            "actions": list(self.events),
        }
