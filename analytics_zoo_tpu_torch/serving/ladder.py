"""Graceful degradation ladder: trade answer quality for throughput under
sustained overload, then climb back (counterpart of
``serving/ladder.py``).

Before shedding hard, a serving cell can buy capacity by serving a
cheaper variant of the same model.  For SSD
(``pipelines.ssd.ssd_serving_tiers``): tier 0 full precision, tier 1
int8 weights, tier 2 int8 with a smaller ``keep_topk``.

Transitions use hysteresis: ``down_after`` consecutive overloaded
decision windows step one tier down, ``up_after`` consecutive clean
windows one tier up (asymmetric by default, so the tier does not
oscillate).  The ladder is host state driven by ``observe_window``;
what a tier means is the runtime's business (:class:`ServingTier`).
The reference's SLO-driven input (``observe_decision``) comes with the
SLO engine (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("analytics_zoo_tpu_torch")


@dataclasses.dataclass
class ServingTier:
    """One rung: a name, the forward callable (``batch dict -> rows``),
    the relative service time the batcher may consult (1.0 = tier 0's),
    a note on what quality it gives up, and ``device_program``: a
    zero-argument callable returning ``(fn, example_args)``, the tier's
    device program and example inputs of its shapes."""

    name: str
    forward: Callable[[Dict[str, Any]], Any]
    speed: float = 1.0
    quality_note: str = ""
    device_program: Optional[Callable[[], tuple]] = None


@dataclasses.dataclass
class LadderPolicy:
    """``down_after`` consecutive overloaded windows step one tier down,
    ``up_after`` consecutive clean windows one up.  A window is
    overloaded when it saw a shed or ended with more than ``depth_high``
    batches' worth of queued requests."""

    down_after: int = 2
    up_after: int = 4
    depth_high: int = 2     # in units of max_batch

    def __post_init__(self):
        if self.down_after < 1 or self.up_after < 1:
            raise ValueError("down_after/up_after must be >= 1")


class DegradationLadder:
    """Hysteresis state machine over overload observations.  ``tier`` is
    the current rung (0 = full quality); ``events`` logs every transition
    with its window index."""

    def __init__(self, n_tiers: int, policy: Optional[LadderPolicy] = None):
        if n_tiers < 1:
            raise ValueError("need at least one tier")
        self.n_tiers = int(n_tiers)
        self.policy = policy or LadderPolicy()
        self.tier = 0
        self.overloaded_streak = 0
        self.clean_streak = 0
        self.windows = 0
        self.events: List[Dict[str, Any]] = []

    def observe_window(self, overloaded: bool,
                       detail: Optional[Dict[str, Any]] = None) -> str:
        """Feed one decision window; returns ``"down"``, ``"up"`` or
        ``"hold"``.  Streaks reset on every transition, so each further
        step needs a full fresh streak."""
        self.windows += 1
        action = "hold"
        if overloaded:
            self.clean_streak = 0
            self.overloaded_streak += 1
            if (self.overloaded_streak >= self.policy.down_after
                    and self.tier < self.n_tiers - 1):
                self.tier += 1
                self.overloaded_streak = 0
                action = "down"
        else:
            self.overloaded_streak = 0
            self.clean_streak += 1
            if (self.clean_streak >= self.policy.up_after
                    and self.tier > 0):
                self.tier -= 1
                self.clean_streak = 0
                action = "up"
        if action != "hold":
            ev = {"kind": f"tier_{action}", "window": self.windows,
                  "tier": self.tier, **(detail or {})}
            self.events.append(ev)
            logger.warning("serving ladder: tier %s to %d (window %d)",
                           action, self.tier, self.windows)
        return action

    def snapshot(self) -> Dict[str, Any]:
        return {"tier": self.tier, "windows": self.windows,
                "overloaded_streak": self.overloaded_streak,
                "clean_streak": self.clean_streak,
                "transitions": list(self.events)}
