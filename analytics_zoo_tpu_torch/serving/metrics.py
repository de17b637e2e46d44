"""Serving metrics: the numbers an operator reads (counterpart of
``serving/metrics.py``).

Counters and reservoirs in a :class:`~analytics_zoo_tpu_torch.obs.
registry.MetricRegistry`, no clock reads of their own: every timestamp
comes from the runtime's injected clock, so a virtual-clock run gives
the same snapshot every time.  In a multiplexed runtime each outcome
also lands under model-labeled names (``serve/<metric>/model=<m>...``),
which the per-model SLOs read; the unlabeled totals are always kept.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.obs.registry import MetricRegistry, nearest_rank


def percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (no interpolation); None on empty."""
    return nearest_rank(sorted(float(x) for x in xs), q)


class ServingMetrics:
    """Per-request outcomes and per-dispatch observations.  Metric names:
    ``serve/submitted``, ``serve/shed/cause=...``,
    ``serve/latency_s/tier=N``, ``serve/batch_fill``,
    ``serve/queue_depth``, ``serve/redispatches``."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 reservoir: int = 2048):
        self.registry = registry if registry is not None else MetricRegistry()
        self.reservoir = int(reservoir)
        self._r = self.registry
        self.deadline_misses = 0        # completed but late
        self._tiers: List[int] = []     # tiers with >= 1 completion, sorted

    # -- feed ----------------------------------------------------------------
    def on_submit(self, model: Optional[str] = None) -> None:
        self._r.counter("serve/submitted").inc()
        if model is not None:
            self._r.counter(f"serve/submitted/model={model}").inc()

    def on_shed(self, cause: str, model: Optional[str] = None) -> None:
        self._r.counter(f"serve/shed/cause={cause}").inc()
        if model is not None:
            self._r.counter(f"serve/shed/model={model}/cause={cause}").inc()

    def on_complete(self, latency_s: float, tier: int, missed: bool,
                    model: Optional[str] = None) -> None:
        self._r.counter("serve/completed").inc()
        tier = int(tier)
        if tier not in self._tiers:
            self._tiers = sorted(self._tiers + [tier])
        self._r.histogram(f"serve/latency_s/tier={tier}",
                          max_samples=self.reservoir).observe(latency_s)
        if model is not None:
            self._r.counter(f"serve/completed/model={model}").inc()
            self._r.histogram(f"serve/latency_s/model={model}/tier={tier}",
                              max_samples=self.reservoir).observe(latency_s)
        if missed:
            self.deadline_misses += 1
            self._r.counter("serve/deadline_misses_completed_late").inc()
            if model is not None:
                self._r.counter(
                    f"serve/deadline_misses_completed_late/model={model}"
                ).inc()

    def on_fail(self, model: Optional[str] = None) -> None:
        self._r.counter("serve/failed").inc()
        if model is not None:
            self._r.counter(f"serve/failed/model={model}").inc()

    def on_batch(self, n_valid: int, max_batch: int,
                 queue_depth: int) -> None:
        self._r.counter("serve/batches").inc()
        self._r.histogram("serve/batch_fill",
                          max_samples=self.reservoir).observe(
            n_valid / max(max_batch, 1))
        self._r.histogram("serve/queue_depth",
                          max_samples=self.reservoir).observe(
            float(queue_depth))

    # -- read ----------------------------------------------------------------
    def _count(self, name: str) -> int:
        # az-allow: registered-metric-names — read-side accessor over names this class itself registered (all declared serve/* entries)
        return self._r.counter(name).value

    @property
    def submitted(self) -> int:
        return self._count("serve/submitted")

    @property
    def completed(self) -> int:
        return self._count("serve/completed")

    @property
    def failed(self) -> int:
        return self._count("serve/failed")

    @property
    def batches(self) -> int:
        return self._count("serve/batches")

    @property
    def redispatches(self) -> int:
        return self._count("serve/redispatches")

    @redispatches.setter
    def redispatches(self, v: int) -> None:
        c = self._r.counter("serve/redispatches")
        if v < c.value:
            raise ValueError("redispatches is monotonic")
        c.inc(v - c.value)

    @property
    def shed_by_cause(self) -> Dict[str, int]:
        prefix = "serve/shed/cause="
        return {name[len(prefix):]: m.value
                for name, m in self._r.metrics().items()
                if name.startswith(prefix)}

    @property
    def shed_total(self) -> int:
        return sum(self.shed_by_cause.values())

    def _model_shed(self, model: str) -> int:
        prefix = f"serve/shed/model={model}/cause="
        return sum(m.value for name, m in self._r.metrics().items()
                   if name.startswith(prefix))

    def miss_rate(self, model: Optional[str] = None) -> Optional[float]:
        """Deadline-miss rate over the requests with a terminal state: a
        shed or timed-out request missed by definition, a completed-late
        one in the client's hands.  ``model`` narrows it to one
        multiplexed model's requests."""
        if model is None:
            completed, failed, shed = (self.completed, self.failed,
                                       self.shed_total)
            late = self.deadline_misses
        else:
            completed = self._count(f"serve/completed/model={model}")
            failed = self._count(f"serve/failed/model={model}")
            shed = self._model_shed(model)
            late = self._count(
                f"serve/deadline_misses_completed_late/model={model}")
        terminal = completed + failed + shed
        if terminal == 0:
            return None
        return (late + failed + shed) / terminal

    def model_snapshot(self, model: str) -> Dict[str, Any]:
        """One multiplexed model's outcomes: counts and miss rate (its
        latencies stay in the registry's model-labeled reservoirs)."""
        return {
            "submitted": self._count(f"serve/submitted/model={model}"),
            "completed": self._count(f"serve/completed/model={model}"),
            "failed": self._count(f"serve/failed/model={model}"),
            "shed": self._model_shed(model),
            "completed_late": self._count(
                f"serve/deadline_misses_completed_late/model={model}"),
            "deadline_miss_rate": self.miss_rate(model=model),
        }

    def snapshot(self) -> Dict[str, Any]:
        lat = {}
        for tier in self._tiers:
            hs = self._r.histogram(f"serve/latency_s/tier={tier}",
                                   max_samples=self.reservoir).snapshot()
            lat[str(tier)] = {
                "n": hs["count"],
                "p50_s": hs["p50"],
                "p99_s": hs["p99"],
                "max_s": hs["max"],
                "sampled": hs["sampled"],
            }
        fill = self._r.histogram("serve/batch_fill",
                                 max_samples=self.reservoir).snapshot()
        depth = self._r.histogram("serve/queue_depth",
                                  max_samples=self.reservoir).snapshot()
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "shed_by_cause": dict(sorted(self.shed_by_cause.items())),
            "shed_total": self.shed_total,
            "deadline_misses_completed_late": self.deadline_misses,
            "deadline_miss_rate": self.miss_rate(),
            "batches": self.batches,
            "redispatched_batches": self.redispatches,
            "mean_batch_fill": fill["mean"],
            "queue_depth_p50": depth["p50"],
            "queue_depth_max": (int(depth["max"])
                                if depth["max"] is not None else None),
            "latency_by_tier": lat,
        }
