"""Metric registry: counters, gauges and bounded-reservoir histograms
(counterpart of ``obs/registry.py``).

Every metric is named, typed and serialized through one snapshot schema.
Histograms keep a fixed-size reservoir (Vitter's Algorithm R) plus exact
count, sum, min and max, so a long serving run costs O(1) memory per
metric.  Reservoir eviction draws from a ``random.Random`` seeded by the
metric name and the registry seed, so the same observation stream gives
the same snapshot.
"""

from __future__ import annotations

import math
import random
import zlib
from typing import Any, Dict, List, Optional

#: default reservoir size: streams below it are recorded exactly
DEFAULT_RESERVOIR = 2048


def nearest_rank(sorted_xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an already-sorted list (no
    interpolation); None on empty."""
    if not sorted_xs:
        return None
    n = len(sorted_xs)
    k = min(n - 1, max(0, math.ceil(q / 100.0 * n) - 1))
    return float(sorted_xs[k])


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        self.value += n

    def snapshot(self) -> Any:
        return self.value


class Gauge:
    """Last-written value (None until first set)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Any:
        return self.value


class ReservoirHistogram:
    """Exact count/sum/min/max plus a uniform sample of ``max_samples``
    observations (Algorithm R).  Below capacity the reservoir holds every
    observation, so percentiles are exact."""

    kind = "histogram"

    def __init__(self, name: str, max_samples: int = DEFAULT_RESERVOIR,
                 seed: int = 0):
        if max_samples < 1:
            raise ValueError(f"histogram {name}: max_samples must be >= 1")
        self.name = name
        self.max_samples = int(max_samples)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.samples: List[float] = []
        self._rng = random.Random(zlib.crc32(name.encode()) ^ seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self.samples) < self.max_samples:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self.samples[j] = v

    def percentile(self, q: float) -> Optional[float]:
        return nearest_rank(sorted(self.samples), q)

    @property
    def saturated(self) -> bool:
        """True once the reservoir has evicted (percentiles are then
        sampled estimates)."""
        return self.count > self.max_samples

    def snapshot(self) -> Dict[str, Any]:
        s = sorted(self.samples)
        return {
            "count": self.count,
            "sum": self.total,
            "mean": (self.total / self.count) if self.count else None,
            "min": self.min,
            "max": self.max,
            "p50": nearest_rank(s, 50),
            "p99": nearest_rank(s, 99),
            "reservoir": len(s),
            "sampled": self.saturated,
        }


class MetricRegistry:
    """Name → metric, with get-or-create accessors and one snapshot.
    Names follow ``<subsystem>/<metric>[/k=v...]``; re-requesting a name
    with another metric type (or another reservoir size) raises."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  max_samples: int = DEFAULT_RESERVOIR
                  ) -> ReservoirHistogram:
        h = self._get(name, ReservoirHistogram, max_samples=max_samples,
                      seed=self.seed)
        if h.max_samples != int(max_samples):
            raise ValueError(
                f"histogram {name!r} already registered with "
                f"max_samples={h.max_samples}, requested {max_samples}")
        return h

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def metrics(self) -> Dict[str, Any]:
        """Name → metric object, sorted by name."""
        return dict(sorted(self._metrics.items()))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``,
        keys sorted."""
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            out[m.kind + "s"][name] = m.snapshot()
        return out
