"""Telemetry (counterpart of ``obs/``): the metric registry the serving
metrics register into.  Spans, the flight recorder, exporters and the
SLO engine are ROADMAP.md Queue 1 item 13."""

from analytics_zoo_tpu_torch.obs.registry import (DEFAULT_RESERVOIR,
                                                  Counter, Gauge,
                                                  MetricRegistry,
                                                  ReservoirHistogram,
                                                  nearest_rank)

__all__ = ["DEFAULT_RESERVOIR", "Counter", "Gauge", "MetricRegistry",
           "ReservoirHistogram", "nearest_rank"]
