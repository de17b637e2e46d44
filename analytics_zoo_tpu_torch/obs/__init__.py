"""Telemetry (counterpart of ``obs/``): the metric registry the serving
metrics register into, and the SLO engine that reads it.  Spans, the
flight recorder and the exporters are ROADMAP.md Queue 1 item 13."""

from analytics_zoo_tpu_torch.obs.registry import (DEFAULT_RESERVOIR,
                                                  Counter, Gauge,
                                                  MetricRegistry,
                                                  ReservoirHistogram,
                                                  nearest_rank)
from analytics_zoo_tpu_torch.obs.slo import (SLO, SloDecision, SloEvaluator,
                                             canary_divergence_slo,
                                             canary_latency_slo, canary_slos,
                                             deadline_miss_slo,
                                             default_serving_slos,
                                             model_deadline_miss_slo,
                                             model_shed_rate_slo, model_slos,
                                             p99_latency_slo, shed_rate_slo)

__all__ = ["DEFAULT_RESERVOIR", "Counter", "Gauge", "MetricRegistry",
           "ReservoirHistogram", "SLO", "SloDecision", "SloEvaluator",
           "canary_divergence_slo", "canary_latency_slo", "canary_slos",
           "deadline_miss_slo", "default_serving_slos",
           "model_deadline_miss_slo", "model_shed_rate_slo", "model_slos",
           "nearest_rank", "p99_latency_slo", "shed_rate_slo"]
