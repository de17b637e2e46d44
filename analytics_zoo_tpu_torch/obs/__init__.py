"""The telemetry spine (counterpart of ``obs/``):

- :mod:`span`: :class:`Span`/:class:`Tracer`, trace ids threaded from
  the loader's (epoch, batch) through the train step to the checkpoint,
  and from a request's submit through queue, batch and dispatch, with
  the :func:`span_conservation` check;
- :mod:`registry`: :class:`MetricRegistry`, counters, gauges and
  bounded-reservoir histograms under one snapshot schema;
- :mod:`recorder`: :class:`FlightRecorder`, a bounded ring dumped as
  deterministic JSONL on a terminal condition;
- :mod:`exporters`: the JSONL dump, Prometheus text,
  :class:`SummaryBridge` into the TensorBoard writers;
- :mod:`probe`: :class:`StepProbe`, a step's input wait, dispatch and
  device split;
- :mod:`runmeta`: :func:`run_metadata`, the block that stamps an
  artifact;
- :mod:`trace`: :class:`TraceStore`, span trees over a recording,
  critical paths and p99-vs-p50 attribution;
- :mod:`slo`: :class:`SLO`/:class:`SloEvaluator`, objectives over
  registry snapshots with multi-window burn rates;
- :mod:`names`: :data:`CATALOG`, every registry name declared once.

Everything reads the injected clock (``utils/clock.py``), so a run on a
``VirtualClock`` records the same bytes every time.
"""

from __future__ import annotations

from typing import Optional

from analytics_zoo_tpu_torch.obs.exporters import (SummaryBridge,
                                                   dump_flight_jsonl,
                                                   render_prometheus)
from analytics_zoo_tpu_torch.obs.names import CATALOG, lookup
from analytics_zoo_tpu_torch.obs.probe import StepProbe
from analytics_zoo_tpu_torch.obs.recorder import (DEFAULT_CAPACITY,
                                                  FlightRecorder,
                                                  events_to_jsonl)
from analytics_zoo_tpu_torch.obs.registry import (DEFAULT_RESERVOIR,
                                                  Counter, Gauge,
                                                  MetricRegistry,
                                                  ReservoirHistogram,
                                                  nearest_rank)
from analytics_zoo_tpu_torch.obs.runmeta import run_metadata
from analytics_zoo_tpu_torch.obs.slo import (SLO, SloDecision, SloEvaluator,
                                             canary_divergence_slo,
                                             canary_latency_slo, canary_slos,
                                             deadline_miss_slo,
                                             default_serving_slos,
                                             model_deadline_miss_slo,
                                             model_shed_rate_slo, model_slos,
                                             p99_latency_slo, shed_rate_slo)
from analytics_zoo_tpu_torch.obs.span import Span, Tracer, span_conservation
from analytics_zoo_tpu_torch.obs.trace import (SEGMENTS, TraceStore,
                                               attribution_rows,
                                               format_critical_path)
from analytics_zoo_tpu_torch.utils.clock import TimeSource, as_now_fn


class Observability:
    """The bundle most call sites take: one registry, one flight
    recorder and one tracer on one clock.

    ``dump_path`` arms the black box: a terminal condition
    (``TrainingDiverged``, a preemption, a replica fence) calls
    :meth:`dump` and the ring lands there as JSONL.  A subsystem that
    owns a clock (the serving runtime) calls :meth:`adopt_clock`, and
    the bundle follows it unless a clock was given here."""

    def __init__(self, clock: TimeSource = None,
                 capacity: int = DEFAULT_CAPACITY,
                 registry: Optional[MetricRegistry] = None,
                 dump_path: Optional[str] = None,
                 seed: int = 0):
        self._clock_pinned = clock is not None
        self.registry = registry if registry is not None \
            else MetricRegistry(seed=seed)
        self.recorder = FlightRecorder(capacity=capacity, clock=clock,
                                       dump_path=dump_path)
        self.tracer = Tracer(clock=clock, recorder=self.recorder)

    @property
    def dump_path(self) -> Optional[str]:
        return self.recorder.dump_path

    def adopt_clock(self, clock: TimeSource) -> None:
        """Follow ``clock`` unless one was given at construction."""
        if self._clock_pinned or clock is None:
            return
        now = as_now_fn(clock)
        self.recorder.now = now
        self.tracer.now = now

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        return self.recorder.dump(reason, path=path)


__all__ = ["CATALOG", "Counter", "DEFAULT_CAPACITY", "DEFAULT_RESERVOIR",
           "FlightRecorder", "Gauge", "MetricRegistry", "Observability",
           "ReservoirHistogram", "SEGMENTS", "SLO", "SloDecision",
           "SloEvaluator", "Span", "StepProbe", "SummaryBridge",
           "TraceStore", "Tracer", "attribution_rows",
           "canary_divergence_slo", "canary_latency_slo", "canary_slos",
           "deadline_miss_slo", "default_serving_slos", "dump_flight_jsonl",
           "events_to_jsonl", "format_critical_path", "lookup",
           "model_deadline_miss_slo", "model_shed_rate_slo", "model_slos",
           "nearest_rank", "p99_latency_slo", "render_prometheus",
           "run_metadata", "shed_rate_slo", "span_conservation"]
