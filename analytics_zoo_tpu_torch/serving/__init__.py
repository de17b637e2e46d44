"""Online serving (counterpart of ``serving/``): a request-level API over
the predictors with explicit overload behaviour, in the spirit of
Clipper's adaptive batching and load shedding and Clockwork's
predictable latency.

- :mod:`clock`: injected time (:class:`VirtualClock` for tests,
  :class:`MonotonicClock` on the card);
- :mod:`request`: :class:`Request`, the bounded EDF
  :class:`AdmissionQueue` with shed-before-dispatch;
- :mod:`batcher`: :class:`DeadlineBatcher`, flush on full or urgent over
  fixed geometries;
- :mod:`replica`: :class:`Replica` / :class:`ReplicaPool`: StallWatchdog
  supervision, fencing, exactly-once failover, restart, resize;
- :mod:`ladder`: :class:`DegradationLadder` over :class:`ServingTier`
  rungs (SSD: fp, int8, int8 with a smaller ``keep_topk``);
- :mod:`metrics`: :class:`ServingMetrics`;
- :mod:`runtime`: :class:`ServingRuntime`, the synchronous scheduler
  over them, single model and serial.
"""

from analytics_zoo_tpu_torch.serving.autoscale import OCCUPANCY_KNEE, Reshape
from analytics_zoo_tpu_torch.serving.batcher import (FIXED, AssembledBatch,
                                                     DeadlineBatcher,
                                                     ModelPlan)
from analytics_zoo_tpu_torch.serving.clock import (Clock, MonotonicClock,
                                                   VirtualClock)
from analytics_zoo_tpu_torch.serving.ladder import (DegradationLadder,
                                                    LadderPolicy, ServingTier)
from analytics_zoo_tpu_torch.serving.metrics import ServingMetrics, percentile
from analytics_zoo_tpu_torch.serving.replica import Replica, ReplicaPool
from analytics_zoo_tpu_torch.serving.request import (TERMINAL_STATES,
                                                     AdmissionQueue, Request)
from analytics_zoo_tpu_torch.serving.runtime import (DEFAULT_MODEL,
                                                     ModelConfig,
                                                     ServingRuntime)

__all__ = [k for k in dir() if not k.startswith("_")]
