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
- :mod:`replica`: :class:`Replica` / :class:`ReplicaSlice` /
  :class:`ReplicaPool`: StallWatchdog supervision, fencing, exactly-once
  failover, restart, resize under a device budget, quarantine, the
  parallel service model;
- :mod:`autoscale`: :class:`AutoscalePolicy` / :class:`Autoscaler`, the
  SLO burn rates turned into pool sizes;
- :mod:`ladder`: :class:`DegradationLadder` over :class:`ServingTier`
  rungs (SSD: fp, int8, int8 with a smaller ``keep_topk``);
- :mod:`metrics`: :class:`ServingMetrics`;
- :mod:`runtime`: :class:`ServingRuntime`, the synchronous scheduler
  over them, serial or parallel; ``models=[ModelConfig(...)]`` multiplexes several
  models on one pool, with per-model ladders and SLOs, weighted-EDF
  dispatch and session-affine streaming sessions;
- :mod:`follower`: :func:`serve_follower`, the other ranks' half of a
  ``ServingRuntime(specs=)`` over tiers sharded across processes, and
  :class:`SliceLayout`, the mesh cut into slices of replicas.
"""

from analytics_zoo_tpu_torch.serving.autoscale import (OCCUPANCY_KNEE,
                                                       Autoscaler,
                                                       AutoscalePolicy,
                                                       Reshape)
from analytics_zoo_tpu_torch.serving.batcher import (FIXED, AssembledBatch,
                                                     DeadlineBatcher,
                                                     ModelPlan)
from analytics_zoo_tpu_torch.serving.clock import (Clock, MonotonicClock,
                                                   VirtualClock)
from analytics_zoo_tpu_torch.serving.follower import (FollowerFailed,
                                                      SliceLayout,
                                                      serve_follower)
from analytics_zoo_tpu_torch.serving.ladder import (DegradationLadder,
                                                    LadderPolicy, ServingTier)
from analytics_zoo_tpu_torch.serving.metrics import ServingMetrics, percentile
from analytics_zoo_tpu_torch.serving.replica import (Replica, ReplicaPool,
                                                     ReplicaSlice)
from analytics_zoo_tpu_torch.serving.request import (DEFAULT_MODEL,
                                                     TERMINAL_STATES,
                                                     AdmissionQueue, Request)
from analytics_zoo_tpu_torch.serving.runtime import (ModelConfig,
                                                     ServingRuntime)

__all__ = [k for k in dir() if not k.startswith("_")]
