"""Deadline-aware batch assembly over fixed geometries (counterpart of
``serving/batcher.py``).

Batching amortizes the per-dispatch cost, but waiting to fill a batch
spends the queued requests' deadline slack.  The compromise (Clipper's
adaptive batching): flush a bucket when it is full, or when its most
urgent request can no longer afford to wait.

Geometry discipline: assembled batches only use

- a variable axis from the configured ``bucket_edges`` (the
  :func:`analytics_zoo_tpu_torch.data.bucket.edge_for` rule of the
  training side's ``BucketBatcher``), and
- a batch axis of exactly the model's batch size: partial flushes are
  padded with zero rows and carry ``n_valid``.

Flush rule per bucket: with ``t_est`` the estimated service time of the
bucket's geometry at the current tier, flush when the bucket holds a
full batch, or when its earliest deadline satisfies ``deadline - now <=
t_est + slack_margin``.  ``service_time`` gives the estimate, or an
online EWMA of observed service times does when none is given (a key
never observed estimates +inf, so a cold runtime flushes at once).

Multiplexing: a batcher given ``plans`` (one :class:`ModelPlan` per
model) keeps a bucket per (model, affinity, edge): models never share a
batch, and a streaming session's chunks group only with chunks pinned to
the same replica.  The EWMA keys per (model, edge, tier), so one model's
learned estimate never flushes or starves another's.  Flush-ready
buckets go in weighted-EDF order: the runtime sets per-model weights
from the SLO burn rates (``set_model_weight``), and a burning model's
slack is divided by its weight.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.bucket import edge_for
from analytics_zoo_tpu_torch.serving.request import (DEFAULT_MODEL,
                                                     AdmissionQueue, Request)

#: bucket key for fixed-shape models (no variable axis)
FIXED = "fixed"


@dataclasses.dataclass
class ModelPlan:
    """One model's batching geometry: ``bucket_edges`` (``None`` = fixed
    shape), the payload leaf padded to the edge (``pad_key``), the
    valid-length vector's batch key (``length_key``), the batch axis
    (``max_batch``, ``None`` = the batcher's) and ``streaming``: a session
    model, whose batches also carry ``session`` (int64, padding rows -1)
    and ``final`` (int8) so that the stateful forward routes each row to
    its session and flushes on the last chunk."""

    bucket_edges: Optional[Sequence[int]] = None
    pad_key: str = "input"
    length_key: Optional[str] = "n_frames"
    max_batch: Optional[int] = None
    streaming: bool = False


@dataclasses.dataclass
class AssembledBatch:
    """One device-ready batch: ``requests`` in EDF order, the padded
    ``batch`` dict, the geometry it uses, and the failover latch
    (``redispatched``).  ``model`` keys the replica's forward table;
    ``affinity`` (a session batch) pins the dispatch to one replica."""

    requests: List[Request]
    batch: Dict[str, Any]
    edge: Any                       # bucket edge or FIXED
    n_valid: int
    tier: int = 0
    redispatched: bool = False      # exactly-once failover latch
    model: str = DEFAULT_MODEL
    affinity: Optional[int] = None

    @property
    def earliest_deadline(self) -> float:
        return min(r.deadline_t for r in self.requests)


class DeadlineBatcher:
    """Assemble :class:`AssembledBatch` es from an :class:`AdmissionQueue`.

    ``pad_key`` names the payload leaf padded to the bucket edge;
    ``length_key`` (when set) adds the per-row valid-length vector to a
    bucketed batch.  ``plans`` (multiplexed mode): model name →
    :class:`ModelPlan`; the ``bucket_edges``/``pad_key``/``length_key``
    arguments then go unused.  With plans ``service_time`` takes
    ``(model, edge, n, tier)``, without them ``(edge, n, tier)``."""

    def __init__(self, queue: AdmissionQueue, max_batch: int,
                 bucket_edges: Optional[Sequence[int]] = None,
                 pad_key: str = "input",
                 length_key: Optional[str] = "n_frames",
                 service_time: Optional[Callable[..., float]] = None,
                 slack_margin_s: float = 0.0,
                 plans: Optional[Dict[str, ModelPlan]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.queue = queue
        self.max_batch = int(max_batch)
        self.multiplexed = plans is not None
        if plans is None:
            plans = {DEFAULT_MODEL: ModelPlan(
                bucket_edges=bucket_edges, pad_key=pad_key,
                length_key=length_key)}
        self.plans: Dict[str, ModelPlan] = {
            name: dataclasses.replace(plan, bucket_edges=(
                sorted(int(e) for e in plan.bucket_edges)
                if plan.bucket_edges else None))
            for name, plan in plans.items()}
        self.service_time = service_time
        self.slack_margin_s = float(slack_margin_s)
        # online EWMA of the observed service time per (model, edge, tier)
        self._ewma: Dict[Tuple[str, Any, int], float] = {}
        # per-model weighted-EDF weights (1.0 = plain EDF)
        self._weights: Dict[str, float] = {}
        self._weighted = False

    def _plan(self, model: str) -> ModelPlan:
        try:
            return self.plans[model]
        except KeyError:
            raise KeyError(f"no batching plan for model {model!r} "
                           f"(registered: {sorted(self.plans)})") from None

    def model_batch(self, model: str) -> int:
        plan = self._plan(model)
        return plan.max_batch if plan.max_batch else self.max_batch

    # -- weighted EDF ------------------------------------------------------
    def set_model_weight(self, model: str, weight: float) -> None:
        """Set ``model``'s dispatch weight (>= 1 boosts): its slack is
        divided by the weight when ready buckets are ranked."""
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self._weights[model] = float(weight)
        self._weighted = any(w != 1.0 for w in self._weights.values())

    def model_weight(self, model: str) -> float:
        return self._weights.get(model, 1.0)

    # -- service-time estimate --------------------------------------------
    def estimate_s(self, edge: Any, n: int, tier: int,
                   model: str = DEFAULT_MODEL) -> float:
        if self.service_time is not None:
            if self.multiplexed:
                return float(self.service_time(model, edge, n, tier))
            return float(self.service_time(edge, n, tier))
        return self._ewma.get((model, edge, tier), float("inf"))

    def observe_service_s(self, edge: Any, seconds: float, tier: int = 0,
                          model: str = DEFAULT_MODEL,
                          alpha: float = 0.3) -> None:
        key = (model, edge, tier)
        prev = self._ewma.get(key)
        self._ewma[key] = (seconds if prev is None
                           else (1 - alpha) * prev + alpha * seconds)

    # -- bucket assignment -------------------------------------------------
    def bucket_of(self, req: Request) -> Any:
        plan = self._plan(req.model)
        if plan.bucket_edges is None or req.length is None:
            return FIXED
        return edge_for(int(req.length), plan.bucket_edges)

    # -- assembly ----------------------------------------------------------
    def _group_stats(self) -> Dict[Tuple[str, Optional[int], Any],
                                   Tuple[int, float]]:
        """One pass over the queue: per (model, affinity, edge), (count,
        earliest deadline)."""
        stats: Dict[Tuple[str, Optional[int], Any], Tuple[int, float]] = {}
        for r in self.queue.iter_queued():
            key = (r.model, r.affinity, self.bucket_of(r))
            cur = stats.get(key)
            stats[key] = ((1, r.deadline_t) if cur is None
                          else (cur[0] + 1, min(cur[1], r.deadline_t)))
        return stats

    def next_batch(self, tier, force: bool = False
                   ) -> Optional[AssembledBatch]:
        """Assemble the most urgent flush-ready batch, or ``None`` when
        every bucket can still wait.  ``tier`` is the current rung, or in
        multiplexed mode a ``{model: tier}`` map.  ``force=True`` (drain)
        flushes the most urgent non-empty bucket regardless of slack.
        Expired requests are shed first, never dispatched."""
        self.queue.expire()
        stats = self._group_stats()
        if not stats:
            return None
        tiers = tier if isinstance(tier, dict) else None
        now = self.queue.clock.now()
        ready = []
        for key, (count, earliest) in stats.items():
            model, affinity, edge = key
            cap = self.model_batch(model)
            m_tier = tiers.get(model, 0) if tiers is not None else int(tier)
            est = self.estimate_s(edge, min(count, cap), m_tier, model=model)
            urgent = earliest - now <= est + self.slack_margin_s
            if count >= cap or urgent or force:
                if self._weighted:
                    # a burning model ranks more urgent both ways: positive
                    # slack shrinks by the weight, negative slack (an
                    # overdue bucket, under shed_expired=False) grows
                    slack = earliest - now
                    w = self.model_weight(model)
                    rank = slack / w if slack >= 0 else slack * w
                else:
                    rank = earliest
                # ties go to the smaller key as a string, the reference's
                # order
                ready.append((rank, f"{model}/{affinity}/{edge}", key))
        if not ready:
            return None
        _, _, (model, affinity, edge) = min(ready, key=lambda t: t[:2])
        taken = self.queue.pop_edf(
            predicate=lambda r: (r.model == model and r.affinity == affinity
                                 and self.bucket_of(r) == edge),
            limit=self.model_batch(model))
        m_tier = tiers.get(model, 0) if tiers is not None else int(tier)
        return self._collate(taken, edge, m_tier, model, affinity)

    def _collate(self, reqs: List[Request], edge: Any, tier: int,
                 model: str, affinity: Optional[int]) -> AssembledBatch:
        """Pad rows to the bucket edge and the batch axis to the model's
        batch size."""
        plan = self._plan(model)
        rows, lengths = [], []
        for r in reqs:
            arr = np.asarray(r.payload[plan.pad_key]
                             if isinstance(r.payload, dict) else r.payload)
            if edge is not FIXED:
                n = min(int(r.length if r.length is not None
                            else arr.shape[0]), int(edge), arr.shape[0])
                padded = np.zeros((int(edge),) + arr.shape[1:], arr.dtype)
                padded[:n] = arr[:n]
                rows.append(padded)
                lengths.append(n)
            else:
                rows.append(arr)
                lengths.append(arr.shape[0] if arr.ndim else 0)
        n_valid = len(rows)
        pad = self.model_batch(model) - n_valid
        if pad:
            rows.extend(np.zeros_like(rows[0]) for _ in range(pad))
            lengths.extend(0 for _ in range(pad))
        batch: Dict[str, Any] = {plan.pad_key: np.stack(rows)}
        if edge is not FIXED and plan.length_key:
            batch[plan.length_key] = np.asarray(lengths, np.int32)
        if plan.streaming:
            batch["session"] = np.asarray(
                [-1 if r.session is None else int(r.session) for r in reqs]
                + [-1] * pad, np.int64)
            batch["final"] = np.asarray(
                [int(bool(r.final)) for r in reqs] + [0] * pad, np.int8)
        return AssembledBatch(requests=reqs, batch=batch, edge=edge,
                              n_valid=n_valid, tier=tier, model=model,
                              affinity=affinity)
