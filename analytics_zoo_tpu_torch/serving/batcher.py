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
- a batch axis of exactly ``max_batch``: partial flushes are padded with
  zero rows and carry ``n_valid``.

Flush rule per bucket: with ``t_est`` the estimated service time of the
bucket's geometry at the current tier, flush when the bucket holds
``max_batch`` requests, or when its earliest deadline satisfies
``deadline - now <= t_est + slack_margin``.  ``service_time(edge, n,
tier)`` gives the estimate, or an online EWMA of observed service times
does when none is given (a geometry never observed estimates +inf, so a
cold runtime flushes at once).  The reference's multiplexed plans and
weighted EDF are ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.bucket import edge_for
from analytics_zoo_tpu_torch.serving.request import AdmissionQueue, Request

#: bucket key for fixed-shape models (no variable axis)
FIXED = "fixed"


@dataclasses.dataclass
class ModelPlan:
    """The batching geometry: ``bucket_edges`` (``None`` = fixed shape),
    the payload leaf padded to the edge (``pad_key``) and the
    valid-length vector's batch key (``length_key``)."""

    bucket_edges: Optional[Sequence[int]] = None
    pad_key: str = "input"
    length_key: Optional[str] = "n_frames"


@dataclasses.dataclass
class AssembledBatch:
    """One device-ready batch: ``requests`` in EDF order, the padded
    ``batch`` dict, the geometry it uses, and the failover latch
    (``redispatched``)."""

    requests: List[Request]
    batch: Dict[str, Any]
    edge: Any                       # bucket edge or FIXED
    n_valid: int
    tier: int = 0
    redispatched: bool = False      # exactly-once failover latch


class DeadlineBatcher:
    """Assemble :class:`AssembledBatch` es from an :class:`AdmissionQueue`.

    ``pad_key`` names the payload leaf padded to the bucket edge;
    ``length_key`` (when set) adds the per-row valid-length vector to a
    bucketed batch."""

    def __init__(self, queue: AdmissionQueue, max_batch: int,
                 bucket_edges: Optional[Sequence[int]] = None,
                 pad_key: str = "input",
                 length_key: Optional[str] = "n_frames",
                 service_time: Optional[Callable[..., float]] = None,
                 slack_margin_s: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.queue = queue
        self.max_batch = int(max_batch)
        self.plan = ModelPlan(
            bucket_edges=(sorted(int(e) for e in bucket_edges)
                          if bucket_edges else None),
            pad_key=pad_key, length_key=length_key)
        self.service_time = service_time
        self.slack_margin_s = float(slack_margin_s)
        # online EWMA of the observed service time per (edge, tier)
        self._ewma: Dict[Tuple[Any, int], float] = {}

    # -- service-time estimate --------------------------------------------
    def estimate_s(self, edge: Any, n: int, tier: int) -> float:
        if self.service_time is not None:
            return float(self.service_time(edge, n, tier))
        return self._ewma.get((edge, tier), float("inf"))

    def observe_service_s(self, edge: Any, seconds: float, tier: int = 0,
                          alpha: float = 0.3) -> None:
        key = (edge, tier)
        prev = self._ewma.get(key)
        self._ewma[key] = (seconds if prev is None
                           else (1 - alpha) * prev + alpha * seconds)

    # -- bucket assignment -------------------------------------------------
    def bucket_of(self, req: Request) -> Any:
        if self.plan.bucket_edges is None or req.length is None:
            return FIXED
        return edge_for(int(req.length), self.plan.bucket_edges)

    # -- assembly ----------------------------------------------------------
    def _group_stats(self) -> Dict[Any, Tuple[int, float]]:
        """One pass over the queue: per edge, (count, earliest deadline)."""
        stats: Dict[Any, Tuple[int, float]] = {}
        for r in self.queue.iter_queued():
            edge = self.bucket_of(r)
            cur = stats.get(edge)
            stats[edge] = ((1, r.deadline_t) if cur is None
                           else (cur[0] + 1, min(cur[1], r.deadline_t)))
        return stats

    def next_batch(self, tier: int, force: bool = False
                   ) -> Optional[AssembledBatch]:
        """Assemble the most urgent flush-ready batch, or ``None`` when
        every bucket can still wait.  ``force=True`` (drain) flushes the
        most urgent non-empty bucket regardless of slack.  Expired
        requests are shed first, never dispatched."""
        self.queue.expire()
        stats = self._group_stats()
        if not stats:
            return None
        now = self.queue.clock.now()
        ready = []
        for edge, (count, earliest) in stats.items():
            full = count >= self.max_batch
            est = self.estimate_s(edge, min(count, self.max_batch), tier)
            urgent = earliest - now <= est + self.slack_margin_s
            if full or urgent or force:
                # ties between buckets go to the smaller edge as a string,
                # the reference's order
                ready.append((earliest, str(edge), edge))
        if not ready:
            return None
        _, _, edge = min(ready, key=lambda t: (t[0], t[1]))
        taken = self.queue.pop_edf(
            predicate=lambda r: self.bucket_of(r) == edge,
            limit=self.max_batch)
        return self._collate(taken, edge, int(tier))

    def _collate(self, reqs: List[Request], edge: Any,
                 tier: int) -> AssembledBatch:
        """Pad rows to the bucket edge and the batch axis to
        ``max_batch``."""
        plan = self.plan
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
        pad = self.max_batch - n_valid
        if pad:
            rows.extend(np.zeros_like(rows[0]) for _ in range(pad))
            lengths.extend(0 for _ in range(pad))
        batch: Dict[str, Any] = {plan.pad_key: np.stack(rows)}
        if edge is not FIXED and plan.length_key:
            batch[plan.length_key] = np.asarray(lengths, np.int32)
        return AssembledBatch(requests=reqs, batch=batch, edge=edge,
                              n_valid=n_valid, tier=tier)
