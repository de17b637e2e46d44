"""Request objects and the bounded earliest-deadline-first admission
queue (counterpart of ``serving/request.py``).

Online serving decides per request whether serving it is still worth
device time.  Two overload behaviours, both explicit:

- **queue full**: ``submit`` raises :class:`~analytics_zoo_tpu_torch.
  resilience.errors.ServerOverloaded` (retryable with backoff) instead of
  buffering without bound;
- **deadline passed while queued**: the request is shed before it reaches
  a device (:class:`~analytics_zoo_tpu_torch.resilience.errors.
  RequestTimeout`), since a late answer costs the same device time as a
  useful one.

Ordering is earliest-deadline-first (EDF), ties in submission order.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional

from analytics_zoo_tpu_torch.resilience.errors import (RequestTimeout,
                                                       ServerOverloaded)

#: terminal request states: every submitted request ends in exactly one
TERMINAL_STATES = ("done", "shed", "timeout", "failed")

#: the model name a single-model runtime serves under; a multiplexed
#: runtime (``ServingRuntime(models=...)``) keys everything per model
DEFAULT_MODEL = "default"


@dataclasses.dataclass
class Request:
    """One inference request.

    ``payload`` is a single sample (``{"input": array}``); ``length`` the
    sample's variable-axis length for bucket assignment (``None`` for
    fixed-shape models); ``deadline_t`` absolute clock time.

    ``model`` names the multiplexed model the request is for: a batch
    never mixes models.  A streaming session's chunk also carries
    ``session`` (its id), ``affinity`` (the rid of the replica that holds
    the session's carry: such a batch runs there or fails) and ``final``
    (the chunk that flushes the session)."""

    rid: int
    payload: Any
    arrival_t: float
    deadline_t: float
    length: Optional[int] = None
    state: str = "pending"          # pending|<terminal>
    result: Any = None
    error: Optional[BaseException] = None
    completed_t: Optional[float] = None
    tier: Optional[int] = None      # degradation tier that served it
    attempts: int = 0               # device dispatches (failover <= 2)
    model: str = DEFAULT_MODEL
    session: Optional[int] = None
    affinity: Optional[int] = None
    final: bool = False

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL_STATES

    def finish(self, state: str, now: float, result: Any = None,
               error: Optional[BaseException] = None) -> None:
        if self.finished:
            raise RuntimeError(f"request {self.rid} already terminal "
                               f"({self.state})")
        if state not in TERMINAL_STATES:
            raise ValueError(f"not a terminal state: {state!r}")
        self.state = state
        self.result = result
        self.error = error
        self.completed_t = now


class AdmissionQueue:
    """Bounded EDF priority queue with shed-before-dispatch.

    ``capacity`` bounds queued requests; on a full queue :meth:`submit`
    sheds the arriving request and raises :class:`ServerOverloaded`,
    after first expiring anything already past its deadline.
    ``on_shed(request, cause)`` observes every shed.  ``shed_expired=
    False`` disables deadline shedding; the bound still holds."""

    def __init__(self, capacity: int, clock,
                 on_shed: Optional[Callable[[Request, str], None]] = None,
                 shed_expired: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.on_shed = on_shed
        self.shed_expired = shed_expired
        self._heap: List[Any] = []     # (deadline_t, seq, Request)
        self._seq = itertools.count()  # FIFO tiebreak for equal deadlines

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def depth(self) -> int:
        return len(self._heap)

    def _shed(self, req: Request, cause: str,
              error: BaseException) -> None:
        req.finish("shed" if cause == "queue_full" else "timeout",
                   self.clock.now(), error=error)
        if self.on_shed is not None:
            self.on_shed(req, cause)

    def expire(self) -> int:
        """Shed every queued request whose deadline has passed; returns
        the number shed."""
        if not self.shed_expired:
            return 0
        now = self.clock.now()
        shed = 0
        # EDF heap: the expired requests are a prefix of the pop order
        while self._heap and self._heap[0][0] <= now:
            _, _, req = heapq.heappop(self._heap)
            self._shed(req, "deadline", RequestTimeout(
                f"request {req.rid}: deadline passed while queued "
                f"(deadline_t={req.deadline_t:.3f}, now={now:.3f})"))
            shed += 1
        return shed

    def submit(self, req: Request) -> None:
        """Admit ``req`` or raise :class:`ServerOverloaded` (the request
        is marked shed with cause ``queue_full`` first, so accounting
        still sees it)."""
        self.expire()
        if len(self._heap) >= self.capacity:
            err = ServerOverloaded(
                f"admission queue full ({self.capacity} queued); "
                f"retry with backoff")
            self._shed(req, "queue_full", err)
            raise err
        heapq.heappush(self._heap, (req.deadline_t, next(self._seq), req))

    def iter_queued(self):
        """Queued requests in arbitrary order (no sort, no mutation)."""
        for entry in self._heap:
            yield entry[2]

    def pop_edf(self, predicate: Optional[Callable[[Request], bool]] = None,
                limit: Optional[int] = None) -> List[Request]:
        """Pop up to ``limit`` requests in EDF order matching
        ``predicate`` (the others are kept, order preserved)."""
        taken: List[Request] = []
        kept: List[Any] = []
        while self._heap and (limit is None or len(taken) < limit):
            entry = heapq.heappop(self._heap)
            if predicate is None or predicate(entry[2]):
                taken.append(entry[2])
            else:
                kept.append(entry)
        for entry in kept:
            heapq.heappush(self._heap, entry)
        return taken

    def peek_deadline(self) -> Optional[float]:
        """Earliest queued deadline (None when empty)."""
        return self._heap[0][0] if self._heap else None

    def snapshot(self) -> Dict[str, Any]:
        return {"depth": len(self._heap), "capacity": self.capacity,
                "earliest_deadline": self.peek_deadline()}
