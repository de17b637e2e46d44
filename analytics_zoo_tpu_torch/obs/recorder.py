"""The flight recorder (counterpart of ``obs/recorder.py``): a bounded
ring of events with a deterministic JSONL dump.

Every finished span and every point event lands in a ring of fixed
capacity (the oldest overwritten, counted in ``dropped``).  On a
terminal condition (``TrainingDiverged``, a replica fence, a
preemption) the ring is dumped as JSONL, so the seconds before the
failure survive it.

Events are serialized with sorted keys and a rising ``seq``; every
timestamp comes from the injected clock (``utils/clock.py``), rounded
to 1 µs.  Under a :class:`~analytics_zoo_tpu_torch.utils.clock.
VirtualClock` two runs from one seed dump the same bytes.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, Iterable, List, Optional

from analytics_zoo_tpu_torch.utils.clock import TimeSource, as_now_fn

DEFAULT_CAPACITY = 8192


def events_to_jsonl(events: Iterable[Dict[str, Any]]) -> str:
    """The one serialization of a flight recording: a sorted-keys JSON
    object per line, in the given order.  The recorder's dump and
    :meth:`~analytics_zoo_tpu_torch.obs.trace.TraceStore.to_jsonl` both
    use it, so ingest and export are inverses."""
    return "".join(json.dumps(e, sort_keys=True) + "\n" for e in events)


class FlightRecorder:
    """Fixed-capacity event ring.

    ``record`` appends a dict (a ``seq`` is stamped; the caller supplies
    ``kind`` and, by convention, ``t``).  ``note`` records a point event
    with ``t`` from the recorder's clock.  ``dump`` serializes the live
    ring, and writes it to ``dump_path`` when one is set."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: TimeSource = None,
                 dump_path: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.now = as_now_fn(clock)
        self.dump_path = dump_path
        self.dropped = 0          # events overwritten by the ring bound
        self.dumps: List[Dict[str, Any]] = []   # (reason, path) log
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._ring)

    # -- feed ----------------------------------------------------------------
    def record(self, event: Dict[str, Any]) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        event = dict(event)
        event["seq"] = self._seq
        self._seq += 1
        self._ring.append(event)

    def note(self, kind: str, **fields: Any) -> None:
        """Record one point event (``kind`` and fields; ``t`` from the
        recorder's clock unless the caller gave one)."""
        fields.setdefault("t", round(self.now(), 6))
        fields["kind"] = kind
        self.record(fields)

    # -- read ----------------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        evs: Iterable[Dict[str, Any]] = self._ring
        if kind is not None:
            evs = (e for e in evs if e.get("kind") == kind)
        return list(evs)

    def to_jsonl(self) -> str:
        """The ring as JSONL, oldest first."""
        return events_to_jsonl(self._ring)

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        """Serialize the ring and write it to ``path`` (or ``dump_path``)
        when one is set; return the text either way.  Every dump is
        logged in ``dumps`` with its reason."""
        text = self.to_jsonl()
        target = path or self.dump_path
        if target:
            os.makedirs(os.path.dirname(os.path.abspath(target)),
                        exist_ok=True)
            with open(target, "w") as f:
                f.write(text)
        self.dumps.append({"reason": reason, "path": target,
                           "events": len(self._ring),
                           "dropped": self.dropped})
        return text
