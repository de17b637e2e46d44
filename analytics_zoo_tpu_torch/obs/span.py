"""Spans (counterpart of ``obs/span.py``): named, timed, parented
intervals under a trace id.

A trace is every span sharing one ``trace_id``: one serving request's
life (the ``request`` root, its ``queue`` and ``dispatch`` children) or
one train step at its loader coordinates.  Trace ids come from the
domain (a request's rid, ``(epoch, batch)``), never from a random
source, so a seeded run replays with the same ids.

A span reaches the flight recorder when it ends (one event carrying its
start, end and duration): two clock reads and one append on the hot
path.  Timestamps are the injected clock's, never a device's: on an
asynchronous device a span covers the host interval.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.obs.recorder import FlightRecorder
from analytics_zoo_tpu_torch.utils.clock import TimeSource, as_now_fn


class Span:
    """One open interval, made by :meth:`Tracer.start`.  :meth:`end`
    closes it once (a second call does nothing); ``attrs`` merge across
    start and end."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "t_start", "t_end", "status", "attrs")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: int, parent_id: Optional[int], t_start: float,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.status: Optional[str] = None
        self.attrs = attrs

    @property
    def ended(self) -> bool:
        return self.t_end is not None

    def end(self, status: str = "ok", at: Optional[float] = None,
            **attrs: Any) -> None:
        """Close the span and emit it to the recorder.  The first call
        wins (a shed and a drain's flush may race to close a request).
        ``at`` stamps an explicit end instant in place of the clock."""
        if self.ended:
            return
        self.attrs.update(attrs)
        self.t_end = self.tracer.now() if at is None else float(at)
        self.status = status
        self.tracer._emit(self)

    def event(self) -> Dict[str, Any]:
        ev: Dict[str, Any] = {
            "kind": "span",
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "t0": round(self.t_start, 6),
            "t1": round(self.t_end, 6) if self.t_end is not None else None,
            "dur": (round(self.t_end - self.t_start, 6)
                    if self.t_end is not None else None),
            "status": self.status,
        }
        if self.attrs:
            ev["attrs"] = dict(sorted(self.attrs.items()))
        return ev


class Tracer:
    """Span factory over one clock and recorder.

    Span ids are a per-tracer counter.  Parenting is explicit
    (``parent=``), not an ambient stack: the serving scheduler
    interleaves many requests' spans in one thread.  The :meth:`span`
    context manager covers the nested case and marks an escaping
    exception as the span's error."""

    def __init__(self, clock: TimeSource = None,
                 recorder: Optional[FlightRecorder] = None):
        self.now = as_now_fn(clock)
        self.recorder = recorder
        self._next_id = 0
        self.spans_started = 0
        self.spans_ended = 0

    def start(self, name: str, trace_id: str,
              parent: Optional[Span] = None, **attrs: Any) -> Span:
        sid = self._next_id
        self._next_id += 1
        self.spans_started += 1
        if parent is not None and parent.trace_id != trace_id:
            raise ValueError(
                f"span {name!r}: parent belongs to trace "
                f"{parent.trace_id!r}, not {trace_id!r}")
        return Span(self, name, trace_id, sid,
                    parent.span_id if parent is not None else None,
                    self.now(), dict(attrs))

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str,
             parent: Optional[Span] = None, **attrs: Any):
        s = self.start(name, trace_id, parent=parent, **attrs)
        try:
            yield s
        except BaseException as e:
            s.end(status="error", error=f"{type(e).__name__}: {e}")
            raise
        else:
            s.end(status=s.status or "ok")

    def _emit(self, span: Span) -> None:
        self.spans_ended += 1
        if self.recorder is not None:
            self.recorder.record(span.event())


def span_conservation(events: List[Dict[str, Any]],
                      trace_prefix: str = "req-") -> Dict[str, Any]:
    """Structural check over a flight recording: every trace whose id
    starts with ``trace_prefix`` is one rooted tree (one parentless
    root, every parent in the same trace, every span ended).
    ``roots_by_status`` counts roots by status, for the caller to hold
    against its own accounting."""
    traces: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("kind") != "span":
            continue
        tid = e.get("trace", "")
        if isinstance(tid, str) and tid.startswith(trace_prefix):
            traces.setdefault(tid, []).append(e)
    violations: List[str] = []
    roots_by_status: Dict[str, int] = {}
    total_spans = 0
    for tid, spans in sorted(traces.items()):
        total_spans += len(spans)
        ids = {s["span"] for s in spans}
        roots = [s for s in spans if s["parent"] is None]
        if len(roots) != 1:
            violations.append(f"{tid}: {len(roots)} roots")
            continue
        for s in spans:
            if s["parent"] is not None and s["parent"] not in ids:
                violations.append(
                    f"{tid}: span {s['span']} ({s['name']}) parent "
                    f"{s['parent']} missing from trace")
            if s["t1"] is None:
                violations.append(
                    f"{tid}: span {s['span']} ({s['name']}) never ended")
        st = str(roots[0]["status"])
        roots_by_status[st] = roots_by_status.get(st, 0) + 1
    return {
        "traces": len(traces),
        "spans": total_spans,
        "roots_by_status": dict(sorted(roots_by_status.items())),
        "violations": violations,
        "ok": not violations,
    }
