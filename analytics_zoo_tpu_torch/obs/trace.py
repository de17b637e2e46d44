"""Trace analytics (counterpart of ``obs/trace.py``): indexed span
trees over a flight recording, critical paths and tail attribution.

A :class:`TraceStore` ingests a recording (the recorder's JSONL or its
live event list) into per-trace span trees with a query API, and two
analyses ride on it:

- **critical path** (:meth:`TraceStore.critical_path`): one request's
  latency split into the :data:`SEGMENTS` the scheduler spent it in:
  ``queue_wait`` (submit → assembled into a batch), ``batch_assembly``
  (assembled → dispatch), ``dispatch`` (the batch's service, shared with
  its other members), ``failover_redispatch`` (the failed first attempt
  when the batch failed over).  The segments tile the root span, so
  their sum equals its duration for every completed request
  (:meth:`TraceStore.critical_path_conservation`).
- **tail attribution** (:meth:`TraceStore.tail_attribution`): the p99
  cohort against the p50 cohort, segment by segment, and the segment
  that grew most.

A batch span (trace ``batch-<n>``) belongs to all its requests; each
member's own ``dispatch`` span carries the whole batch interval.
Failover instants come from the pool's ``failover`` events in the same
recording.

Plain dict and list processing over the recorder's event schema, with
no clock and no device: the store reads a live ring, a dumped file or
the reference package's recording alike.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.obs.recorder import events_to_jsonl
from analytics_zoo_tpu_torch.obs.registry import nearest_rank

#: critical-path segment names, in request-lifecycle order
SEGMENTS = ("queue_wait", "batch_assembly", "dispatch",
            "failover_redispatch")

#: |sum(segments) - root span extent| tolerance: boundaries telescope
#: over the same rounded-to-1µs timestamps, so only float-add noise
#: plus the root's independently rounded ``dur`` field remain
CONSERVATION_TOL_S = 2e-6


class TraceStore:
    """Indexed, queryable view over one flight recording.

    ``events`` is the recorder's event list (dicts carrying ``kind``;
    spans carry ``trace``/``span``/``parent``/``t0``/``t1``/``status``),
    in ``seq`` order.  The store never mutates the events, and
    :meth:`to_jsonl` re-serializes them byte-identically to
    ``FlightRecorder.to_jsonl``: ingest and export are inverses.
    """

    def __init__(self, events: Iterable[Dict[str, Any]]):
        self.events: List[Dict[str, Any]] = list(events)
        self._spans_by_trace: Dict[str, List[Dict[str, Any]]] = {}
        self._by_kind: Dict[str, List[Dict[str, Any]]] = {}
        self._failovers_by_rid: Dict[int, List[float]] = {}
        # a read-only view: each trace's decomposition is memoized
        self._cp_cache: Dict[str, Dict[str, Any]] = {}
        for e in self.events:
            kind = e.get("kind")
            self._by_kind.setdefault(kind, []).append(e)
            if kind == "span":
                self._spans_by_trace.setdefault(
                    e.get("trace", ""), []).append(e)
            elif kind == "failover":
                for rid in e.get("requests", ()):
                    self._failovers_by_rid.setdefault(rid, []).append(
                        float(e["t"]))

    # -- construction --------------------------------------------------------
    @classmethod
    def from_jsonl(cls, text: str) -> "TraceStore":
        """Parse a flight-recorder JSONL dump (one object per line)."""
        return cls(json.loads(line) for line in text.splitlines() if line)

    @classmethod
    def from_file(cls, path: str) -> "TraceStore":
        with open(path, encoding="utf-8") as f:
            return cls.from_jsonl(f.read())

    @classmethod
    def from_recorder(cls, recorder) -> "TraceStore":
        """Snapshot a live :class:`~analytics_zoo_tpu_torch.obs.recorder.
        FlightRecorder` ring."""
        return cls(recorder.events())

    def to_jsonl(self) -> str:
        """Inverse of :meth:`from_jsonl`: byte-identical to the
        recorder dump it was built from (the same serializer,
        :func:`~analytics_zoo_tpu_torch.obs.recorder.events_to_jsonl`)."""
        return events_to_jsonl(self.events)

    # -- queries -------------------------------------------------------------
    def trace_ids(self, prefix: Optional[str] = None) -> List[str]:
        """Trace ids in first-seen order, optionally prefix-filtered."""
        return [t for t in self._spans_by_trace
                if prefix is None or t.startswith(prefix)]

    def trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """All spans of one trace, in span-id order (parents first —
        the tracer allocates ids monotonically)."""
        return sorted(self._spans_by_trace.get(trace_id, ()),
                      key=lambda s: s["span"])

    def root(self, trace_id: str) -> Optional[Dict[str, Any]]:
        for s in self.trace(trace_id):
            if s.get("parent") is None:
                return s
        return None

    def spans(self, name: Optional[str] = None,
              trace_prefix: Optional[str] = None,
              status: Optional[str] = None,
              t0: Optional[float] = None,
              t1: Optional[float] = None) -> List[Dict[str, Any]]:
        """Filtered span query: by span ``name``, trace-id prefix,
        terminal ``status``, and/or time window (a span matches when
        its own ``[t0, t1]`` interval intersects the queried window; a
        still-open span — ``t1`` null, as in a mid-run black-box dump —
        extends to the end of the recording, because the wedged span
        that never ended is exactly the one a dump query wants)."""
        out = []
        for s in self._by_kind.get("span", ()):
            if name is not None and s.get("name") != name:
                continue
            if trace_prefix is not None and not str(
                    s.get("trace", "")).startswith(trace_prefix):
                continue
            if status is not None and s.get("status") != status:
                continue
            if t1 is not None and s["t0"] > t1:
                continue
            if t0 is not None and s["t1"] is not None and s["t1"] < t0:
                continue
            out.append(s)
        return out

    def events_of(self, kind: str) -> List[Dict[str, Any]]:
        """Non-span point events by kind (``failover``,
        ``replica_fenced``, ``slo_decision``, ...)."""
        return list(self._by_kind.get(kind, ()))

    def requests(self, status: Optional[str] = None) -> List[str]:
        """``req-*`` trace ids whose ROOT span carries ``status``
        (any status when ``None``)."""
        out = []
        for tid in self.trace_ids(prefix="req-"):
            r = self.root(tid)
            if r is not None and (status is None
                                  or r.get("status") == status):
                out.append(tid)
        return out

    # -- critical path -------------------------------------------------------
    def _named(self, trace_id: str) -> Dict[str, Dict[str, Any]]:
        """First span of each name in the trace (the runtime opens at
        most one queue/dispatch span per request)."""
        named: Dict[str, Dict[str, Any]] = {}
        for s in self.trace(trace_id):
            named.setdefault(s["name"], s)
        return named

    def _failover_t(self, rid: Optional[int], lo: float,
                    hi: float) -> Optional[float]:
        if rid is None:
            return None
        for t in self._failovers_by_rid.get(rid, ()):
            if lo <= t <= hi:
                return t
        return None

    def critical_path(self, trace_id: str) -> Dict[str, Any]:
        """Segment decomposition of one request trace.

        For a dispatched request the four :data:`SEGMENTS` tile
        ``[root.t0, root.t1]`` exactly (boundaries are the queue span's
        assembly instant, the dispatch span's endpoints, and the pool's
        ``failover`` event when the batch was redispatched); a request
        shed or timed out before dispatch spent its whole life in
        ``queue_wait``.  ``residual_s`` is the tiling error —
        :meth:`critical_path_conservation` pins it ≈0 for every
        completed request.  Memoized (the store is an immutable view);
        callers must not mutate the returned dict.
        """
        cached = self._cp_cache.get(trace_id)
        if cached is not None:
            return cached
        root = self.root(trace_id)
        if root is None:
            raise KeyError(f"no root span for trace {trace_id!r}")
        if root["t1"] is None:
            raise ValueError(f"trace {trace_id!r}: root span never ended")
        named = self._named(trace_id)
        queue = named.get("queue")
        disp = named.get("dispatch")
        e2e = root["t1"] - root["t0"]
        seg = {name: 0.0 for name in SEGMENTS}
        batch = None
        tier = None
        if disp is not None and disp.get("t1") is not None:
            attrs = disp.get("attrs", {})
            if "batch" in attrs:
                batch = f"batch-{attrs['batch']}"
            tier = attrs.get("tier")
            q_end = queue["t1"] if queue is not None and \
                queue.get("t1") is not None else disp["t0"]
            seg["queue_wait"] = q_end - root["t0"]
            seg["batch_assembly"] = disp["t0"] - q_end
            rid = root.get("attrs", {}).get("rid")
            fo_t = self._failover_t(rid, disp["t0"], disp["t1"])
            if fo_t is not None:
                seg["failover_redispatch"] = fo_t - disp["t0"]
                seg["dispatch"] = disp["t1"] - fo_t
            else:
                seg["dispatch"] = disp["t1"] - disp["t0"]
        else:
            seg["queue_wait"] = e2e
        cp = {
            "trace": trace_id,
            "status": root.get("status"),
            "latency_s": e2e,
            "segments": seg,
            "residual_s": e2e - sum(seg.values()),
            "batch": batch,
            "tier": tier,
        }
        self._cp_cache[trace_id] = cp
        return cp

    def critical_path_conservation(
            self, tol_s: float = CONSERVATION_TOL_S) -> Dict[str, Any]:
        """Structural check: for EVERY completed (``done``) request the
        segment sum reconciles with the root span duration within
        ``tol_s`` (timestamp-rounding float noise only).  A violation
        means the decomposition dropped or double-counted time — the
        attribution report would be lying."""
        violations: List[str] = []
        checked = 0
        for tid in self.requests(status="done"):
            cp = self.critical_path(tid)
            checked += 1
            if abs(cp["residual_s"]) > tol_s:
                violations.append(
                    f"{tid}: segments sum to "
                    f"{sum(cp['segments'].values()):.6f}s but root span "
                    f"is {cp['latency_s']:.6f}s "
                    f"(residual {cp['residual_s']:+.2e}s)")
        return {"checked": checked, "violations": violations,
                "ok": checked > 0 and not violations}

    # -- tail attribution ----------------------------------------------------
    def tail_attribution(self, p_lo: float = 50.0,
                         p_hi: float = 99.0) -> Dict[str, Any]:
        """Which segment makes the tail the tail?

        Over all completed requests, the ``p_hi`` cohort (latency ≥ the
        p_hi latency) is compared with the ``p_lo`` cohort (latency ≤
        the p_lo latency) segment by segment: per-cohort mean seconds,
        the delta, and each segment's share of the total cohort gap.
        ``dominant_segment`` is the one that grew most — the answer to
        "where is the p99 coming from".  Requests that never completed
        (shed / timeout / failed) are counted by status alongside: they
        are the tail beyond the tail.
        """
        paths = [self.critical_path(t) for t in self.requests("done")]
        by_status: Dict[str, int] = {}
        for tid in self.requests():
            st = str(self.root(tid).get("status"))
            by_status[st] = by_status.get(st, 0) + 1
        if not paths:
            return {"n_done": 0, "by_status": by_status,
                    "note": "no completed requests to attribute"}
        lat_sorted = sorted(p["latency_s"] for p in paths)
        lo_cut = nearest_rank(lat_sorted, p_lo)
        hi_cut = nearest_rank(lat_sorted, p_hi)
        lo = [p for p in paths if p["latency_s"] <= lo_cut]
        hi = [p for p in paths if p["latency_s"] >= hi_cut]

        def mean(xs: List[float]) -> float:
            return sum(xs) / len(xs)

        lo_mean = mean([p["latency_s"] for p in lo])
        hi_mean = mean([p["latency_s"] for p in hi])
        gap = hi_mean - lo_mean
        segments: Dict[str, Dict[str, float]] = {}
        for name in SEGMENTS:
            m_lo = mean([p["segments"][name] for p in lo])
            m_hi = mean([p["segments"][name] for p in hi])
            segments[name] = {
                f"p{p_lo:g}_mean_s": round(m_lo, 6),
                f"p{p_hi:g}_mean_s": round(m_hi, 6),
                "delta_s": round(m_hi - m_lo, 6),
                "share_of_gap": (round((m_hi - m_lo) / gap, 4)
                                 if gap > 0 else None),
            }
        dominant = max(SEGMENTS, key=lambda n: segments[n]["delta_s"])
        return {
            "n_done": len(paths),
            "by_status": dict(sorted(by_status.items())),
            "percentiles": {f"p{p_lo:g}_s": round(lo_cut, 6),
                            f"p{p_hi:g}_s": round(hi_cut, 6)},
            "cohorts": {
                f"p{p_lo:g}": {"n": len(lo),
                               "mean_latency_s": round(lo_mean, 6)},
                f"p{p_hi:g}": {"n": len(hi),
                               "mean_latency_s": round(hi_mean, 6)},
            },
            "cohort_gap_s": round(gap, 6),
            "segments": segments,
            "dominant_segment": dominant,
        }

    # -- summaries -----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        spans = self._by_kind.get("span", [])
        kinds = {k: len(v) for k, v in sorted(self._by_kind.items())}
        return {"events": len(self.events), "spans": len(spans),
                "traces": len(self._spans_by_trace),
                "requests": len(self.trace_ids("req-")),
                "events_by_kind": kinds}


def format_critical_path(cp: Dict[str, Any]) -> str:
    """One human-readable block for a request's critical path."""
    lines = [f"trace {cp['trace']}  status={cp['status']}  "
             f"latency={cp['latency_s'] * 1e3:.3f}ms  "
             f"tier={cp['tier']}  batch={cp['batch']}"]
    total = cp["latency_s"] or 1.0
    for name in SEGMENTS:
        v = cp["segments"][name]
        bar = "#" * int(round(40 * v / total)) if total > 0 else ""
        lines.append(f"  {name:<20} {v * 1e3:9.3f}ms "
                     f"{100 * v / total:5.1f}%  {bar}")
    return "\n".join(lines)


def attribution_rows(report: Dict[str, Any]) -> List[Tuple[str, str]]:
    """(segment, rendered row) pairs of a tail-attribution report."""
    rows = []
    for name, s in report.get("segments", {}).items():
        # numeric sort on the parsed percentile — lexicographic order
        # would swap pairs like p5/p50
        lo_k, hi_k = sorted(
            (k for k in s if k.endswith("_mean_s")),
            key=lambda k: float(k[1:-len("_mean_s")]))
        share = s["share_of_gap"]
        rows.append((name, (
            f"{name:<20} {s[lo_k] * 1e3:9.3f}ms -> {s[hi_k] * 1e3:9.3f}ms"
            f"  delta {s['delta_s'] * 1e3:+9.3f}ms"
            f"  share {share if share is not None else '-'}")))
    return rows
