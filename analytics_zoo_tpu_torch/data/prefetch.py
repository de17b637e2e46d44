"""Bounded-window overlap of host prep, device execution and readback
(counterpart of ``overlap_window`` in ``data/prefetch.py``)."""

from __future__ import annotations

from collections import deque


def overlap_window(items, dispatch, consume, max_inflight: int = 4) -> None:
    """``dispatch(item)`` enqueues device work and returns a token without
    waiting for it; ``consume(token)`` brings the result to the host.  Up
    to ``max_inflight`` items are in flight, so the next items' host prep
    overlaps the device's work without every input piling up on it."""
    pending: deque = deque()
    for item in items:
        pending.append(dispatch(item))
        if len(pending) >= max_inflight:
            consume(pending.popleft())
    while pending:
        consume(pending.popleft())
