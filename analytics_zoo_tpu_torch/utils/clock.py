"""The injected time source (counterpart of ``utils/clock.py``).

Every part of the serving runtime that decides by time (deadlines,
shedding, replica restarts, the :class:`~analytics_zoo_tpu_torch.
resilience.watchdog.StallWatchdog` deadline) reads it through one clock
object instead of ``time.monotonic``.  Production uses
:class:`MonotonicClock`; tests use :class:`VirtualClock`, where time
moves only when the harness says so, so an overload burst with a replica
crash replays the same way every run.

:func:`as_now_fn` bridges the two conventions: a ``Clock`` object or a
bare ``now()`` callable.
"""

from __future__ import annotations

import time
from typing import Callable, Union


class Clock:
    """Interface: ``now()`` seconds (monotonic), ``sleep(s)``."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class MonotonicClock(Clock):
    """Real wall time (``time.monotonic``)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(max(0.0, seconds))


class VirtualClock(Clock):
    """Deterministic manual time: ``now()`` returns the current virtual
    instant; ``advance``/``sleep`` move it forward.  Single-threaded by
    design: the serving runtime's scheduler is synchronous."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"cannot advance time backwards ({seconds})")
        self._t += float(seconds)
        return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)


TimeSource = Union[Clock, Callable[[], float], None]


def as_now_fn(clock: TimeSource) -> Callable[[], float]:
    """Normalize a time source to a bare ``now()`` callable: a
    :class:`Clock`, an existing callable, or ``None`` (monotonic time)."""
    if clock is None:
        return time.monotonic
    if callable(clock):
        return clock
    return clock.now
