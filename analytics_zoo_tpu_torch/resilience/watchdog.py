"""Host-side stall detection, pull mode (counterpart of
``resilience/watchdog.py``).

A hung device call does not raise: it blocks the host loop.  The
serving runtime supervises each replica forward with a
:class:`StallWatchdog` on its injected clock: ``beat`` when the forward
starts, ``check`` when it returns, so a forward whose duration passed
``timeout_s`` is a wedge even though it returned.  The reference's push
mode (a monitor thread that interrupts the main thread) waits for the
training supervisor (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.resilience.errors import StallError
from analytics_zoo_tpu_torch.utils.clock import as_now_fn


class StallWatchdog:
    """Heartbeat deadline over an injected clock (a ``Clock`` or a bare
    ``now()`` callable; ``None`` is monotonic time)."""

    def __init__(self, timeout_s: float, name: str = "train", clock=None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.name = name
        self._clock = as_now_fn(clock)
        self._last = self._clock()
        self._stalled = False

    def beat(self) -> None:
        """Record one unit of progress (resets the deadline)."""
        self._last = self._clock()

    def reset(self) -> None:
        """Clear a latched stall verdict and restart the deadline (a
        replica coming back from its restart)."""
        self._stalled = False
        self._last = self._clock()

    @property
    def stalled(self) -> bool:
        return self._stalled

    @property
    def age_s(self) -> float:
        """Seconds since the last heartbeat."""
        return self._clock() - self._last

    def check(self) -> None:
        """Raise :class:`StallError` if the deadline passed."""
        if self._stalled or self.age_s > self.timeout_s:
            self._stalled = True
            raise StallError(
                f"{self.name}: no progress for {self.age_s:.1f}s "
                f"(deadline {self.timeout_s:.1f}s)")
