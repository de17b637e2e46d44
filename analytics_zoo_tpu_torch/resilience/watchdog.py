"""Host-side stall detection (counterpart of ``resilience/watchdog.py``).

A hung device call or a dead input pipeline does not raise: it blocks
the host loop.  :class:`StallWatchdog` turns "no progress past a
deadline" into an exception.  It has two modes over one heartbeat:

- **push** (the training loop): :meth:`StallWatchdog.start` runs a
  daemon monitor thread that checks the heartbeat's age every
  ``poll_s`` and, past ``timeout_s``, marks the watchdog stalled and
  interrupts the main thread (``_thread.interrupt_main``, a simulated
  KeyboardInterrupt that lands even while the main thread waits); the
  ``Optimizer`` turns that interrupt into :class:`StallError` when
  ``stalled`` is set, so a real Ctrl-C is never misread;
- **pull** (the serving runtime): ``beat`` when a replica's forward
  starts, :meth:`StallWatchdog.check` when it returns, on the runtime's
  injected clock, so a forward whose duration passed ``timeout_s`` is a
  wedge even though it returned.

The deadline must cover the slowest legitimate unit of progress (the
first step's kernel builds and cuDNN autotuning, a full snapshot write).
"""

from __future__ import annotations

import _thread
import logging
import threading
from typing import Callable, Optional

from analytics_zoo_tpu_torch.resilience.errors import StallError
from analytics_zoo_tpu_torch.utils.clock import as_now_fn

logger = logging.getLogger("analytics_zoo_tpu_torch")


class StallWatchdog:
    """Heartbeat deadline over an injected clock (a ``Clock`` or a bare
    ``now()`` callable; ``None`` is monotonic time).  ``on_stall``
    replaces the push mode's main-thread interrupt."""

    def __init__(self, timeout_s: float, poll_s: Optional[float] = None,
                 name: str = "train",
                 on_stall: Optional[Callable[["StallWatchdog"], None]] = None,
                 clock=None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.poll_s = max(0.01, poll_s if poll_s is not None
                          else min(timeout_s / 4.0, 1.0))
        self.name = name
        self.on_stall = on_stall
        self._clock = as_now_fn(clock)
        self._last = self._clock()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- push mode -----------------------------------------------------------
    def start(self) -> "StallWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._stalled = False
        self._last = self._clock()
        self._thread = threading.Thread(
            target=self._monitor, name=f"stall-watchdog-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            age = self._clock() - self._last
            if age > self.timeout_s:
                self._stalled = True
                logger.error("StallWatchdog[%s]: no progress for %.1fs "
                             "(deadline %.1fs) — interrupting", self.name,
                             age, self.timeout_s)
                if self.on_stall is not None:
                    self.on_stall(self)
                else:
                    # with a PreemptionHandler installed, its handler
                    # receives this and hard-raises on ``stalled``
                    _thread.interrupt_main()
                return

    # -- heartbeat -----------------------------------------------------------
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
        """Pull mode: raise :class:`StallError` if the deadline passed."""
        if self._stalled or self.age_s > self.timeout_s:
            self._stalled = True
            raise StallError(
                f"{self.name}: no progress for {self.age_s:.1f}s "
                f"(deadline {self.timeout_s:.1f}s)")
