"""Graceful preemption: SIGTERM → checkpoint → retryable error
(counterpart of ``resilience/preempt.py``).

A managed fleet preempts with a SIGTERM and a short grace window.
:class:`PreemptionHandler` turns the signal into a *request* flag; the
training loop reads it at each step boundary, takes a forced checkpoint
and raises :class:`~analytics_zoo_tpu_torch.resilience.errors.Preempted`
(retryable, so a supervisor, or the job's next incarnation, resumes
where the signal landed).

A second signal while the first is being honoured escalates: the
handlers are restored and ``KeyboardInterrupt`` is raised at once.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Dict, Sequence

logger = logging.getLogger("analytics_zoo_tpu_torch")


class PreemptionHandler:
    """Installable SIGTERM trap with a step-boundary request flag.

    Signal handlers can only be installed from the main thread; from any
    other thread :meth:`install` is a no-op with a warning (the flag can
    still be set through :meth:`request`).  Only SIGTERM is trapped by
    default: ``Preempted`` is retryable, so trapping SIGINT would turn a
    Ctrl-C under ``run_resilient`` into a restart."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._requested = False
        self._prev: Dict[int, object] = {}
        self._installed = False
        # the Optimizer wires its StallWatchdog here, so that the
        # watchdog's simulated SIGINT of a stalled loop hard-raises
        # instead of reading as a preemption request
        self.stall_watchdog = None

    @property
    def requested(self) -> bool:
        return self._requested

    def request(self) -> None:
        """Programmatic preemption request (no signal needed)."""
        self._requested = True

    def clear(self) -> None:
        self._requested = False

    def install(self) -> "PreemptionHandler":
        self._requested = False
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionHandler: not on the main thread; "
                           "signal trap NOT installed (request() still "
                           "works)")
            return self
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):  # pragma: no cover
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handle(self, signum, frame) -> None:
        wd = self.stall_watchdog
        if wd is not None and getattr(wd, "stalled", False):
            logger.error("interrupt during a detected stall: hard stop "
                         "(the loop cannot reach a graceful boundary)")
            self.uninstall()
            raise KeyboardInterrupt("stall interrupt")
        if self._requested:
            logger.warning("second signal %s: hard stop", signum)
            self.uninstall()
            raise KeyboardInterrupt(f"second signal {signum}")
        self._requested = True
        logger.warning("received signal %s: graceful checkpoint requested "
                       "at the next step boundary", signum)
