"""The step decomposition probe (counterpart of ``obs/probe.py``).

A step's host wall time splits into

- **input wait**: blocking on the data pipeline (``next(iterator)``);
- **dispatch**: the step call until it returns (PyTorch launches CUDA
  work asynchronously, so this is the host's enqueue);
- **device**: from that return until ``torch.cuda.synchronize`` on the
  step's device returns (the card's work the host then waits out).

``host_bound_fraction = (input_wait + dispatch) / total``.  The fence
is part of the measurement: the probe says where a step's wall time
goes, not what an overlapped pipeline reaches; probe a window of steps
for that.  On the CPU the fence does nothing (the step has finished
when it returns) and the device share is ~0.

Usage::

    probe = StepProbe(registry=reg)          # registry optional
    for _ in range(steps):
        with probe.input_wait():
            batch = next(it)
        out = probe.step(step_fn, state, batch)   # fenced
    probe.summary()
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from analytics_zoo_tpu_torch.obs.registry import MetricRegistry


def _devices(out: Any, found: set) -> set:
    """The CUDA devices of every tensor in a step's output."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _devices(getattr(out, f.name), found)
    return found


def fence(out: Any) -> None:
    """Wait for the card's work behind ``out``: ``torch.cuda.synchronize``
    on every CUDA device its tensors live on (the reference's
    ``jax.block_until_ready``).  Nothing on the CPU."""
    for d in _devices(out, set()):
        torch.cuda.synchronize(d)


class StepProbe:
    """Accumulates the three-way split over a run of steps.

    ``registry`` (optional): each observation also goes to the
    ``<prefix>/input_wait_s``, ``<prefix>/dispatch_s`` and
    ``<prefix>/device_s`` histograms.  The probe reads
    ``time.perf_counter``: it measures the real host."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 prefix: str = "probe"):
        self.registry = registry
        self.prefix = prefix
        self.steps = 0
        self.input_wait_s = 0.0
        self.dispatch_s = 0.0
        self.device_s = 0.0

    def _observe(self, metric: str, v: float) -> None:
        if self.registry is not None:
            # az-allow: registered-metric-names — prefix-parameterized probe; the canonical probe/* family is declared in obs/names.py
            self.registry.histogram(f"{self.prefix}/{metric}").observe(v)

    @contextlib.contextmanager
    def input_wait(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.input_wait_s += dt
            self._observe("input_wait_s", dt)

    def step(self, step_fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run one step: time the call, then fence its result and time
        the wait.  Returns the step's output."""
        t0 = time.perf_counter()
        out = step_fn(*args, **kwargs)
        t1 = time.perf_counter()
        fence(out)
        t2 = time.perf_counter()
        self.steps += 1
        self.dispatch_s += t1 - t0
        self.device_s += t2 - t1
        self._observe("dispatch_s", t1 - t0)
        self._observe("device_s", t2 - t1)
        return out

    def summary(self) -> Dict[str, Any]:
        total = self.input_wait_s + self.dispatch_s + self.device_s
        host = self.input_wait_s + self.dispatch_s
        return {
            "steps": self.steps,
            "input_wait_s": round(self.input_wait_s, 6),
            "dispatch_s": round(self.dispatch_s, 6),
            "device_s": round(self.device_s, 6),
            "total_s": round(total, 6),
            "host_bound_fraction": round(host / total, 4) if total else None,
            "input_wait_fraction": (round(self.input_wait_s / total, 4)
                                    if total else None),
        }
