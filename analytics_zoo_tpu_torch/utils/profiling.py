"""Traces and step timing (counterpart of ``utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` capture of the CPU and, on a card,
  CUDA activity, written as a Chrome trace into ``log_dir`` (open it in
  ``chrome://tracing`` or Perfetto);
- :func:`named_scope`: ``torch.profiler.record_function``, a labelled
  region in that trace;
- :class:`StepTimer`: host wall time a step and records, with the
  reference Validator's "[N] in T seconds. Throughput is …" line, and
  the ``<name>/step_s``, ``<name>/steps`` and ``<name>/records``
  metrics;
- :func:`memory_summary`: device memory in MB under the reference's
  keys (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``,
  ``bytes_reserved``) from ``torch.cuda.memory_stats``, and the host's
  on the CPU.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

logger = logging.getLogger("analytics_zoo_tpu_torch")

named_scope = record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; its Chrome trace lands in
    ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step host wall times and record counts, with the reference
    Validator's throughput line (``Validator.scala:82-86``).

    ``registry`` (optional, a :class:`~analytics_zoo_tpu_torch.obs.
    registry.MetricRegistry`): each step also lands there as a
    ``<name>/step_s`` histogram and ``<name>/steps`` and
    ``<name>/records`` counters.  On a card the interval is the host's
    (the step's launches are asynchronous) unless the step itself waits
    for the device."""

    def __init__(self, name: str = "train", registry=None):
        self.name = name
        self.registry = registry
        self.times: List[float] = []
        self.records = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            raise RuntimeError(f"StepTimer[{self.name}]: __exit__ without "
                               "a matching __enter__")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.times.append(dt)
        if self.registry is not None:
            # az-allow: registered-metric-names — timer-name-prefixed; the Optimizer's canonical train/dispatch/* family is declared in obs/names.py
            self.registry.histogram(f"{self.name}/step_s").observe(dt)
            # az-allow: registered-metric-names — timer-name-prefixed steps counter, same train/dispatch/* family as the step histogram
            self.registry.counter(f"{self.name}/steps").inc()

    def step(self, n_records: int = 0):
        """Use as ``with timer.step(n):``, counting records too."""
        self.records += n_records
        if self.registry is not None and n_records:
            # az-allow: registered-metric-names — timer-name-prefixed records counter, same train/dispatch/* family as the step histogram
            self.registry.counter(f"{self.name}/records").inc(n_records)
        return self

    def summary(self) -> Dict[str, float]:
        total = sum(self.times)
        n = len(self.times)
        return {
            "steps": n,
            "total_s": total,
            "mean_ms": (total / n * 1e3) if n else 0.0,
            "records": self.records,
            "records_per_sec": self.records / total if total else 0.0,
        }

    def log(self) -> None:
        s = self.summary()
        logger.info("[%s] %d in %.2f seconds. Throughput is %.2f records/sec "
                    "(%.1f ms/step)", self.name, s["records"], s["total_s"],
                    s["records_per_sec"], s["mean_ms"])


#: ``torch.cuda.memory_stats`` keys → the reference's keys
_CUDA_KEYS = {"allocated_bytes.all.current": "bytes_in_use",
              "allocated_bytes.all.peak": "peak_bytes_in_use",
              "reserved_bytes.all.current": "bytes_reserved"}


def _host_memory() -> Dict[str, float]:
    """This process's resident and peak resident bytes, and the host's
    total, in MB (``/proc`` on Linux; empty where unreadable)."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in ("VmRSS", "VmHWM"):
                    kb = float(rest.split()[0])
                    name = ("bytes_in_use" if key == "VmRSS"
                            else "peak_bytes_in_use")
                    out[name] = round(kb * 1024 / 1e6, 2)
        out["bytes_limit"] = round(os.sysconf("SC_PAGE_SIZE")
                                   * os.sysconf("SC_PHYS_PAGES") / 1e6, 2)
    except (OSError, ValueError):
        pass
    return out


def memory_summary() -> Dict[str, Dict[str, float]]:
    """Memory in MB by device: each CUDA device's ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_reserved`` and ``bytes_limit``; with
    no card, ``{"cpu": ...}`` for this process on the host."""
    if not torch.cuda.is_available():
        return {"cpu": _host_memory()}
    out: Dict[str, Dict[str, float]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        d = {name: round(stats.get(key, 0) / 1e6, 2)
             for key, name in _CUDA_KEYS.items()}
        d["bytes_limit"] = round(
            torch.cuda.get_device_properties(i).total_memory / 1e6, 2)
        out[f"cuda:{i}"] = d
    return out


def log_memory(prefix: str = "memory") -> None:
    for dev, stats in memory_summary().items():
        if stats:
            logger.info("%s %s: %s", prefix, dev, stats)
