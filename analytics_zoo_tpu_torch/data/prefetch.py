"""Device prefetch: the next batches' upload overlaps the current step
(counterpart of ``data/prefetch.py``), and the bounded-window overlap of
host prep, device execution and readback.

:func:`device_prefetch` takes the reference's mesh argument as a device
(a rank's card: ``data.parallel.make_input_pipeline`` cuts each rank's
rows before the upload).  A worker
thread iterates the host batches, pins each one, copies it with
``non_blocking=True`` on a side CUDA stream and records an event; the
consumer makes its current stream wait on that event and calls
``record_stream`` on every tensor before handing the batch on, so a step
never reads a half-copied batch and the allocator never reuses its
memory while the step still reads it.  Pinning needs a card: on the CPU
``device_prefetch`` raises and the caller iterates the host batches.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from typing import Any, Iterable, Iterator, List

import numpy as np

from analytics_zoo_tpu_torch.resilience.errors import PrefetchWorkerDied
from analytics_zoo_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("analytics_zoo_tpu_torch")


def _drain(q: "queue.Queue", stop: object, err: list, worker,
           poll_s: float = 0.2) -> Iterator[Any]:
    """Consumer side of the prefetch queue.  Polls instead of a bare
    ``q.get()`` (which would block forever if the worker died without
    its stop sentinel) and, when the queue is empty and the worker dead,
    raises the worker's exception, else :class:`PrefetchWorkerDied`."""
    while True:
        try:
            item = q.get(timeout=poll_s)
        except queue.Empty:
            if worker.is_alive():
                continue
            # the worker may have delivered its tail (and the sentinel)
            # between the timeout and the liveness check: drain first
            try:
                item = q.get_nowait()
            except queue.Empty:
                if err:
                    raise err[0]
                raise PrefetchWorkerDied(
                    "prefetch worker thread died without delivering its "
                    "stop sentinel (no exception recorded) — input "
                    "pipeline is gone; restart the attempt")
        if item is stop:
            if err:
                raise err[0]
            return
        yield item


def _to_pinned_device(tree, device, tensors: List):
    """Every ndarray leaf of ``tree`` pinned and copied to ``device`` on
    the current stream, without waiting; each device tensor is appended
    to ``tensors``."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_pinned_device(v, device, tensors)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_pinned_device(v, device, tensors)
                          for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)) or isinstance(
            tree, torch.Tensor):
        if isinstance(tree, torch.Tensor):
            host = tree
        else:
            arr = np.asarray(tree)
            if not (arr.flags.c_contiguous and arr.flags.writeable):
                arr = arr.copy()
            host = torch.from_numpy(arr)
        out = host.pin_memory().to(device, non_blocking=True)
        tensors.append(out)
        return out
    return tree


def device_prefetch(batches: Iterable[Any], device=None, size: int = 2,
                    close_source: bool = False) -> Iterator[Any]:
    """Yield ``batches`` as tensors on ``device`` (the GPU unless given),
    the worker staying up to ``size`` batches ahead.

    Early consumer exit (the train loop breaking on ``end_when``) is
    handled: closing the generator tells the worker to stop, so no thread
    is left holding device memory.  ``close_source=True`` also closes
    ``batches`` when the stream ends or is cancelled, FROM THE WORKER
    THREAD, the only thread that ever runs the source (a multiprocess
    ``ParallelLoader`` epoch must not outlive the stream); leave it False
    when the caller reuses the source."""
    import torch

    if size < 1:
        # a non-positive maxsize would make the queue unbounded
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(
            "device_prefetch pins host memory and copies on a side CUDA "
            "stream, which needs a CUDA device; on the CPU iterate the "
            "batches directly (prefetch=0)")
    copy_stream = torch.cuda.Stream(device=dev)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = object()
    cancelled = threading.Event()
    err: list = []

    def worker():
        try:
            for b in batches:
                tensors: List = []
                with torch.cuda.stream(copy_stream):
                    out = _to_pinned_device(b, dev, tensors)
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                item = (out, tensors, ready)
                while not cancelled.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            if close_source and hasattr(batches, "close"):
                try:
                    batches.close()
                except Exception:  # noqa: BLE001 - cleanup best-effort
                    pass
            # block until the stop sentinel fits: never pop queued real
            # batches to make room (a slow consumer keeps the queue full
            # at the end of the stream); a cancelled consumer needs none
            while not cancelled.is_set():
                try:
                    q.put(stop, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for out, tensors, ready in _drain(q, stop, err, t):
            current = torch.cuda.current_stream(dev)
            current.wait_event(ready)
            for x in tensors:
                x.record_stream(current)
            yield out
    finally:
        cancelled.set()
        if close_source:
            # the worker's cleanup (closing a loader epoch: reaping its
            # processes, advancing the source state) must complete before
            # the consumer restarts an epoch; bounded, since the worker
            # sees ``cancelled`` within one batch
            t.join(timeout=5.0)
            if t.is_alive():
                logger.warning(
                    "prefetch worker still closing its source after the "
                    "5s grace — an immediately restarted epoch may fork "
                    "workers from a stale source state")


class PrefetchDataSet:
    """Wrap a DataSet so every epoch iterates device batches, ``size``
    ahead (2 = double buffering).  ``num_workers > 0`` fans the host
    chain out to a ``data.parallel.ParallelLoader`` first; an early
    consumer exit closes the host iterator too, so worker processes never
    outlive the epoch."""

    def __init__(self, dataset, device=None, size: int = 2,
                 num_workers: int = 0, base_seed: int = 0, **loader_kw):
        if num_workers > 0:
            from analytics_zoo_tpu_torch.data.parallel import ParallelLoader
            dataset = ParallelLoader(dataset, num_workers,
                                     base_seed=base_seed, **loader_kw)
        self.dataset = dataset
        self.device = resolve_device(device)
        self.size = size

    def __iter__(self):
        return device_prefetch(iter(self.dataset), self.device, self.size,
                               close_source=True)

    def __len__(self):
        return len(self.dataset)


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
