"""DataSet: epoch-iterable sources, transform chains and batching
(counterpart of ``data/dataset.py``), host numpy code.

A ``DataSet`` wraps a re-invocable source; transformers attach with
``.transform`` (or ``>>``) and ``iter(ds)`` yields one epoch.  Shuffled
sources draw each epoch's order as the reference does (``from_list`` and
``from_record_files`` from ``random.Random(seed + epoch)``, ``from_arrays``
from ``np.random.RandomState(seed + epoch)``), so the streams equal the
JAX package's.  Batches come out as numpy dicts for ``device_prefetch``
or the train step.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data import records as records_lib
from analytics_zoo_tpu_torch.data.transformer import Transformer


class DataSet:
    #: False when the SOURCE's record order is not reproducible across
    #: iterations (e.g. the threaded native reader) — the multiprocess
    #: loader requires replayable order and refuses such sources
    _order_deterministic: bool = True

    def __init__(self, source_fn: Callable[[], Iterator[Any]],
                 size: Optional[int] = None):
        self._source_fn = source_fn
        self._size = size
        self._stages: List[Transformer] = []

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_list(items: Sequence[Any], shuffle: bool = False,
                  seed: int = 0) -> "DataSet":
        items = list(items)
        state = {"epoch": 0}

        def source():
            out = items
            if shuffle:
                out = list(items)
                random.Random(seed + state["epoch"]).shuffle(out)
                state["epoch"] += 1
            return iter(out)

        return DataSet(source, size=len(items))

    @staticmethod
    def from_record_files(pattern: str, decode_fn: Optional[Callable] = None,
                          shard_by_host: bool = True,
                          shuffle_files: bool = False, seed: int = 0,
                          native_threads: int = 0) -> "DataSet":
        """Sharded record-file source.  ``native_threads > 0`` reads
        through the C++ threaded reader (``data.native``; a build that
        fails raises) — record order across shards is then
        nondeterministic, and the multiprocess loader refuses the
        dataset."""
        if shard_by_host:
            paths = records_lib.shard_paths(pattern)
        else:
            paths = records_lib.shard_paths(pattern, 0, 1)
        state = {"epoch": 0}

        def source():
            order = list(paths)
            if shuffle_files:
                random.Random(seed + state["epoch"]).shuffle(order)
                state["epoch"] += 1
            if native_threads > 0:
                from analytics_zoo_tpu_torch.data import native
                with native.NativeRecordReader(
                        order, n_threads=native_threads) as reader:
                    for payload in reader:
                        yield decode_fn(payload) if decode_fn else payload
                return
            for p in order:
                for payload in records_lib.read_records(p):
                    yield decode_fn(payload) if decode_fn else payload

        ds = DataSet(source)
        if native_threads > 0:
            ds._order_deterministic = False
        return ds

    @staticmethod
    def from_arrays(shuffle: bool = False, seed: int = 0, **arrays) -> "DataSet":
        """Columnar in-memory source: yields per-sample dicts."""
        n = len(next(iter(arrays.values())))
        idx_state = {"epoch": 0}

        def source():
            idx = np.arange(n)
            if shuffle:
                np.random.RandomState(seed + idx_state["epoch"]).shuffle(idx)
                idx_state["epoch"] += 1
            for i in idx:
                yield {k: v[i] for k, v in arrays.items()}

        return DataSet(source, size=n)

    # -- combinators -------------------------------------------------------
    def transform(self, t: Transformer) -> "DataSet":
        out = DataSet(self._source_fn, self._size)
        out._stages = self._stages + [t]
        out._order_deterministic = self._order_deterministic
        return out

    __rshift__ = transform

    def batch(self, batch_size: int, collate_fn: Optional[Callable] = None,
              drop_remainder: bool = True, num_workers: int = 0,
              base_seed: int = 0):
        """Batch the stream.  ``num_workers > 0`` returns the batched
        dataset wrapped in a :class:`~analytics_zoo_tpu_torch.data.parallel.
        ParallelLoader` — per-sample transforms fan out to that many
        worker processes (shared-memory rings, order-preserving,
        deterministically seeded); this is a terminal combinator, so
        attach further transforms before ``batch``."""
        out = self.transform(Batcher(batch_size, collate_fn, drop_remainder))
        if num_workers > 0:
            return out.parallel(num_workers, base_seed=base_seed)
        return out

    def bucket_batch(self, batch_size: int, bucket_edges: Sequence[int],
                     length_key: str = "n_frames", pad_key: str = "input",
                     drop_remainder: bool = True,
                     num_workers: int = 0, base_seed: int = 0):
        """Length-bucketed batching (:class:`~analytics_zoo_tpu_torch.data.
        bucket.BucketBatcher`): samples land in the smallest fitting
        padded-length bucket and a batch is emitted each time a bucket
        fills — a small pinned set of shapes instead of one max-padded
        shape.  Terminal like :meth:`batch`; ``num_workers > 0`` wraps
        the result in a deterministic multiprocess ``ParallelLoader``
        (the batcher itself always runs serially in the parent)."""
        from analytics_zoo_tpu_torch.data.bucket import BucketBatcher
        out = self.transform(BucketBatcher(
            batch_size, bucket_edges, length_key=length_key,
            pad_key=pad_key, drop_remainder=drop_remainder))
        if num_workers > 0:
            return out.parallel(num_workers, base_seed=base_seed)
        return out

    def parallel(self, num_workers: int, base_seed: int = 0, **kw):
        """Wrap in a multiprocess :class:`~analytics_zoo_tpu_torch.data.
        parallel.ParallelLoader` (``num_workers=0`` = the deterministic
        in-process serial reference path)."""
        from analytics_zoo_tpu_torch.data.parallel import ParallelLoader
        return ParallelLoader(self, num_workers, base_seed=base_seed, **kw)

    def shuffle(self, buffer_size: int = 1024, seed: Optional[int] = None
                ) -> "DataSet":
        """Record-level windowed shuffle (``transformer.ShuffleBuffer``)."""
        from analytics_zoo_tpu_torch.data.transformer import ShuffleBuffer
        rng = random.Random(seed) if seed is not None else None
        return self.transform(ShuffleBuffer(buffer_size, rng=rng))

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        it = self._source_fn()
        for stage in self._stages:
            it = stage.apply_iter(iter(it))
        return it

    def __len__(self) -> int:
        if self._size is None:
            raise TypeError("DataSet size unknown (streaming source)")
        return self._size


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------


def default_collate(samples: List[Any]) -> Any:
    """Stack a list of samples: dicts stack per key, arrays stack on dim 0."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(col)) for col in zip(*samples))
    if np.isscalar(first) or isinstance(first, np.ndarray):
        return np.stack([np.asarray(s) for s in samples], axis=0)
    return samples


class Batcher(Transformer):
    def __init__(self, batch_size: int, collate_fn: Optional[Callable] = None,
                 drop_remainder: bool = True):
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.drop_remainder = drop_remainder

    def apply_iter(self, it: Iterator[Any]) -> Iterator[Any]:
        buf: List[Any] = []
        for sample in it:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self.collate_fn(buf)


def pad_ragged(rows: List[np.ndarray], max_len: int,
               pad_value: float = 0.0):
    """Pad a list of (n_i, D) arrays to (B, max_len, D) plus a (B,
    max_len) mask."""
    D = rows[0].shape[1] if rows and rows[0].ndim == 2 else 1
    B = len(rows)
    out = np.full((B, max_len, D), pad_value, np.float32)
    mask = np.zeros((B, max_len), np.float32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.float32).reshape(-1, D)
        n = min(r.shape[0], max_len)
        out[i, :n] = r[:n]
        mask[i, :n] = 1.0
    return out, mask
