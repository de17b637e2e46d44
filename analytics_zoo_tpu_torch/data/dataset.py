"""DataSet: epoch-iterable sources, transform chains and batching
(counterpart of ``data/dataset.py``), host numpy code.

Only what the DS2 training slice needs: ``DataSet.from_arrays``,
``transform``, ``batch`` and the collate helpers.  A shuffled source draws each epoch's order from
``np.random.RandomState(seed + epoch)`` as the reference does, so the
batches equal the JAX package's.  Record files, the multiprocess loader
and the windowed shuffle are not ported (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.data.transformer import Transformer


class DataSet:
    def __init__(self, source_fn: Callable[[], Iterator[Any]],
                 size: Optional[int] = None):
        self._source_fn = source_fn
        self._size = size
        self._stages: List[Transformer] = []

    @staticmethod
    def from_arrays(shuffle: bool = False, seed: int = 0,
                    **arrays) -> "DataSet":
        """Columnar in-memory source: yields per-sample dicts."""
        n = len(next(iter(arrays.values())))
        state = {"epoch": 0}

        def source():
            idx = np.arange(n)
            if shuffle:
                np.random.RandomState(seed + state["epoch"]).shuffle(idx)
                state["epoch"] += 1
            for i in idx:
                yield {k: v[i] for k, v in arrays.items()}

        return DataSet(source, size=n)

    def transform(self, t: Transformer) -> "DataSet":
        out = DataSet(self._source_fn, self._size)
        out._stages = self._stages + [t]
        return out

    def batch(self, batch_size: int, collate_fn: Optional[Callable] = None,
              drop_remainder: bool = True) -> "DataSet":
        return self.transform(Batcher(batch_size, collate_fn,
                                      drop_remainder))

    def __iter__(self) -> Iterator[Any]:
        it = self._source_fn()
        for stage in self._stages:
            it = stage.apply_iter(iter(it))
        return it

    def __len__(self) -> int:
        if self._size is None:
            raise TypeError("DataSet size unknown (streaming source)")
        return self._size


def default_collate(samples: List[Any]) -> Any:
    """Stack a list of samples: dicts stack per key, arrays on dim 0."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(col))
                           for col in zip(*samples))
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
