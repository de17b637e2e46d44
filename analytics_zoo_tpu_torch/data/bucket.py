"""Length-bucketed batching (counterpart of ``data/bucket.py``), host
numpy code: samples land in the smallest padded-length bucket that fits
them and a batch is emitted each time a bucket fills, so batches take a
few fixed time lengths instead of one max-padded one.  Each batch keeps
its rows' true lengths (``length_key``) for the model's mask and the
``padding_efficiency`` metric."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.dataset import default_collate
from analytics_zoo_tpu_torch.data.transformer import Transformer


class BucketBatcher(Transformer):
    """Batch a sample stream into fixed padded-length buckets.
    ``bucket_edges``: the padded lengths; a sample longer than the last
    edge is truncated to it (counted in ``truncated``).
    ``drop_remainder=False`` flushes partial buckets at the end of the
    stream in ascending-edge order."""

    def __init__(self, batch_size: int, bucket_edges: Sequence[int],
                 length_key: str = "n_frames", pad_key: str = "input",
                 drop_remainder: bool = True,
                 collate_fn: Optional[Callable] = None):
        edges = sorted(int(e) for e in bucket_edges)
        if not edges or any(e <= 0 for e in edges):
            raise ValueError(f"bucket_edges must be positive, got "
                             f"{bucket_edges!r}")
        if len(set(edges)) != len(edges):
            raise ValueError(f"duplicate bucket edges in {bucket_edges!r}")
        self.batch_size = int(batch_size)
        self.bucket_edges = edges
        self.length_key = length_key
        self.pad_key = pad_key
        self.drop_remainder = drop_remainder
        self.collate_fn = collate_fn or default_collate
        self.truncated = 0

    def _make_batch(self, edge: int, samples: List[Dict[str, Any]]):
        rows, lengths = [], []
        for s in samples:
            arr = np.asarray(s[self.pad_key])
            n = min(int(s[self.length_key]), edge, arr.shape[0])
            padded = np.zeros((edge,) + arr.shape[1:], arr.dtype)
            padded[:n] = arr[:n]
            out = dict(s)
            out[self.pad_key] = padded
            out[self.length_key] = np.int32(n)
            rows.append(out)
            lengths.append(n)
        batch = self.collate_fn(rows)
        if isinstance(batch, dict):
            batch[self.length_key] = np.asarray(lengths, np.int32)
        return batch

    def apply_iter(self, it: Iterator[Any]) -> Iterator[Any]:
        self.truncated = 0
        buckets: Dict[int, List[Any]] = {e: [] for e in self.bucket_edges}
        for sample in it:
            n = int(sample[self.length_key])
            edge = edge_for(n, self.bucket_edges)
            if n > edge:
                self.truncated += 1
            buckets[edge].append(sample)
            if len(buckets[edge]) == self.batch_size:
                yield self._make_batch(edge, buckets[edge])
                buckets[edge] = []
        if not self.drop_remainder:
            for edge in self.bucket_edges:
                if buckets[edge]:
                    yield self._make_batch(edge, buckets[edge])


def edge_for(n: int, edges: Sequence[int]) -> int:
    """Smallest bucket edge that fits length ``n`` (the last edge when
    none does — the caller truncates)."""
    for e in edges:
        if n <= e:
            return e
    return edges[-1]


def padding_efficiency(n_frames, padded_len: int) -> float:
    """Valid frames / padded frames for rows padded to ``padded_len``."""
    n = np.asarray(n_frames)
    return float(n.sum()) / float(max(n.shape[0] * padded_len, 1))
