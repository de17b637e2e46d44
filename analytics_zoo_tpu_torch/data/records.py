"""Sharded binary record files (counterpart of ``data/records.py``),
host code: the same ``.azr`` framing and ``SSDByteRecord`` payload, so
each package reads the other's files byte for byte.

File layout:  magic ``AZR1`` | then per record: u32 length | payload.
``SSDByteRecord`` payload:  u32 path_len | path utf-8 | u32 img_len |
jpeg/png bytes | u32 n_gt | n_gt × 6 float32 (label, difficult, x1,y1,x2,y2).
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import logging
import os
import struct
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch")

MAGIC = b"AZR1"


class ShardReadError(IOError):
    """A shard's transient I/O errors outlasted the retry budget."""


@dataclasses.dataclass
class ReadStats:
    """Skip-and-count bookkeeping for resilient shard reads (the
    reference's corrupt-image tolerance, surfaced as numbers instead of
    silence)."""

    records: int = 0           # records successfully yielded
    retries: int = 0           # transient I/O errors retried
    skipped_records: int = 0   # undecodable records dropped
    skipped_shards: int = 0    # whole shards dropped (retry exhaustion /
    #                            truncation with skip_errors=True)

    def publish(self, registry, prefix: str = "data/read") -> None:
        """Mirroring the counters into a metric registry needs the
        observability layer, not ported yet."""
        raise NotImplementedError(
            "ReadStats.publish: the metric registry is not ported yet "
            "(ROADMAP.md Queue 1 item 13)")


# ---------------------------------------------------------------------------
# Raw container
# ---------------------------------------------------------------------------


class RecordWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self.count = 0

    def write(self, payload: bytes) -> None:
        self._f.write(struct.pack("<I", len(payload)))
        self._f.write(payload)
        self.count += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, retries: int = 0, backoff_s: float = 0.05,
                 stats: Optional[ReadStats] = None,
                 opener: Callable = open) -> Iterator[bytes]:
    """Iterate raw payloads of one shard.

    ``retries`` bounds recovery from *transient* I/O errors (flaky NFS/
    object-store FUSE mounts): the shard is reopened, seeked back to the
    last good record boundary, and reading continues, with exponential
    backoff (``backoff_s``, doubling per retry).  When the budget is
    exhausted, :class:`ShardReadError` is raised with the last cause.
    ``stats`` (a :class:`ReadStats`) counts yielded records and retries.
    ``opener`` is the file-open callable (fault-injection seam for tests
    and the chaos drill)."""
    state = {"budget": retries, "delay": backoff_s}

    def _transient(e: OSError, what: str) -> None:
        """Consume one retry (sleep + count) or raise ShardReadError."""
        if state["budget"] <= 0:
            raise ShardReadError(
                f"{path}: {what} failed after {retries} retries: {e}") from e
        state["budget"] -= 1
        if stats is not None:
            stats.retries += 1
        logger.warning("shard %s: transient error on %s (%s); retrying in "
                       "%.2fs (%d retries left)", path, what, e,
                       state["delay"], state["budget"])
        time.sleep(state["delay"])
        state["delay"] *= 2

    def _open_at(pos: int):
        f = opener(path, "rb")
        try:
            if f.read(4) != MAGIC:
                raise ValueError(f"{path}: not an AZR1 record file")
            if pos > 4:
                f.seek(pos)
            return f
        except Exception:
            f.close()
            raise

    offset = 4   # next unread record boundary
    f = None
    try:
        while True:
            if f is None:
                try:
                    f = _open_at(offset)
                except OSError as e:
                    _transient(e, "open")
                    continue
            try:
                head = f.read(4)
                if len(head) < 4:
                    return
                (n,) = struct.unpack("<I", head)
                payload = f.read(n)
            except OSError as e:
                f.close()
                f = None   # reopen + reseek at the last record boundary
                _transient(e, f"read at offset {offset}")
                continue
            if len(payload) < n:
                raise ValueError(f"{path}: truncated record")
            offset += 4 + n
            if stats is not None:
                stats.records += 1
            yield payload
    finally:
        if f is not None:
            f.close()


def shard_paths(pattern: str, shard_index: Optional[int] = None,
                num_shards: Optional[int] = None) -> List[str]:
    """Deterministic per-process file sharding: process k of N takes
    files k, k+N, …  With no ``shard_index`` the process's rank and world
    size in an initialised ``torch.distributed`` group, else all files."""
    paths = sorted(globlib.glob(pattern)) if any(c in pattern for c in "*?[") \
        else sorted(
            os.path.join(pattern, p) for p in os.listdir(pattern)
        ) if os.path.isdir(pattern) else [pattern]
    if shard_index is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            shard_index, num_shards = dist.get_rank(), dist.get_world_size()
        else:
            shard_index, num_shards = 0, 1
    elif num_shards is None:
        raise ValueError("num_shards required when shard_index is given")
    return paths[shard_index::max(num_shards, 1)]


# ---------------------------------------------------------------------------
# SSDByteRecord
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SSDByteRecord:
    """JPEG bytes + ground-truth matrix.  ``gt`` rows are (label,
    difficult, x1, y1, x2, y2) in pixel coords."""

    data: bytes
    path: str = ""
    gt: Optional[np.ndarray] = None  # (N, 6) float32

    def encode(self) -> bytes:
        path_b = self.path.encode("utf-8")
        gt = (np.zeros((0, 6), np.float32) if self.gt is None
              else np.asarray(self.gt, np.float32).reshape(-1, 6))
        return b"".join([
            struct.pack("<I", len(path_b)), path_b,
            struct.pack("<I", len(self.data)), self.data,
            struct.pack("<I", gt.shape[0]), gt.tobytes(),
        ])

    @staticmethod
    def decode(payload: bytes) -> "SSDByteRecord":
        off = 0
        (plen,) = struct.unpack_from("<I", payload, off); off += 4
        path = payload[off:off + plen].decode("utf-8"); off += plen
        (dlen,) = struct.unpack_from("<I", payload, off); off += 4
        data = payload[off:off + dlen]; off += dlen
        (n_gt,) = struct.unpack_from("<I", payload, off); off += 4
        gt = np.frombuffer(payload, np.float32, n_gt * 6, off).reshape(n_gt, 6).copy()
        return SSDByteRecord(data=data, path=path, gt=gt)


def write_ssd_records(records: Sequence[SSDByteRecord], prefix: str,
                      num_shards: int = 1) -> List[str]:
    """Shard records round-robin into ``<prefix>-00000-of-0000N.azr``."""
    paths = [f"{prefix}-{i:05d}-of-{num_shards:05d}.azr" for i in range(num_shards)]
    writers = [RecordWriter(p) for p in paths]
    for i, rec in enumerate(records):
        writers[i % num_shards].write(rec.encode())
    for w in writers:
        w.close()
    return paths


def read_ssd_records(paths: Sequence[str], skip_errors: bool = False,
                     retries: int = 0, backoff_s: float = 0.05,
                     stats: Optional[ReadStats] = None,
                     opener: Callable = open) -> Iterator[SSDByteRecord]:
    """Decode SSD records across shards, optionally fault-tolerantly.

    ``retries``/``backoff_s`` bound transient I/O recovery per shard (see
    :func:`read_records`).  With ``skip_errors=True`` the reader follows
    the reference's corrupt-data policy — skip and count, never abort:
    an undecodable record is dropped (``stats.skipped_records``); a
    truncated shard tail or a shard whose retry budget is exhausted drops
    the REST of that shard (``stats.skipped_shards``) and reading
    continues with the next shard.  Without it, errors propagate."""
    stats = stats if stats is not None else ReadStats()
    for p in paths:
        try:
            for payload in read_records(p, retries=retries,
                                        backoff_s=backoff_s, stats=stats,
                                        opener=opener):
                try:
                    yield SSDByteRecord.decode(payload)
                except (struct.error, ValueError, UnicodeDecodeError) as e:
                    if not skip_errors:
                        raise
                    stats.skipped_records += 1
                    logger.warning("%s: skipping undecodable record (%s)",
                                   p, e)
        except (ShardReadError, ValueError) as e:
            if not skip_errors:
                raise
            stats.skipped_shards += 1
            logger.warning("%s: skipping rest of shard (%s)", p, e)
