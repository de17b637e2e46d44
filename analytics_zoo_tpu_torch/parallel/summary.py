"""TensorBoard summaries (counterpart of ``parallel/summary.py``): the
reference's ``TrainSummary``/``ValidationSummary`` with per-tag
triggers (``set_summary_trigger("Parameters", Trigger.several_iteration(
50))``).

The port writes TensorBoard's event files itself, needing neither
``tensorboardX`` nor ``tensorboard``: each record is TFRecord-framed
(the length, its masked CRC-32C, the data, its masked CRC-32C) around
an ``Event`` message encoded through ``utils/protowire.py``'s
:class:`~analytics_zoo_tpu_torch.utils.protowire.Encoder`, and the
CRC-32C is computed in Python.  :func:`read_events` reads a file back,
checking every CRC.  Over several ranks only rank 0 writes.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.parallel.optim import TrainingState, Trigger
from analytics_zoo_tpu_torch.utils import protowire

# -- CRC-32C (Castagnoli), as TFRecord frames use it --------------------------

_CRC32C_POLY = 0x82F63B78


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, masked CRC of the length, data, masked CRC
    of the data."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


def iter_records(buf: bytes) -> Iterator[bytes]:
    """The data of each TFRecord in ``buf``; a CRC mismatch raises."""
    pos = 0
    while pos < len(buf):
        header = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        data = buf[pos + 12:pos + 12 + n]
        (dcrc,) = struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])
        if hcrc != masked_crc32c(header) or dcrc != masked_crc32c(data):
            raise ValueError(f"event file: bad CRC at byte {pos}")
        yield data
        pos += 16 + n


# -- Event / Summary messages (tensorflow/core/util/event.proto) -------------

def _event(step: int, summary: Optional[protowire.Encoder] = None,
           file_version: Optional[str] = None) -> bytes:
    # az-allow: one-clock — TensorBoard's Event.wall_time is wall-clock seconds by the format's definition; written, never compared
    ev = protowire.Encoder().double(1, time.time())     # wall_time
    if step:
        ev.varint(2, int(step))
    if file_version is not None:
        ev.string(3, file_version)
    if summary is not None:
        ev.message(5, summary)
    return ev.tobytes()


def _scalar_summary(tag: str, value: float) -> protowire.Encoder:
    val = protowire.Encoder().string(1, tag).float32(2, float(value))
    return protowire.Encoder().message(1, val)


def _histogram_limits() -> np.ndarray:
    """TensorBoard's default bucket edges: ±1e-12 · 1.1^k up to 1e20."""
    pos = []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    pos = np.asarray(pos)
    return np.concatenate([-pos[::-1], [0.0], pos])


def _histogram_summary(tag: str, values) -> protowire.Encoder:
    x = np.asarray(values, dtype=np.float64).reshape(-1)
    limits = _histogram_limits()
    counts = np.bincount(np.searchsorted(limits, x, side="left"),
                         minlength=limits.size + 1)
    upper = np.concatenate([limits, [np.finfo(np.float64).max]])
    nz = np.nonzero(counts)[0]
    lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
    histo = (protowire.Encoder()
             .double(1, float(x.min()) if x.size else 0.0)
             .double(2, float(x.max()) if x.size else 0.0)
             .double(3, float(x.size))
             .double(4, float(x.sum()))
             .double(5, float((x * x).sum()))
             .packed_doubles(6, upper[lo:hi])
             .packed_doubles(7, counts[lo:hi].astype(np.float64)))
    val = protowire.Encoder().string(1, tag).message(5, histo)
    return protowire.Encoder().message(1, val)


def read_events(path: str) -> List[Dict[str, Any]]:
    """The events of one event file, or of every event file under a
    directory, in order: ``{"wall_time", "step", "file_version"?,
    "scalars": {tag: value}, "histograms": {tag: {"num", "sum", "min",
    "max"}}}``."""
    files = ([os.path.join(path, f) for f in sorted(os.listdir(path))
              if f.startswith("events.out.tfevents.")]
             if os.path.isdir(path) else [path])
    out: List[Dict[str, Any]] = []
    for f in files:
        with open(f, "rb") as fh:
            buf = fh.read()
        for rec in iter_records(buf):
            ev: Dict[str, Any] = {"step": 0, "scalars": {},
                                  "histograms": {}}
            for field, _, value in protowire.iter_fields(rec):
                if field == 1:
                    ev["wall_time"] = protowire.fixed64_double(value)
                elif field == 2:
                    ev["step"] = int(value)
                elif field == 3:
                    ev["file_version"] = protowire.as_string(value)
                elif field == 5:
                    _read_summary(value, ev)
            out.append(ev)
    return out


def _read_summary(buf, ev: Dict[str, Any]) -> None:
    for field, _, value in protowire.iter_fields(buf):
        if field != 1:
            continue
        tag, simple, histo = None, None, None
        for f2, _, v2 in protowire.iter_fields(value):
            if f2 == 1:
                tag = protowire.as_string(v2)
            elif f2 == 2:
                simple = protowire.fixed32_float(v2)
            elif f2 == 5:
                histo = {}
                for f3, _, v3 in protowire.iter_fields(v2):
                    key = {1: "min", 2: "max", 3: "num", 4: "sum"}.get(f3)
                    if key is not None:
                        histo[key] = protowire.fixed64_double(v3)
        if simple is not None:
            ev["scalars"][tag] = simple
        if histo is not None:
            ev["histograms"][tag] = histo


def _is_rank0() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


class EventFileWriter:
    """Append-only TensorBoard event file in ``log_dir`` (the file-version
    event first, each record flushed as it is written)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        # az-allow: one-clock — TensorBoard names its event file by wall-clock seconds; the name orders runs and decides nothing
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time()):010d}."
                     f"{socket.gethostname()}.{os.getpid()}")
        self._f = open(self.path, "ab")
        self._write(_event(0, file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        self._f.write(frame_record(data))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(step, _scalar_summary(tag, value)))

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._write(_event(step, _histogram_summary(tag, values)))

    def close(self) -> None:
        self._f.close()


class _Summary:
    def __init__(self, log_dir: str, app_name: str, kind: str):
        self.log_dir = os.path.join(log_dir, app_name, kind)
        self._writer: Optional[EventFileWriter] = None
        self.triggers: Dict[str, Trigger] = {}

    @property
    def writer(self) -> Optional[EventFileWriter]:
        """The event file, opened on first use by rank 0 only."""
        if self._writer is None and _is_rank0():
            self._writer = EventFileWriter(self.log_dir)
        return self._writer

    def set_summary_trigger(self, tag: str, trigger: Trigger) -> "_Summary":
        self.triggers[tag] = trigger
        return self

    def _gated(self, tag: str, iteration: int) -> bool:
        t = self.triggers.get(tag)
        if t is None:
            return True
        # iteration-granular gating; epoch_finished=True keeps an
        # every-epoch trigger from never firing here
        return t(TrainingState(iteration=iteration, epoch_finished=True))

    def add_scalar(self, tag: str, value, iteration: int) -> None:
        """``value`` may be a tensor on the card: it is read back only
        after the trigger lets the tag through."""
        if self.writer is not None and self._gated(tag, iteration):
            self.writer.add_scalar(tag, float(value), iteration)

    def add_histogram(self, tag: str, values, iteration: int) -> None:
        if self.writer is not None and self._gated(tag, iteration):
            if isinstance(values, torch.Tensor):
                values = values.detach().float().cpu().numpy()
            self.writer.add_histogram(tag, values, iteration)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class TrainSummary(_Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")


class ValidationSummary(_Summary):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")
