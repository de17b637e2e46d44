"""Convert reference-era Hadoop SequenceFiles of SSD records to .azr shards
(counterpart of ``tools/seqfile_to_azr.py``).

The reference materializes detection datasets as SequenceFiles whose key is
a ``Text`` file name and whose value is a ``Text`` wrapping the binary
record ``[int32 dataLen][int32 classLen][jpeg bytes][2·classLen bytes of
(labels row, difficult row) floats][4·classLen bytes of bbox floats]``
(all big-endian; ``classLen`` is the BYTE length of one N-float row) —
written by ``RoiByteImageToSeq.scala:33`` and re-read by
``RecordToFeature.scala:28``.  This tool reads that container + layout in
pure Python (uncompressed SequenceFiles; no Hadoop needed) and re-shards
the records into this framework's ``.azr`` files, so datasets generated by
the reference's tooling are directly ingestible.

A writer is included (``write_sequence_file``) for round-trip tests and
for exporting .azr data back to the reference format; its 16-byte sync
marker is random unless ``sync`` is given.  The shards go through the
port's ``data/records.py::write_ssd_records``.

Usage::

    python -m analytics_zoo_tpu_torch.tools.seqfile_to_azr DIR -o out/voc \
        -p 8
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import sys
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

SEQ_MAGIC = b"SEQ"
_SYNC_ESCAPE = 0xFFFFFFFF  # int32 -1 record length ⇒ 16-byte sync marker


# ---------------------------------------------------------------------------
# Hadoop writable primitives
# ---------------------------------------------------------------------------


def read_vint(buf: bytes, off: int) -> Tuple[int, int]:
    """Hadoop WritableUtils zero-compressed varint → (value, new offset)."""
    first = struct.unpack_from("b", buf, off)[0]
    off += 1
    if first >= -112:
        return first, off
    negative = first < -120
    size = -(first + 120) if negative else -(first + 112)
    value = 0
    for i in range(size):
        value = (value << 8) | buf[off + i]
    off += size
    return (~value if negative else value), off


def write_vint(value: int) -> bytes:
    if -112 <= value <= 127:
        return struct.pack("b", value)
    negative = value < 0
    if negative:
        value = ~value
    size = (value.bit_length() + 7) // 8
    first = (-120 if negative else -112) - size
    return struct.pack("b", first) + value.to_bytes(size, "big")


def _read_text(buf: bytes, off: int) -> Tuple[bytes, int]:
    """Hadoop ``Text``: vint byte-length + raw bytes (the reference stores
    binary record data in Text, so no utf-8 decode here)."""
    n, off = read_vint(buf, off)
    return buf[off:off + n], off + n


def _write_text(data: bytes) -> bytes:
    return write_vint(len(data)) + data


# ---------------------------------------------------------------------------
# SequenceFile container
# ---------------------------------------------------------------------------


def read_sequence_file(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield raw (key_bytes, value_bytes) from an uncompressed SequenceFile
    with Text/Text or Text/BytesWritable classes."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != SEQ_MAGIC:
        raise ValueError(f"{path}: not a SequenceFile")
    version = buf[3]
    if version < 6:
        raise ValueError(f"{path}: unsupported SequenceFile version {version}")
    off = 4
    key_cls, off = _read_text(buf, off)
    val_cls, off = _read_text(buf, off)
    compressed = buf[off]; off += 1
    block_compressed = buf[off]; off += 1
    if compressed or block_compressed:
        raise ValueError(
            f"{path}: compressed SequenceFiles are not supported "
            "(the reference's RoiByteImageToSeq writes uncompressed)")
    n_meta = struct.unpack_from(">i", buf, off)[0]; off += 4
    for _ in range(n_meta):
        _, off = _read_text(buf, off)
        _, off = _read_text(buf, off)
    sync = buf[off:off + 16]; off += 16

    bytes_writable = b"BytesWritable" in val_cls
    end = len(buf)
    while off + 4 <= end:
        rec_len = struct.unpack_from(">I", buf, off)[0]; off += 4
        if rec_len == _SYNC_ESCAPE:
            marker = buf[off:off + 16]; off += 16
            if marker != sync:
                raise ValueError(f"{path}: bad sync marker @ {off - 16}")
            continue
        key_len = struct.unpack_from(">i", buf, off)[0]; off += 4
        key_raw = buf[off:off + key_len]; off += key_len
        val_raw = buf[off:off + rec_len - key_len]; off += rec_len - key_len
        key, _ = _read_text(key_raw, 0)
        if bytes_writable:
            n = struct.unpack_from(">i", val_raw, 0)[0]
            value = val_raw[4:4 + n]
        else:
            value, _ = _read_text(val_raw, 0)
        yield key, value


def write_sequence_file(path: str, pairs: Sequence[Tuple[bytes, bytes]],
                        sync_interval: int = 5,
                        sync: Optional[bytes] = None) -> None:
    """Uncompressed Text/Text SequenceFile writer (round-trip tests +
    export back to the reference's format)."""
    if sync is None:
        sync = os.urandom(16)
    if len(sync) != 16:
        raise ValueError("a SequenceFile sync marker is 16 bytes")
    out = [SEQ_MAGIC, bytes([6]),
           _write_text(b"org.apache.hadoop.io.Text"),
           _write_text(b"org.apache.hadoop.io.Text"),
           b"\x00\x00",                      # no compression
           struct.pack(">i", 0),             # no metadata
           sync]
    for i, (key, value) in enumerate(pairs):
        if i and i % sync_interval == 0:
            out.append(struct.pack(">I", _SYNC_ESCAPE))
            out.append(sync)
        k = _write_text(key)
        v = _write_text(value)
        out.append(struct.pack(">i", len(k) + len(v)))
        out.append(struct.pack(">i", len(k)))
        out.append(k)
        out.append(v)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ---------------------------------------------------------------------------
# reference SSD record layout ⇄ SSDByteRecord
# ---------------------------------------------------------------------------


def decode_reference_record(key: bytes, value: bytes):
    """Reference binary layout → ``SSDByteRecord`` (gt rows
    (label, difficult, x1, y1, x2, y2), matching ``RecordToFeature``'s
    (2,N) classes + (N,4) bbox views)."""
    from analytics_zoo_tpu_torch.data.records import SSDByteRecord

    data_len, class_len = struct.unpack_from(">ii", value, 0)
    jpeg = value[8:8 + data_len]
    n = class_len // 4
    if n:
        cls = np.frombuffer(value, ">f4", 2 * n, 8 + data_len)
        boxes = np.frombuffer(value, ">f4", 4 * n,
                              8 + data_len + 2 * class_len).reshape(n, 4)
        gt = np.concatenate([
            cls[:n, None].astype(np.float32),      # labels row
            cls[n:, None].astype(np.float32),      # difficult row
            boxes.astype(np.float32),
        ], axis=1)
    else:
        gt = np.zeros((0, 6), np.float32)
    return SSDByteRecord(data=jpeg, path=key.decode("utf-8", "replace"),
                         gt=gt)


def encode_reference_record(record) -> Tuple[bytes, bytes]:
    """``SSDByteRecord`` → (key, value) in the reference layout."""
    gt = (np.zeros((0, 6), np.float32) if record.gt is None
          else np.asarray(record.gt, np.float32).reshape(-1, 6))
    n = gt.shape[0]
    class_len = n * 4
    parts = [struct.pack(">ii", len(record.data), class_len), record.data]
    if n:
        parts.append(np.ascontiguousarray(gt[:, 0], ">f4").tobytes())  # labels
        parts.append(np.ascontiguousarray(gt[:, 1], ">f4").tobytes())  # difficult
        parts.append(np.ascontiguousarray(gt[:, 2:6], ">f4").tobytes())
    key = os.path.basename(record.path or "image").encode("utf-8")
    return key, b"".join(parts)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Hadoop SequenceFile(s) of SSD records → .azr shards")
    ap.add_argument("input", help="SequenceFile path, glob, or directory")
    ap.add_argument("-o", "--output", required=True, help="output prefix")
    ap.add_argument("-p", "--num-shards", type=int, default=8)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from analytics_zoo_tpu_torch.data.records import write_ssd_records

    if os.path.isdir(args.input):
        paths = sorted(glob.glob(os.path.join(args.input, "*.seq"))) or sorted(
            glob.glob(os.path.join(args.input, "*")))
    else:
        paths = sorted(glob.glob(args.input)) or [args.input]
    records = []
    for p in paths:
        for key, value in read_sequence_file(p):
            records.append(decode_reference_record(key, value))
    out = write_ssd_records(records, args.output, args.num_shards)
    print(f"converted {len(records)} records from {len(paths)} "
          f"SequenceFile(s) into {len(out)} shards: {out[0]} …")
    return 0


if __name__ == "__main__":
    sys.exit(main())
