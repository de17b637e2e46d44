"""Minimal protobuf wire-format codec, pure Python (the port's own copy
of ``utils/protowire.py``).

Caffe's ``.caffemodel`` files are protobuf messages.  Rather than
generated bindings, this module reads and writes the *wire format*
directly — varints and length-delimited fields — for the handful of
field numbers Caffe uses, so the importer needs no dependency.

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
Packed repeated scalars arrive as one length-delimited field; Caffe's
blob ``data`` is packed floats, bulk-decoded with ``np.frombuffer``.

The encoder lets tests write byte-exact caffemodel files, exports
weights back to Caffe's format, and writes the ``Event``/``Summary``
messages of TensorBoard's event files (``parallel/summary.py``).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple, Union

import numpy as np

WIRETYPE_VARINT = 0
WIRETYPE_64BIT = 1
WIRETYPE_LEN = 2
WIRETYPE_32BIT = 5


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def read_varint(buf: Union[bytes, memoryview], pos: int) -> Tuple[int, int]:
    """Decode one base-128 varint at ``pos`` → (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 64:
            raise ValueError("varint too long (corrupt stream)")


def iter_fields(
    buf: Union[bytes, memoryview],
) -> Iterator[Tuple[int, int, Union[int, memoryview]]]:
    """Yield ``(field_number, wire_type, value)`` over a message body.

    ``value`` is an int for varint/fixed fields and a memoryview for
    length-delimited fields (submessages, strings, packed arrays) — no
    copies are made, so iterating a 100 MB caffemodel stays cheap.
    """
    view = memoryview(buf)
    pos = 0
    end = len(view)
    while pos < end:
        tag, pos = read_varint(view, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == WIRETYPE_VARINT:
            value, pos = read_varint(view, pos)
        elif wire == WIRETYPE_64BIT:
            value = struct.unpack_from("<Q", view, pos)[0]
            pos += 8
        elif wire == WIRETYPE_LEN:
            length, pos = read_varint(view, pos)
            value = view[pos:pos + length]
            pos += length
        elif wire == WIRETYPE_32BIT:
            value = struct.unpack_from("<I", view, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, value


def as_string(value: Union[int, memoryview]) -> str:
    return bytes(value).decode("utf-8")


def packed_floats(value: memoryview) -> np.ndarray:
    return np.frombuffer(value, dtype="<f4")


def packed_doubles(value: memoryview) -> np.ndarray:
    return np.frombuffer(value, dtype="<f8")


def packed_varints(value: memoryview) -> List[int]:
    out = []
    pos = 0
    while pos < len(value):
        v, pos = read_varint(value, pos)
        out.append(v)
    return out


def fixed32_float(value: int) -> float:
    """Un-packed ``repeated float`` element (wire type 5)."""
    return struct.unpack("<f", struct.pack("<I", value))[0]


def fixed64_double(value: int) -> float:
    """A ``double`` field (wire type 1)."""
    return struct.unpack("<d", struct.pack("<Q", value))[0]


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class Encoder:
    """Append-only protobuf message writer."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def varint(self, field: int, value: int) -> "Encoder":
        self._parts.append(_varint(field << 3 | WIRETYPE_VARINT))
        self._parts.append(_varint(value))
        return self

    def string(self, field: int, value: str) -> "Encoder":
        return self.bytes(field, value.encode("utf-8"))

    def bytes(self, field: int, value: bytes) -> "Encoder":
        self._parts.append(_varint(field << 3 | WIRETYPE_LEN))
        self._parts.append(_varint(len(value)))
        self._parts.append(value)
        return self

    def message(self, field: int, sub: "Encoder") -> "Encoder":
        return self.bytes(field, sub.tobytes())

    def packed_floats(self, field: int, values: np.ndarray) -> "Encoder":
        return self.bytes(
            field, np.ascontiguousarray(values, dtype="<f4").tobytes())

    def packed_varints(self, field: int, values) -> "Encoder":
        return self.bytes(field, b"".join(_varint(int(v)) for v in values))

    def packed_doubles(self, field: int, values) -> "Encoder":
        return self.bytes(
            field, np.ascontiguousarray(values, dtype="<f8").tobytes())

    def double(self, field: int, value: float) -> "Encoder":
        """A ``double`` field (wire type 1)."""
        self._parts.append(_varint(field << 3 | WIRETYPE_64BIT))
        self._parts.append(struct.pack("<d", value))
        return self

    def float32(self, field: int, value: float) -> "Encoder":
        """Un-packed float element (wire type 5)."""
        self._parts.append(_varint(field << 3 | WIRETYPE_32BIT))
        self._parts.append(struct.pack("<f", value))
        return self

    def tobytes(self) -> bytes:
        return b"".join(self._parts)
