"""Minimal protobuf wire-format encoder/decoder for ONNX.

A copy of ``mxnet_tpu/contrib/onnx/_proto.py``.  The reference
(``python/mxnet/contrib/onnx/mx2onnx/``) builds ModelProto with the
``onnx`` python package; this codec emits and reads the protobuf wire
format directly, so no ``onnx`` package is needed.
Field numbers follow onnx.proto (stable across ONNX releases; IR version
pinned below).  The decoder exists for round-trip tests and the importer.

Wire format: each field = varint key (field_number << 3 | wire_type) +
payload.  Wire types used: 0 = varint, 2 = length-delimited, 5 = 32-bit.
"""
from __future__ import annotations

import struct

# onnx TensorProto.DataType
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
BF16 = 16

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def fint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def fbytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def fstr(field: int, s: str) -> bytes:
    return fbytes(field, s.encode("utf-8"))


def ffloat(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(value))


def fpacked_ints(field: int, values) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return fbytes(field, payload)


# --- decoder (for tests / importer) -----------------------------------------

def parse(buf: bytes):
    """→ list of (field_number, wire_type, value); value is int for
    varint/32-bit, bytes for length-delimited."""
    out = []
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<I", buf[i:i + 4])[0]
            i += 4
        elif wire == 1:
            v = struct.unpack("<Q", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.append((field, wire, v))
    return out


def _read_varint(buf: bytes, i: int):
    shift = 0
    result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def fields(parsed, number):
    return [v for f, _w, v in parsed if f == number]
