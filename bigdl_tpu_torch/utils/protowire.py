"""Protobuf wire-format helpers (the part of
bigdl_tpu/interop/protowire.py that tf.Example coding needs).

A message is a sequence of ``(tag, value)`` with ``tag = (field << 3) |
wire type``; wire types 0 varint, 1 fixed64, 2 length-delimited (bytes,
a sub-message or a packed repeated field), 5 fixed32.  :func:`fields`
groups a message's raw values by field number; the ``get_*`` accessors
read them typed; the ``enc_*`` functions write them.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

Fields = Dict[int, List[Tuple[int, Any]]]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at ``pos``."""
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """``(field number, wire type, raw value)`` over a message."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = read_varint(buf, pos)
        elif wtype == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wtype == 2:
            ln, pos = read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wtype == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def fields(buf: bytes) -> Fields:
    """A message's raw fields by number: ``{field: [(wire type, value)]}``."""
    out: Fields = {}
    for fnum, wtype, val in iter_fields(buf):
        out.setdefault(fnum, []).append((wtype, val))
    return out


def get_ints(fs: Fields, num: int, signed: bool = False) -> List[int]:
    """Field ``num``'s integers, packed or not; ``signed`` reads them as
    two's-complement int64."""
    out = []
    for wtype, val in fs.get(num, ()):
        if wtype == 0:
            out.append(val)
        elif wtype == 2:
            pos = 0
            while pos < len(val):
                v, pos = read_varint(val, pos)
                out.append(v)
    if signed:
        out = [v - (1 << 64) if v >= (1 << 63) else v for v in out]
    return out


def get_floats(fs: Fields, num: int) -> List[float]:
    """Field ``num``'s float32 values, packed or not."""
    out: List[float] = []
    for wtype, val in fs.get(num, ()):
        if wtype == 5:
            out.append(struct.unpack("<f", val)[0])
        elif wtype == 2:
            out.extend(struct.unpack(f"<{len(val) // 4}f", val))
    return out


def get_bytes(fs: Fields, num: int) -> List[bytes]:
    return [v for w, v in fs.get(num, ()) if w == 2]


def get_str(fs: Fields, num: int, default: str = "") -> str:
    vs = get_bytes(fs, num)
    return vs[-1].decode("utf-8", "replace") if vs else default


def get_messages(fs: Fields, num: int) -> List[Fields]:
    return [fields(v) for v in get_bytes(fs, num)]


def get_message(fs: Fields, num: int):
    """The last sub-message in field ``num``, or ``None``."""
    ms = get_messages(fs, num)
    return ms[-1] if ms else None


def enc_varint(v: int) -> bytes:
    if v < 0:  # two's-complement 64-bit, as protobuf writes int64
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_bytes(fnum: int, v: bytes) -> bytes:
    return enc_varint((fnum << 3) | 2) + enc_varint(len(v)) + v


def enc_str(fnum: int, v: str) -> bytes:
    return enc_bytes(fnum, v.encode("utf-8"))
