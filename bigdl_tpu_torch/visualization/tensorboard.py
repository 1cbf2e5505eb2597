"""TensorBoard event files (counterpart of
bigdl_tpu/visualization/tensorboard.py).

Wire format (what TensorBoard's EventFileLoader reads):

    record  = len(8B LE) ++ masked_crc32c(len)(4B LE)
              ++ data ++ masked_crc32c(data)(4B LE)
    data    = serialized tensorflow.Event protobuf

The Event and Summary protos are encoded by hand (field numbers from the
public tensorflow/core/util/event.proto and framework/summary.proto; the
scalar and histogram subset BigDL writes).  The CRC is
``dataset/record_io.py``'s.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import List, Optional

import numpy as np

from bigdl_tpu_torch.dataset.record_io import crc32c
from bigdl_tpu_torch.dataset.record_io import masked_crc32c as _masked_crc

__all__ = ["FileWriter", "crc32c", "encode_event",
           "encode_histogram_summary", "encode_scalar_summary",
           "read_events"]


# --------------------------------------------------------------------------
# Minimal protobuf wire encoding
# --------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint(field << 3 | wire_type)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _pb_str(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode())


def _pb_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _pb_bytes(field, payload)


def encode_scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }; Summary{ value=1 }
    val = _pb_str(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, val)


def encode_histogram_summary(tag: str, values: np.ndarray,
                             bins: int = 30) -> bytes:
    """HistogramProto{min=1,max=2,num=3,sum=4,sum_squares=5,
    bucket_limit=6,bucket=7} inside Summary.Value{tag=1, histo=5}."""
    arr = np.asarray(values, np.float64).ravel()
    if arr.size == 0:
        arr = np.zeros(1)
    counts, edges = np.histogram(arr, bins=bins)
    histo = (
        _pb_double(1, float(arr.min()))
        + _pb_double(2, float(arr.max()))
        + _pb_double(3, float(arr.size))
        + _pb_double(4, float(arr.sum()))
        + _pb_double(5, float(np.square(arr).sum()))
        + _pb_packed_doubles(6, edges[1:])
        + _pb_packed_doubles(7, counts)
    )
    val = _pb_str(1, tag) + _pb_bytes(5, histo)
    return _pb_bytes(1, val)


def encode_event(summary: Optional[bytes] = None, step: int = 0,
                 wall_time: Optional[float] = None,
                 file_version: Optional[str] = None) -> bytes:
    # Event{ wall_time=1(double), step=2(int64), file_version=3,
    #        summary=5 }
    out = _pb_double(1, wall_time if wall_time is not None else time.time())
    if step:
        out += _pb_int(2, step)
    if file_version is not None:
        out += _pb_str(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


class FileWriter:
    """Appends framed events to one tfevents file under ``log_dir``, each
    flushed as it is written (BigDL's visualization/tensorboard/
    FileWriter.scala)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.bigdl_tpu_torch"
        self.path = os.path.join(log_dir, fname)
        self._lock = threading.Lock()
        self._fh = open(self.path, "ab")
        self._write_record(encode_event(file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        rec = (header + struct.pack("<I", _masked_crc(header))
               + data + struct.pack("<I", _masked_crc(data)))
        with self._lock:
            self._fh.write(rec)
            self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(
            encode_event(encode_scalar_summary(tag, value), step)
        )

    def add_histogram(self, tag: str, values, step: int):
        self._write_record(
            encode_event(encode_histogram_summary(tag, values), step)
        )

    def close(self):
        with self._lock:
            self._fh.close()


def read_events(path: str) -> List[dict]:
    """A tfevents file's summary values as ``[{wall_time, step, tag,
    value}]`` (``value`` is ``None`` for a histogram); read by
    ``Summary.read_scalar``."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12 : pos + 12 + length]
        pos += 12 + length + 4
        out.extend(_decode_event(payload))
    return out


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:  # pragma: no cover
            raise ValueError(f"wire type {wt}")
        yield field, wt, val


def _decode_event(payload: bytes) -> List[dict]:
    wall = step = None
    rows = []
    for field, wt, val in _iter_fields(payload):
        if field == 1 and wt == 1:
            (wall,) = struct.unpack("<d", val)
        elif field == 2 and wt == 0:
            step = val
        elif field == 5 and wt == 2:  # summary
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag, scalar = None, None
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            (scalar,) = struct.unpack("<f", v3)
                    rows.append({"tag": tag, "value": scalar})
    for r in rows:
        r["wall_time"] = wall
        r["step"] = step or 0
    return rows
