"""Hadoop SequenceFile codec and BigDL's ImageNet record layout
(counterpart of bigdl_tpu/dataset/seqfile.py).

BigDL stores ImageNet as Hadoop SequenceFiles of Text->Text records
(models/utils/ImageNetSeqFileGenerator.scala).  The codec is written at
the wire level (uncompressed SequenceFile version 6) with no Hadoop:

    header:  "SEQ" 0x06, key class, value class (Text.writeString =
             VInt length + UTF-8), compress=0, blockCompress=0,
             metadata count (int32 BE, 0), 16-byte sync marker
    record:  recordLen (int32 BE) = serialized key+value bytes,
             keyLen (int32 BE), key bytes, value bytes
    sync:    recordLen == -1 escape followed by the 16-byte marker,
             written every ~2000 bytes (SYNC_INTERVAL)

Record payload (BGRImgToLocalSeqFile.scala:60-69): key Text = "<label>"
or "<name>\\n<label>"; value Text = int32 BE width, int32 BE height,
then height*width*3 raw BGR bytes.  Labels are 1-based;
``dataset/sharded.py make_seqfile_image_parser`` turns a record into the
RGB image and 0-based label the training loop reads.
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

_MAGIC = b"SEQ\x06"
_SYNC_INTERVAL = 2000
TEXT = "org.apache.hadoop.io.Text"
BYTES_WRITABLE = "org.apache.hadoop.io.BytesWritable"


# ---------------------------------------------------------------------------
# Hadoop VInt (WritableUtils.writeVLong wire format)
# ---------------------------------------------------------------------------
def encode_vint(v: int) -> bytes:
    if -112 <= v <= 127:
        return bytes([v & 0xFF])
    length = -112
    u = v
    if v < 0:
        u = ~v
        length = -120
    tmp = u
    while tmp:
        tmp >>= 8
        length -= 1
    out = [length & 0xFF]
    n = -(length + 120) if length < -120 else -(length + 112)
    for idx in range(n, 0, -1):
        out.append((u >> ((idx - 1) * 8)) & 0xFF)
    return bytes(out)


def decode_vint(buf: bytes, pos: int = 0) -> Tuple[int, int]:
    """Returns (value, next_pos)."""
    fb = buf[pos]
    if fb > 127:
        fb -= 256  # signed byte
    if fb >= -112:
        return fb, pos + 1
    negative = fb < -120
    n = (-119 - fb) if negative else (-111 - fb)
    v = 0
    for i in range(n - 1):
        v = (v << 8) | buf[pos + 1 + i]
    return (~v if negative else v), pos + n


def _write_text(s: bytes) -> bytes:
    return encode_vint(len(s)) + s


# ---------------------------------------------------------------------------
# file-level reader / writer
# ---------------------------------------------------------------------------
class SequenceFileWriter:
    """Uncompressed SequenceFile writer.  ``append(key, value)`` takes
    raw payload bytes; Text/BytesWritable framing is added per the
    declared classes."""

    def __init__(self, path: str, key_class: str = TEXT,
                 value_class: str = TEXT, sync_marker: Optional[bytes] = None):
        self.key_class, self.value_class = key_class, value_class
        self._sync = sync_marker or os.urandom(16)
        assert len(self._sync) == 16
        self._f = open(path, "wb")
        hdr = _MAGIC
        hdr += _write_text(key_class.encode())
        hdr += _write_text(value_class.encode())
        hdr += b"\x00\x00"                 # compress, blockCompress
        hdr += struct.pack(">i", 0)        # metadata: 0 entries
        hdr += self._sync
        self._f.write(hdr)
        self._since_sync = 0

    def _serialize(self, payload: bytes, cls: str) -> bytes:
        if cls == TEXT:
            return _write_text(payload)
        if cls == BYTES_WRITABLE:
            return struct.pack(">i", len(payload)) + payload
        return payload

    def append(self, key: bytes, value: bytes) -> None:
        k = self._serialize(key, self.key_class)
        v = self._serialize(value, self.value_class)
        if self._since_sync > _SYNC_INTERVAL:
            self._f.write(struct.pack(">i", -1) + self._sync)
            self._since_sync = 0
        rec = struct.pack(">ii", len(k) + len(v), len(k)) + k + v
        self._f.write(rec)
        self._since_sync += len(rec)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_sequence_file(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) payload bytes from an uncompressed
    SequenceFile, unframing Text/BytesWritable per the header classes.
    Streams record-by-record — shards are never slurped whole (several
    readers run concurrently in ShardedFileDataSet._load)."""

    def unframe(payload: bytes, cls: str) -> bytes:
        if cls == TEXT:
            ln, p = decode_vint(payload, 0)
            return payload[p:p + ln]
        if cls == BYTES_WRITABLE:
            (ln,) = struct.unpack_from(">i", payload, 0)
            return payload[4:4 + ln]
        return payload

    with open(path, "rb") as f:
        def need(n: int) -> bytes:
            buf = f.read(n)
            if len(buf) != n:
                raise ValueError(f"{path}: truncated SequenceFile")
            return buf

        def read_vint() -> int:
            first = need(1)
            ln = 1
            fb = first[0] - 256 if first[0] > 127 else first[0]
            if fb < -112:
                ln = (-119 - fb) if fb < -120 else (-111 - fb)
            v, _ = decode_vint(first + (need(ln - 1) if ln > 1 else b""))
            return v

        if need(4) != _MAGIC:
            raise ValueError(f"{path}: not a version-6 SequenceFile")
        key_class = need(read_vint()).decode()
        value_class = need(read_vint()).decode()
        compress, block_compress = need(2)
        if compress or block_compress:
            raise ValueError(
                f"{path}: compressed SequenceFiles unsupported")
        (n_meta,) = struct.unpack(">i", need(4))
        for _ in range(n_meta):  # metadata entries are Text pairs
            need(read_vint())
            need(read_vint())
        sync = need(16)

        while True:
            head = f.read(4)
            if len(head) < 4:
                return  # clean EOF
            (rec_len,) = struct.unpack(">i", head)
            if rec_len == -1:  # sync escape
                if need(16) != sync:
                    raise ValueError(f"{path}: bad sync marker")
                continue
            (key_len,) = struct.unpack(">i", need(4))
            payload = need(rec_len)
            yield (unframe(payload[:key_len], key_class),
                   unframe(payload[key_len:], value_class))


# ---------------------------------------------------------------------------
# BigDL ImageNet record layout
# ---------------------------------------------------------------------------
def encode_imagenet_record(img_bgr: np.ndarray, label: int,
                           name: Optional[str] = None
                           ) -> Tuple[bytes, bytes]:
    """(H, W, 3) uint8 BGR image -> (key, value) payloads in the
    reference layout (BGRImgToLocalSeqFile.scala:60-69)."""
    img_bgr = np.ascontiguousarray(img_bgr, dtype=np.uint8)
    h, w = img_bgr.shape[:2]
    key = (f"{name}\n{int(label)}" if name else f"{int(label)}").encode()
    value = struct.pack(">ii", w, h) + img_bgr.tobytes()
    return key, value


def decode_imagenet_record(key: bytes, value: bytes
                           ) -> Tuple[np.ndarray, int, Optional[str]]:
    """Inverse of :func:`encode_imagenet_record` ->
    (BGR uint8 image, label, name-or-None)."""
    parts = key.decode().split("\n")
    name, label = (parts[0], int(parts[1])) if len(parts) == 2 \
        else (None, int(parts[0]))
    w, h = struct.unpack_from(">ii", value, 0)
    img = np.frombuffer(value, np.uint8, count=h * w * 3, offset=8)
    return img.reshape(h, w, 3), label, name


def count_sequence_file_records(path: str) -> int:
    """Record count by framing-header seeks — payloads are skipped, not
    decoded (the count_tfrecords analog for streaming-mode
    batches_per_epoch over large SequenceFile shards)."""
    n = 0
    with open(path, "rb") as f:
        def need(k: int) -> bytes:
            buf = f.read(k)
            if len(buf) != k:
                raise ValueError(f"{path}: truncated SequenceFile")
            return buf

        def skip_vint_payload():
            first = need(1)
            fb = first[0] - 256 if first[0] > 127 else first[0]
            if fb < -112:
                ln = (-119 - fb) if fb < -120 else (-111 - fb)
                v, _ = decode_vint(first + need(ln - 1))
            else:
                v = fb
            f.seek(v, 1)

        if need(4) != _MAGIC:
            raise ValueError(f"{path}: not a version-6 SequenceFile")
        skip_vint_payload()       # key class
        skip_vint_payload()       # value class
        compress, block_compress = need(2)
        if compress or block_compress:
            raise ValueError(f"{path}: compressed SequenceFiles unsupported")
        (n_meta,) = struct.unpack(">i", need(4))
        for _ in range(2 * n_meta):
            skip_vint_payload()
        need(16)                  # sync marker
        while True:
            head = f.read(4)
            if len(head) < 4:
                return n
            (rec_len,) = struct.unpack(">i", head)
            if rec_len == -1:
                f.seek(16, 1)
                continue
            f.seek(4 + rec_len, 1)  # key length + payload
            n += 1
