"""Host record I/O (counterpart of bigdl_tpu/native/__init__.py:109-330):
CRC32C, TFRecord writing and reading, and the threaded prefetching shard
reader.

The C++ side is the port's own ``csrc/record_io.cc``, compiled with
``g++`` at first use into ``build/native/`` at the checkout's root (named
by a hash of the source, written through a temporary file and a rename,
so concurrent processes never load a half-written library) and loaded
over ctypes.  Where there is no compiler or no source, every function
falls back to pure Python with the same results (only slower), and
:func:`native_available` is ``False``.

* :func:`crc32c`, :func:`masked_crc32c`: the Castagnoli CRC and
  TFRecord's masked form.
* :class:`TFRecordWriter`, :func:`read_tfrecords`: record framing
  ``len (8 B LE), masked crc(len), data, masked crc(data)``; the reader
  raises ``OSError`` on a truncated or corrupt record.
* :class:`PrefetchingRecordReader`: worker threads read shard files
  into a bounded queue, CRCs checked; one file's records keep their
  order, files interleave; a corrupt record is skipped and counted
  (``crc_errors``).  One pass.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

__all__ = ["PrefetchingRecordReader", "TFRecordWriter", "crc32c",
           "masked_crc32c", "native_available", "read_tfrecords"]

logger = logging.getLogger("bigdl_tpu_torch.record_io")

SRC = Path(__file__).resolve().parents[1] / "csrc" / "record_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False

_P, _U64, _U32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32
#: (restype, argtypes) of each C entry point
_SIGNATURES = {
    "rio_crc32c": (_U32, [ctypes.c_char_p, _U64, _U32]),
    "rio_masked_crc32c": (_U32, [ctypes.c_char_p, _U64]),
    "rio_writer_open": (_P, [ctypes.c_char_p]),
    "rio_write": (ctypes.c_int, [_P, ctypes.c_char_p, _U64]),
    "rio_writer_close": (ctypes.c_int, [_P]),
    "rio_prefetcher_create": (_P, [ctypes.POINTER(ctypes.c_char_p), _U64,
                                   _U64, _U64, ctypes.c_int]),
    "rio_prefetcher_next_size": (ctypes.c_int64, [_P]),
    "rio_prefetcher_pop": (ctypes.c_int64, [_P, ctypes.c_char_p, _U64]),
    "rio_prefetcher_crc_errors": (_U64, [_P]),
    "rio_prefetcher_destroy": (None, [_P]),
}


def _library_path() -> Path:
    """Where the library of the current source lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"librecord_io-{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                        "-pthread", "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug("record_io build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return False


def _load():
    """The loaded library (built on first use), or ``None``."""
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not SRC.exists():
            return None
        lib_path = _library_path()
        if not lib_path.exists():
            if _build_attempted or not _build(lib_path):
                _build_attempted = True
                return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            logger.warning("could not load %s: %s", lib_path, e)
            return None
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ library is built and loaded."""
    return _load() is not None


# ---------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------
_CRC_TABLE = None


def _py_crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def py_crc32c(data: bytes, crc: int = 0) -> int:
    """The pure-Python CRC32C."""
    tbl = _py_crc_table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ tbl[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def py_masked_crc32c(data: bytes) -> int:
    """The pure-Python masked CRC32C."""
    c = py_crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data``, continuing from ``crc``."""
    lib = _load()
    if lib is not None:
        return lib.rio_crc32c(data, len(data), crc)
    return py_crc32c(data, crc)


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC32C: ``rotr(crc, 15) + 0xa282ead8``."""
    lib = _load()
    if lib is not None:
        return lib.rio_masked_crc32c(data, len(data))
    return py_masked_crc32c(data)


# ---------------------------------------------------------------------
# TFRecord I/O
# ---------------------------------------------------------------------
class TFRecordWriter:
    """Writes TFRecord framing to a local file."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._f = None
        if self._lib is not None:
            self._h = self._lib.rio_writer_open(os.fsencode(path))
            if not self._h:
                raise OSError(f"cannot open {path}")
        else:
            self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        if self._h is not None:
            if self._lib.rio_write(self._h, record, len(record)) != 0:
                raise OSError("tfrecord write failed")
            return
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        if self._h is not None:
            h, self._h = self._h, None
            if self._lib.rio_writer_close(h) != 0:
                raise OSError("tfrecord close failed")
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(path: str, verify: bool = True) -> Iterator[bytes]:
    """The records of one file in order, in Python; raises ``OSError``
    on a truncated or (with ``verify``) corrupt record."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise OSError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify and masked_crc32c(header[:8]) != len_crc:
                raise OSError(f"{path}: corrupt length CRC")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise OSError(f"{path}: truncated record payload")
            (data_crc,) = struct.unpack("<I", footer)
            if verify and masked_crc32c(data) != data_crc:
                raise OSError(f"{path}: corrupt record CRC")
            yield data


class PrefetchingRecordReader:
    """The records of ``paths``, read by ``n_threads`` C++ workers into a
    queue of ``capacity`` records.  Without the library, the files are
    read one after the other in Python.  One pass: iterating again yields
    nothing."""

    def __init__(self, paths: Sequence[str], n_threads: int = 4,
                 capacity: int = 1024, verify: bool = True):
        self._paths = [str(p) for p in paths]
        self._lib = _load()
        self._verify = verify
        self._exhausted = False
        self._h = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self._paths))(
                *[os.fsencode(p) for p in self._paths])
            self._h = self._lib.rio_prefetcher_create(
                arr, len(self._paths), n_threads, capacity, int(verify))

    def __iter__(self) -> Iterator[bytes]:
        if self._exhausted:
            return
        if self._h is None:
            try:
                for p in self._paths:
                    yield from read_tfrecords(p, self._verify)
            finally:
                self._exhausted = True
            return
        while True:
            size = self._lib.rio_prefetcher_next_size(self._h)
            if size < 0:
                self._exhausted = True
                return
            buf = ctypes.create_string_buffer(max(size, 1))
            got = self._lib.rio_prefetcher_pop(self._h, buf, size)
            if got < 0:
                self._exhausted = True
                return
            yield buf.raw[:got]

    @property
    def crc_errors(self) -> int:
        return 0 if self._h is None else \
            self._lib.rio_prefetcher_crc_errors(self._h)

    def close(self) -> None:
        if self._h is not None:
            h, self._h = self._h, None
            self._lib.rio_prefetcher_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
