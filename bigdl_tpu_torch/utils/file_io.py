"""Scheme-transparent file I/O (counterpart of bigdl_tpu/utils/file_io.py;
BigDL's utils/File.scala:27-120).

A path that contains ``://`` (``gs://``, ``s3://``, ``hdfs://``,
``memory://``, ...) goes through :mod:`fsspec`, imported only then, so
the package needs no ``fsspec`` for local files; ``file://`` is
stripped and a plain path takes the ``os`` route.  Checkpoints
(``utils/serialization.py``), model files and the optimizer's
checkpoint directories build on these functions.
"""
from __future__ import annotations

import os
from typing import BinaryIO, List

__all__ = ["exists", "is_remote", "join", "listdir", "makedirs",
           "open_file", "read_bytes", "strip_file_scheme", "write_bytes"]


def is_remote(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


def strip_file_scheme(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


def _fs(path: str):
    import fsspec

    fs, _ = fsspec.core.url_to_fs(path)
    return fs


def open_file(path: str, mode: str = "rb") -> BinaryIO:
    if is_remote(path):
        import fsspec

        return fsspec.open(path, mode).open()
    return open(strip_file_scheme(path), mode)


def exists(path: str) -> bool:
    if is_remote(path):
        return _fs(path).exists(path)
    return os.path.exists(strip_file_scheme(path))


def makedirs(path: str) -> None:
    if is_remote(path):
        _fs(path).makedirs(path, exist_ok=True)
        return
    path = strip_file_scheme(path)
    if path:
        os.makedirs(path, exist_ok=True)


def listdir(path: str) -> List[str]:
    """Base names of the entries under ``path`` (empty if it is missing)."""
    if is_remote(path):
        fs = _fs(path)
        if not fs.exists(path):
            return []
        return [e.rstrip("/").rsplit("/", 1)[-1]
                for e in fs.ls(path, detail=False)]
    path = strip_file_scheme(path)
    return os.listdir(path) if os.path.isdir(path) else []


def join(base: str, *parts: str) -> str:
    if is_remote(base):
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(base, *parts)


def write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path``: a local file through a temporary file
    and a rename, a remote one in one put (an object store replaces an
    object whole)."""
    if is_remote(path):
        with open_file(path, "wb") as f:
            f.write(data)
        return
    path = strip_file_scheme(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def read_bytes(path: str) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()
