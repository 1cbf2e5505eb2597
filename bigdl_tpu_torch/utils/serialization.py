"""Pytree serialization in the JAX package's npz format (counterpart of
bigdl_tpu/utils/serialization.py).

A tree of nested dicts, lists and tuples is flattened to path-keyed
leaves: arrays go into an npz archive as ``arr0``, ``arr1``, ...;
strings, bools and ``None`` go into a JSON header (``__header__``, a
uint8 array) beside the structure and the path -> array index.  The
layout is the reference's byte for byte, so a file written by either
package loads in the other.

Local paths only (``file://`` is stripped).  A remote scheme such as
``gs://`` or ``memory://`` raises ``NotImplementedError``: the JAX
package routes those through utils/file_io.py, which is not ported yet.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["dumps_pytree", "loads_pytree", "save_pytree", "load_pytree"]


def _local(path: str) -> str:
    if path.startswith("file://"):
        return path[len("file://"):]
    if "://" in path:
        raise NotImplementedError(
            f"{path}: remote paths go through utils/file_io.py, which is "
            "not ported yet; use a local path")
    return path


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree.keys(), key=str):
            out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten_with_paths(v, f"{prefix}/#{i}"))
        return out
    return [(prefix or "/", tree)]


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {str(k): _structure(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__list__": [_structure(v) for v in tree]}
    return "__leaf__"


def _rebuild(struct: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if struct == "__leaf__":
        return leaves[prefix or "/"]
    if isinstance(struct, dict):
        if "__tuple__" in struct:
            return tuple(_rebuild(v, leaves, f"{prefix}/#{i}")
                         for i, v in enumerate(struct["__tuple__"]))
        if "__list__" in struct:
            return [_rebuild(v, leaves, f"{prefix}/#{i}")
                    for i, v in enumerate(struct["__list__"])]
        return {k: _rebuild(v, leaves, f"{prefix}/{k}")
                for k, v in struct.items()}
    raise ValueError(f"bad structure {struct!r}")


def _savez_into(f, tree: Any, compress: bool = False) -> None:
    """Write the npz pytree encoding (header + flattened leaves) into an
    open binary file object."""
    arrays, meta = {}, {}
    for key, val in _flatten_with_paths(tree):
        if isinstance(val, (str, bool)) or val is None:
            meta[key] = val
        else:
            arrays[key] = np.asarray(val)
    payload = {f"arr{i}": a for i, a in enumerate(arrays.values())}
    index = {k: f"arr{i}" for i, k in enumerate(arrays.keys())}
    header = json.dumps(
        {"structure": _structure(tree), "index": index, "meta": meta})
    header_arr = np.frombuffer(header.encode(), dtype=np.uint8)
    savez = np.savez_compressed if compress else np.savez
    savez(f, __header__=header_arr, **payload)


def dumps_pytree(tree: Any, compress: bool = True) -> bytes:
    """Encode a pytree of arrays/scalars to bytes: the wire codec of
    ``PredictionService``'s serialized requests and responses."""
    buf = io.BytesIO()
    _savez_into(buf, tree, compress=compress)
    return buf.getvalue()


def loads_pytree(data: bytes) -> Any:
    """Decode bytes produced by :func:`dumps_pytree` (or a saved pytree
    file read as bytes)."""
    with np.load(io.BytesIO(data)) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        leaves = {k: z[v] for k, v in header["index"].items()}
    leaves.update(header.get("meta", {}))
    return _rebuild(header["structure"], leaves)


def save_pytree(path: str, tree: Any) -> None:
    """Save a pytree of arrays/scalars (plus plain python values under
    string keys) to ``path`` (``.npz`` appended if missing), through a
    temporary file and an atomic rename."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    path = _local(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez appends no suffix
        _savez_into(f, tree)
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with open(_local(path), "rb") as f:
        return loads_pytree(f.read())
