"""Pytree serialization in the JAX package's npz format (counterpart of
bigdl_tpu/utils/serialization.py).

A tree of nested dicts, lists and tuples is flattened to path-keyed
leaves: arrays go into an npz archive as ``arr0``, ``arr1``, ...;
strings, bools and ``None`` go into a JSON header (``__header__``, a
uint8 array) beside the structure and the path -> array index.  The
layout is the reference's byte for byte, so a file written by either
package loads in the other.

A path may carry a scheme (``gs://``, ``s3://``, ``memory://``, ...):
it goes through ``utils/file_io.py`` (fsspec, imported only for such a
path).  A local file is written through a temporary file and an atomic
rename, streamed, with no copy of the whole archive in host memory.
:func:`save_model`/:func:`load_model` keep the JAX package's model blob,
``{"class": <class name>, "variables": {"params", "state"}}``, so a
model file from either package loads in the other.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.utils import file_io

__all__ = ["dumps_pytree", "load_model", "load_pytree", "loads_pytree",
           "save_model", "save_pytree"]


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
    string keys) to ``path`` (``.npz`` appended if missing): a local
    file through a temporary file and an atomic rename, a remote one in
    one put."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if file_io.is_remote(path):
        file_io.write_bytes(path, dumps_pytree(tree, compress=False))
        return
    path = file_io.strip_file_scheme(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez appends no suffix
        _savez_into(f, tree)
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    if not path.endswith(".npz"):
        path = path + ".npz"
    return loads_pytree(file_io.read_bytes(path))


def save_model(path: str, module, variables: Optional[Dict[str, Any]] = None
               ) -> None:
    """Save a model's variables with its class name (BigDL's
    ``Module.saveModule``; bigdl_tpu/utils/serialization.py:136-140).
    ``variables`` is a JAX-shaped ``{"params", "state"}`` tree; by
    default the module's own, exported by ``export_variables``."""
    if variables is None:
        from bigdl_tpu_torch.utils.convert import export_variables

        variables = export_variables(module)
    save_pytree(path, {"class": type(module).__name__,
                       "variables": variables})


def load_model(path: str, module=None) -> Dict[str, Any]:
    """The blob :func:`save_model` wrote (either package's), with its
    ``variables``; given a freshly built ``module``, those variables are
    loaded into it by name (``load_jax_variables``) as well."""
    blob = load_pytree(path)
    if module is not None:
        from bigdl_tpu_torch.utils.convert import load_jax_variables

        load_jax_variables(module, blob["variables"])
    return blob
