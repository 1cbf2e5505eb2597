"""Sharded distributed checkpointing with resharding restore (counterpart
of bigdl_tpu/distributed/checkpoint.py, whose files it writes and reads).

Layout of one checkpoint step under the root directory::

    ckpt-00000042/              (committed: the rename already happened)
        shard-00000.npz         one npz per writing process, chunks c0..cN
        fragment-00000.json     leaf-key -> [{name, bounds}] for that shard
        manifest.json           structure + global shape/dtype per leaf +
                                host_state + merged fragment table
        COMMIT                  written LAST; its presence == committed

Write protocol (two-phase commit):

1. every process snapshots the chunks it owns to host memory on the
   caller's thread (before the next step overwrites the trees) and hands
   them to a one-worker background writer;
2. the writer streams ``shard-<rank>.npz`` then ``fragment-<rank>.json``
   (each file atomic tmp+rename) into ``ckpt-N.tmp/``;
3. process 0 waits for all ``world`` fragments, merges ``manifest.json``,
   renames ``ckpt-N.tmp`` -> ``ckpt-N``, then writes ``COMMIT``.

A crash before step 3 ends leaves a ``.tmp`` directory or a renamed one
without ``COMMIT``; :func:`latest_committed` ignores both.  The root is a
local (or local-semantics network) directory shared by the processes.

Ownership: a tree's leaf is a tensor or array every rank holds whole
(written once, by process 0), a :class:`ShardedLeaf` (this rank's part
of a leaf: its rows of dim 0, or with ``bounds`` its ``[lo, hi)`` on
every dim, as a tensor-, pipeline- or expert-parallel shard's, possibly
cut further into ZeRO-1 rows; each chunk written by the one rank whose
``write`` is set among those holding it), or a str, bool or ``None``
(kept in the manifest's ``meta``).  Tensors of a type
numpy lacks (bfloat16, float8) are written as their raw bits under
their type's name, as ``np.savez`` writes JAX's ml_dtypes arrays, and
come back as tensors of that type.

Resharding restore: the manifest records every leaf's global shape and
every chunk's bounds, so :func:`restore_checkpoint` assembles any region
of any leaf whatever the writers' layout (a ``RowShard``'s rows, a
``Sharded`` layout's part, or the whole leaf): a checkpoint written at
world 2 restores at world 1 and back, one written under ``pp x tp``
restores under another layout, and either package reads the other's.

Env knobs: ``BIGDL_TPU_CKPT_KEEP`` (committed steps retained, default
2), ``BIGDL_TPU_COMMIT_TIMEOUT_S`` (process 0's wait for the fragments,
default 120; on timeout the step is left uncommitted).
"""
from __future__ import annotations

import io
import json
import logging
import os
import re
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.parallel.mesh import RowShard, Sharded
from bigdl_tpu_torch.telemetry.tracer import CAT_TRAIN, get_tracer
from bigdl_tpu_torch.utils.file_io import strip_file_scheme
from bigdl_tpu_torch.utils.serialization import (_flatten_with_paths,
                                                 _structure)

logger = logging.getLogger("bigdl_tpu_torch.distributed")

__all__ = ["COMMIT_FILE", "MANIFEST_FILE", "ShardedCheckpointer",
           "ShardedLeaf", "build_reshard_step", "latest_committed",
           "restore_checkpoint", "snapshot_shards", "write_checkpoint"]

MANIFEST_FILE = "manifest.json"
COMMIT_FILE = "COMMIT"
_STEP_RE = re.compile(r"ckpt-(\d+)")
_FRAGMENT_RE = re.compile(r"fragment-(\d{5})\.json")

#: tensor types numpy lacks, written as raw bits under their name:
#: type -> (name, integer type of its bits in torch, in numpy)
_RAW = {torch.bfloat16: ("bfloat16", torch.int16, np.int16),
        torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
        torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_RAW_BY_NAME = {name: (t, bits) for t, (name, _, bits) in _RAW.items()}


@dataclass
class ShardedLeaf:
    """This rank's rows ``[row0, row0 + len(local))`` of a leaf of
    ``global_shape`` split on dim 0, or with ``bounds`` its ``[lo, hi)``
    on every dim; ``write`` False for a copy another rank writes."""

    local: Any
    global_shape: Tuple[int, ...]
    row0: int = 0
    bounds: Optional[list] = None
    write: bool = True


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its type's name."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _RAW:
            name, bits, _ = _RAW[t.dtype]
            return t.view(bits).numpy().copy(), name
        arr = t.numpy().copy()
        return arr, arr.dtype.name
    arr = np.array(leaf, copy=True)
    return arr, arr.dtype.name


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _topology(process_index, process_count) -> Tuple[int, int]:
    from bigdl_tpu_torch.dataset.sharded import process_topology

    rank, world = process_topology()
    return (rank if process_index is None else process_index,
            world if process_count is None else process_count)


def snapshot_shards(tree: Any, process_index: int):
    """Host copies of the chunks this process owns, its leaves' global
    shapes and types, and the meta leaves: a :class:`ShardedLeaf`'s rows
    are this process's; any other tensor or array is written whole by
    process 0; str, bool and ``None`` leaves ride in ``meta``.  Runs on
    the caller's thread, so the copies are taken before the next step
    changes the trees."""
    chunks: Dict[str, list] = {}
    leaf_info: Dict[str, dict] = {}
    meta: Dict[str, Any] = {}
    for key, leaf in _flatten_with_paths(tree):
        if isinstance(leaf, (str, bool)) or leaf is None:
            meta[key] = leaf
            continue
        if isinstance(leaf, ShardedLeaf):
            arr, dtype = _host(leaf.local)
            leaf_info[key] = {"shape": list(leaf.global_shape),
                              "dtype": dtype}
            bounds = ([list(b) for b in leaf.bounds] if leaf.bounds
                      else [[leaf.row0, leaf.row0 + arr.shape[0]]]
                      + [[0, d] for d in arr.shape[1:]])
            if leaf.write:
                chunks[key] = [(bounds, arr)]
            continue
        arr, dtype = _host(leaf)
        leaf_info[key] = {"shape": list(arr.shape), "dtype": dtype}
        if process_index == 0:
            chunks[key] = [([[0, d] for d in arr.shape], arr)]
    return chunks, leaf_info, meta


def _write_snapshot(root: str, snap: dict) -> Optional[str]:
    """The background writer's half of the commit protocol (steps 2-3).
    Returns the step's directory, or None when it was committed
    already."""
    it = snap["iteration"]
    pid = snap["process_index"]
    nproc = snap["process_count"]
    final = os.path.join(root, f"ckpt-{it:08d}")
    tmp = final + ".tmp"
    if os.path.exists(os.path.join(final, COMMIT_FILE)):
        return None  # e.g. a forced save re-hitting the trigger step
    os.makedirs(tmp, exist_ok=True)

    payload, frag = {}, {}
    n = 0
    for key, parts in snap["chunks"].items():
        ents = []
        for bounds, arr in parts:
            name = f"c{n}"
            n += 1
            payload[name] = arr
            ents.append({"name": name, "bounds": bounds})
        frag[key] = ents
    buf = io.BytesIO()
    np.savez(buf, **payload)
    _atomic_write(os.path.join(tmp, f"shard-{pid:05d}.npz"), buf.getvalue())
    # the fragment is each process's "my shard file is complete" record:
    # written strictly after the npz, so its existence implies the data
    _atomic_write(
        os.path.join(tmp, f"fragment-{pid:05d}.json"),
        json.dumps({"process": pid, "file": f"shard-{pid:05d}.npz",
                    "chunks": frag}).encode())
    if pid != 0:
        return final

    deadline = time.monotonic() + snap["commit_timeout_s"]
    while True:
        names = sorted(x for x in os.listdir(tmp)
                       if _FRAGMENT_RE.fullmatch(x))
        if len(names) >= nproc:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint {it}: {len(names)}/{nproc} fragments after "
                f"{snap['commit_timeout_s']:.0f}s; leaving {tmp} "
                "uncommitted")
        time.sleep(0.05)
    fragments = []
    for x in names:
        with open(os.path.join(tmp, x), "rb") as f:
            fragments.append(json.loads(f.read()))
    manifest = {
        "format": 1,
        "iteration": it,
        "world": nproc,
        "structure": snap["structure"],
        "leaves": snap["leaf_info"],
        "meta": snap["meta"],
        "host_state": snap["host_state"],
        "fragments": fragments,
    }
    _atomic_write(os.path.join(tmp, MANIFEST_FILE),
                  json.dumps(manifest).encode())
    os.rename(tmp, final)
    _atomic_write(os.path.join(final, COMMIT_FILE),
                  json.dumps({"iteration": it, "t": time.time()}).encode())
    return final


def _commit_timeout(value: Optional[float]) -> float:
    if value is not None:
        return value
    return float(os.environ.get("BIGDL_TPU_COMMIT_TIMEOUT_S", "120"))


def write_checkpoint(root: str, tree: Any, host_state: dict, iteration: int,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None,
                     commit_timeout_s: Optional[float] = None
                     ) -> Optional[str]:
    """A synchronous sharded write (snapshot and commit on this thread);
    the rank and world default to the process group's."""
    root = strip_file_scheme(root)
    pid, nproc = _topology(process_index, process_count)
    os.makedirs(root, exist_ok=True)
    chunks, leaf_info, meta = snapshot_shards(tree, pid)
    return _write_snapshot(root, {
        "iteration": int(iteration), "process_index": pid,
        "process_count": nproc, "chunks": chunks, "leaf_info": leaf_info,
        "meta": meta, "structure": _structure(tree),
        "host_state": host_state,
        "commit_timeout_s": _commit_timeout(commit_timeout_s),
    })


def latest_committed(root: str) -> Optional[Tuple[int, str]]:
    """The newest committed step under ``root`` as ``(iteration,
    path)``; half-written directories (``.tmp``, or no ``COMMIT``) never
    match."""
    root = strip_file_scheme(root)
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = _STEP_RE.fullmatch(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if not os.path.exists(os.path.join(path, COMMIT_FILE)):
            continue
        it = int(m.group(1))
        if best is None or it > best[0]:
            best = (it, path)
    return best


def _layout_lookup(layouts) -> Callable[[str], Any]:
    """Leaf key -> layout over a (possibly prefix-shaped) tree of
    layouts: one layout standing for a subtree is found by walking the
    key's ancestors."""
    if layouts is None:
        return lambda key: None
    flat = dict(_flatten_with_paths(layouts))

    def lookup(key):
        k = key
        while True:
            if k in flat:
                return flat[k]
            if k in ("", "/"):
                return None
            k = k.rsplit("/", 1)[0] or "/"

    return lookup


def _from_raw(arr: np.ndarray, dtype: str):
    raw = _RAW_BY_NAME.get(dtype)
    if raw is None:
        return arr.astype(np.dtype(dtype), copy=False)
    t, bits = raw
    return torch.from_numpy(np.ascontiguousarray(arr).view(bits).copy()
                            ).view(t)


def restore_checkpoint(path: str, shardings=None):
    """``(tree, host_state, manifest)`` of a committed step.

    ``shardings``: a tree (or a prefix of one) of target layouts,
    whatever the layout the step was written with: a leaf under a
    :class:`~bigdl_tpu_torch.parallel.mesh.RowShard` comes back as that
    part's rows (whole when the parts do not divide its dim 0), under a
    :class:`~bigdl_tpu_torch.parallel.mesh.Sharded` layout as this rank's
    part, any other as the whole leaf.  Leaves are numpy arrays, and tensors for
    the types numpy lacks."""
    path = strip_file_scheme(path)
    if not os.path.exists(os.path.join(path, COMMIT_FILE)):
        raise ValueError(f"{path}: no {COMMIT_FILE} marker (uncommitted "
                         "or half-written checkpoint)")
    with open(os.path.join(path, MANIFEST_FILE), "rb") as f:
        manifest = json.loads(f.read())
    lookup = _layout_lookup(shardings)

    table: Dict[str, list] = {}
    for frag in manifest["fragments"]:
        for key, ents in frag["chunks"].items():
            table.setdefault(key, []).extend(
                (e["bounds"], frag["file"], e["name"]) for e in ents)
    files: Dict[str, Any] = {}

    def chunk(fname, name):
        z = files.get(fname)
        if z is None:
            z = files[fname] = np.load(os.path.join(path, fname))
        return z[name]

    def assemble(key, region):
        info = manifest["leaves"][key]
        shape = tuple(info["shape"])
        if not shape:
            _, fname, name = table[key][0]
            return _from_raw(np.asarray(chunk(fname, name)).reshape(()),
                             info["dtype"])
        out = None
        filled = 0
        for bounds, fname, name in table[key]:
            inter = []
            for (rl, rh), (cl, ch) in zip(region, bounds):
                lo, hi = max(rl, cl), min(rh, ch)
                if lo >= hi:
                    inter = None
                    break
                inter.append((lo, hi))
            if inter is None:
                continue
            arr = chunk(fname, name)
            if out is None:
                out = np.empty(tuple(hi - lo for lo, hi in region),
                               arr.dtype)
            src = tuple(slice(lo - cl, hi - cl)
                        for (lo, hi), (cl, _) in zip(inter, bounds))
            dst = tuple(slice(lo - rl, hi - rl)
                        for (lo, hi), (rl, _) in zip(inter, region))
            out[dst] = arr[src]
            filled += int(np.prod([hi - lo for lo, hi in inter]))
        size = int(np.prod([hi - lo for lo, hi in region]))
        if filled != size:
            raise ValueError(
                f"checkpoint leaf {key}: region {region} not fully covered "
                f"by recorded chunks (got {filled}/{size} elements)")
        if out is None:  # an empty region
            out = np.empty(tuple(hi - lo for lo, hi in region),
                           np.float32)
        return _from_raw(out, info["dtype"])

    def make_leaf(key):
        if key in manifest["meta"]:
            return manifest["meta"][key]
        shape = tuple(manifest["leaves"][key]["shape"])
        region = [[0, d] for d in shape]
        part = lookup(key)
        if isinstance(part, RowShard) and shape and shape[0] > 0 \
                and shape[0] % part.parts == 0:
            region[0] = list(part.rows(shape[0]))
        elif isinstance(part, Sharded):
            region = part.region(shape)
        return assemble(key, region)

    def build(struct, prefix=""):
        if struct == "__leaf__":
            return make_leaf(prefix or "/")
        if isinstance(struct, dict):
            if "__tuple__" in struct:
                return tuple(build(v, f"{prefix}/#{i}")
                             for i, v in enumerate(struct["__tuple__"]))
            if "__list__" in struct:
                return [build(v, f"{prefix}/#{i}")
                        for i, v in enumerate(struct["__list__"])]
            return {k: build(v, f"{prefix}/{k}") for k, v in struct.items()}
        raise ValueError(f"bad manifest structure node {struct!r}")

    try:
        tree = build(manifest["structure"])
    finally:
        for z in files.values():
            z.close()
    return tree, manifest.get("host_state", {}), manifest


def build_reshard_step(src_shardings, dst_shardings, *, mesh) -> Callable:
    """An on-device relayout ``tree -> tree`` from one layout tree to
    another over ``mesh``'s data axis (JAX's jitted identity between
    shardings): a :class:`RowShard` leaf that becomes
    :class:`Replicated` is gathered (one collective per dtype), a
    replicated leaf that becomes a row shard is cut to this rank's rows,
    any other leaf (``Replicated`` on both sides, say) is passed
    through.  Cross-world restores go through
    :func:`restore_checkpoint` instead.  ``mesh`` is keyword-only, where
    JAX's third parameter is ``donate`` (``jit`` plumbing)."""
    from bigdl_tpu_torch.parallel import comm

    src_of = _layout_lookup(src_shardings)
    dst_of = _layout_lookup(dst_shardings)

    def reshard(tree):
        leaves = _flatten_with_paths(tree)
        gather = [(k, v) for k, v in leaves
                  if isinstance(src_of(k), RowShard)
                  and not isinstance(dst_of(k), RowShard)]
        whole = dict(zip([k for k, _ in gather], comm.gather_leaves(
            [v for _, v in gather], mesh))) if gather else {}

        def build(node, prefix=""):
            if isinstance(node, dict):
                return {k: build(v, f"{prefix}/{k}") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(build(v, f"{prefix}/#{i}")
                                  for i, v in enumerate(node))
            key = prefix or "/"
            if key in whole:
                return whole[key]
            src, dst = src_of(key), dst_of(key)
            if isinstance(dst, RowShard) and not isinstance(src, RowShard) \
                    and torch.is_tensor(node) and node.dim() \
                    and node.shape[0] % dst.parts == 0:
                lo, hi = dst.rows(node.shape[0])
                return node[lo:hi].clone()
            return node

        return build(tree)

    return reshard


class ShardedCheckpointer:
    """One process's handle on the sharded checkpoint stream.

    ``save`` snapshots on the caller's thread and commits on a one-worker
    background pool with a single write slot (backpressure), as the
    optimizer's whole-tree writer does.  ``finish`` joins the writer; it
    runs before any re-formation or exit, or a half-written step could
    hold up process 0's wait for the fragments."""

    def __init__(self, root: str, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 keep: Optional[int] = None,
                 commit_timeout_s: Optional[float] = None):
        self.root = strip_file_scheme(root)
        self.process_index, self.process_count = _topology(process_index,
                                                           process_count)
        self.keep = (int(os.environ.get("BIGDL_TPU_CKPT_KEEP", "2"))
                     if keep is None else keep)
        self.commit_timeout_s = _commit_timeout(commit_timeout_s)
        os.makedirs(self.root, exist_ok=True)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="bigdl-shard-ckpt")
        self._future = None
        self.last_committed: Optional[int] = None

    def save(self, tree: Any, host_state: dict, iteration: int):
        with get_tracer().span("checkpoint_snapshot", CAT_TRAIN,
                               args={"iteration": int(iteration)}):
            chunks, leaf_info, meta = snapshot_shards(tree,
                                                      self.process_index)
            structure = _structure(tree)
        self.wait(raise_errors=True)  # single write slot: backpressure
        snap = {
            "iteration": int(iteration),
            "process_index": self.process_index,
            "process_count": self.process_count,
            "chunks": chunks, "leaf_info": leaf_info, "meta": meta,
            "structure": structure, "host_state": host_state,
            "commit_timeout_s": self.commit_timeout_s,
        }
        self._future = self._pool.submit(self._write, snap)
        return self._future

    def _write(self, snap):
        with get_tracer().span("checkpoint_write", CAT_TRAIN,
                               args={"iteration": snap["iteration"]}):
            final = _write_snapshot(self.root, snap)
        if self.process_index == 0 and final is not None:
            self.last_committed = snap["iteration"]
            self._prune()
        return final

    def wait(self, raise_errors: bool = True):
        """Block until the write in flight (if any) lands."""
        fut, self._future = self._future, None
        if fut is None:
            return
        try:
            fut.result()
        except Exception:
            if raise_errors:
                raise
            logger.warning("sharded checkpoint write failed", exc_info=True)

    def finish(self, raise_errors: bool = True):
        """Join the background writer and shut the pool down."""
        try:
            self.wait(raise_errors=raise_errors)
        finally:
            self._pool.shutdown(wait=True)

    def restore_latest(self, shardings=None):
        """``(iteration, tree, host_state)`` of the newest commit, or
        None when the root holds no committed step."""
        found = latest_committed(self.root)
        if found is None:
            return None
        it, path = found
        tree, host_state, _ = restore_checkpoint(path, shardings)
        return it, tree, host_state

    def _prune(self):
        if self.keep <= 0:
            return
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_RE.fullmatch(name)
            if m and os.path.exists(
                    os.path.join(self.root, name, COMMIT_FILE)):
                steps.append((int(m.group(1)), name))
        for _, name in sorted(steps)[:-self.keep]:
            path = os.path.join(self.root, name)
            try:
                # un-commit first so a crash mid-delete can't leave a
                # committed-looking dir with missing shards
                os.remove(os.path.join(path, COMMIT_FILE))
                shutil.rmtree(path)
            except OSError:
                logger.warning("could not prune %s", path, exc_info=True)
