"""The kernels under data parallelism (counterpart of
bigdl_tpu/ops/pallas/partition.py:60-165).

The JAX package runs each Pallas kernel inside a ``shard_map`` over the
mesh's data axis: the kernel sees its rank's rows, and the cross-row
outputs (the BatchNorm ``ssum``/``ssq`` of kernels 1 and 4) are
``psum``-ed back to global sums, whose transpose sums their cotangents
over the ranks in the backward (``fused_matmul.py:485-488``).  The
port's kernels see a rank's rows by construction (one process per
device); :func:`reduce_stats` is the ``psum``: the statistics are summed
over the data axis, differentiably, and the BatchNorm count becomes the
global count, so the normalisation, the unbiased correction of the
running variance and the running statistics are the global batch's.
Kernels 6 and 7 are row-parallel with no cross-row output
(``partition.py:6-15``) and need nothing.

The data-parallel step publishes its mesh with :func:`kernel_mesh_scope`
around the step's body, as ``build_dp_train_step`` does with
``kernel_mesh_scope`` in JAX; the tensor-parallel layers take their
axes' groups from it, and with ``seq_dim`` the scope says the batch (and
so every activation) is split on that dim over the ``seq`` axis
(:func:`seq_sharding`).  A layer reads it once per forward, in the
thread that runs the forward, and hands it to what it recomputes: the
backward of a CUDA tensor runs on autograd's device thread, where the
scope is not set.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

__all__ = ["current_kernel_mesh", "global_means", "kernel_mesh_scope",
           "current_seq_dim", "dropout_part", "model_mesh", "reduce_stats",
           "seq_sharding"]

_KERNEL_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "bigdl_tpu_torch_kernel_mesh", default=None)
_SEQ_DIM: contextvars.ContextVar = contextvars.ContextVar(
    "bigdl_tpu_torch_seq_dim", default=None)


@contextlib.contextmanager
def kernel_mesh_scope(mesh, seq_dim: Optional[int] = None):
    """Publish ``mesh`` (and the batch's sequence-sharded dim, if any) to
    the layers run in this scope."""
    token = _KERNEL_MESH.set(mesh)
    token_seq = _SEQ_DIM.set(seq_dim)
    try:
        yield
    finally:
        _SEQ_DIM.reset(token_seq)
        _KERNEL_MESH.reset(token)


def current_seq_dim() -> Optional[int]:
    """The sequence-sharded dim of the enclosing scope's batch, or
    None."""
    return _SEQ_DIM.get()


def seq_sharding() -> Optional[Tuple[int, int, int]]:
    """``(dim, index, parts)`` of the activations' sequence dim when the
    scope's batch is split over a ``seq`` axis of degree > 1, else
    None."""
    mesh, dim = _KERNEL_MESH.get(), _SEQ_DIM.get()
    if mesh is None or dim is None or mesh.shape.get("seq", 1) == 1:
        return None
    return dim, mesh.rank("seq"), mesh.shape["seq"]


def dropout_part(x: torch.Tensor):
    """The dropout ``part`` of an activation under :func:`seq_sharding`
    (None when the sequence is whole)."""
    s = seq_sharding()
    return [s] if s is not None and x.dim() > s[0] else None


def current_kernel_mesh():
    """The mesh of the enclosing :func:`kernel_mesh_scope`, or None."""
    return _KERNEL_MESH.get()


def model_mesh(what: str, degree: int):
    """The step's mesh for a layer whose leaves hold ``1 / degree`` of
    their width: its ``model`` axis must have that degree."""
    from bigdl_tpu_torch.parallel.mesh import MODEL_AXIS

    mesh = current_kernel_mesh()
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) != degree:
        raise ValueError(
            f"{what}: leaves sharded {degree}-way need the step's mesh "
            f"with model={degree} (parallel.build_dp_train_step's scope)")
    return mesh


def _data_degree(mesh) -> int:
    from bigdl_tpu_torch.parallel.mesh import DATA_AXIS

    return mesh.shape[DATA_AXIS]


def reduce_stats(ssum: torch.Tensor, ssq: torch.Tensor, count: int,
                 mesh) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(ssum, ssq, count)`` of the global batch: the per-column sums
    summed over the mesh's data axis in one collective (its backward sums
    ``(dssum, dssq)`` over the ranks) and the count times the data
    degree.  Without a mesh they are returned as they are."""
    if mesh is None:
        return ssum, ssq, count
    from bigdl_tpu_torch.parallel.comm import all_reduce_sum

    both = all_reduce_sum(torch.stack([ssum, ssq]), mesh)
    return both[0], both[1], count * _data_degree(mesh)


def global_means(means: torch.Tensor, mesh: Optional[object]
                 ) -> torch.Tensor:
    """Per-rank means over equal row counts turned into the global
    batch's (``jnp.mean`` over a data-sharded batch under GSPMD): summed
    over the data axis, differentiably, and divided by its degree."""
    if mesh is None:
        return means
    from bigdl_tpu_torch.parallel.comm import all_reduce_sum

    return all_reduce_sum(means, mesh) / _data_degree(mesh)
