"""The collectives of the data-parallel step, over a mesh's data group.

GSPMD places the JAX package's collectives; the port calls them.  Three
are needed: a sum over the data axis (the gradients, the loss, the
kernels' BatchNorm statistics), its differentiable form
(:func:`all_reduce_sum`: the backward sums the cotangents over the ranks
too, as ``psum``'s transpose does) and the gather of row shards
(:func:`all_gather_rows`, ZeRO-1's fresh parameters and a sharded
evaluation's outputs).

Under NCCL the tensors go to the collective as they are, on the card,
so a CUDA graph captures the collective with the step.  Under gloo a
CUDA tensor is staged through host memory (copied to the CPU, reduced
there, copied back): a rule on the backend, chosen before any launch.
A collective that fails raises.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

__all__ = ["all_gather_rows", "all_reduce_sum", "all_reduce_sum_",
           "broadcast_leaves", "gather_leaves", "reduce_leaves"]


#: the gather into one tensor: ``all_gather_single`` where torch has it
#: (``all_gather_into_tensor`` is deprecated there), else the latter
_gather_into = getattr(dist, "all_gather_single",
                       None) or dist.all_gather_into_tensor


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce_sum_(t: torch.Tensor, mesh: Mesh,
                    axis: str = DATA_AXIS) -> torch.Tensor:
    """Sum ``t`` over the axis's ranks, in place; returns ``t``."""
    group = mesh.group(axis)
    if _staged(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0,
               axis: str = DATA_AXIS) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of the axis, in place."""
    group = mesh.group(axis)
    root = dist.get_global_rank(group, src)
    if _staged(mesh, t):
        host = t.cpu()
        dist.broadcast(host, root, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, root, group=group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh,
                    axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's ``t`` stacked on dim 0 in rank order: ``(n * rows,
    ...)`` for an ``n``-rank axis."""
    group = mesh.group(axis)
    n = mesh.shape[axis]
    src = t.contiguous()
    if _staged(mesh, src):
        host = src.cpu()
        out = torch.empty((n * host.shape[0],) + tuple(host.shape[1:]),
                          dtype=host.dtype)
        _gather_into(out, host, group=group)
        return out.to(t.device)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _gather_into(out, src, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over the data axis; its backward is ``psum`` of the
    cotangent (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_sum_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the data axis, differentiable."""
    return _AllReduceSum.apply(x, mesh)


def _by_dtype(tensors: Sequence[torch.Tensor]
              ) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def reduce_leaves(tensors: Sequence[torch.Tensor], mesh: Mesh
                  ) -> List[torch.Tensor]:
    """Each tensor summed over the data axis: one collective per dtype
    over the tensors flattened into one buffer (a bucket)."""
    out: List[torch.Tensor] = list(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce_sum_(flat, mesh)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def broadcast_leaves(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     src: int = 0):
    """Rank ``src``'s values copied into each tensor on every rank, in
    place: one collective per dtype over one flat buffer."""
    for idx in _by_dtype(tensors).values():
        flat = broadcast_(torch.cat([tensors[i].reshape(-1) for i in idx]),
                          mesh, src)
        off = 0
        with torch.no_grad():
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[off:off + n].view(tensors[i].shape))
                off += n


def gather_leaves(parts: Sequence[torch.Tensor], mesh: Mesh
                  ) -> List[torch.Tensor]:
    """Each rank's row shard of each leaf gathered into the whole leaf
    (shards in rank order on dim 0): one collective per dtype over the
    shards flattened into one buffer."""
    n = mesh.shape[DATA_AXIS]
    out: List[torch.Tensor] = list(parts)
    for idx in _by_dtype(parts).values():
        flat = torch.cat([parts[i].reshape(-1) for i in idx])
        every = all_gather_rows(flat, mesh).view(n, flat.numel())
        off = 0
        for i in idx:
            p = parts[i]
            k = p.numel()
            out[i] = every[:, off:off + k].reshape(
                (n * p.shape[0],) + tuple(p.shape[1:]))
            off += k
    return out
