"""The collectives of the distributed steps, over a mesh axis's group.

GSPMD places the JAX package's collectives; the port calls them.  The
data axis needs three: a sum (the gradients, the loss, the kernels'
BatchNorm statistics), its differentiable form (:func:`all_reduce_sum`:
the backward sums the cotangents over the ranks too, as ``psum``'s
transpose does: each data rank's loss stands for the global one and
the step averages the gradients) and the gather of row shards
(:func:`all_gather_rows`, ZeRO-1's fresh parameters and a sharded
evaluation's outputs).

The other axes hold ranks that all compute the one global loss, so a
replicated activation has the same cotangent on each of them; their
differentiable collectives are the conjugate pairs of tensor
parallelism, each a ``torch.autograd.Function``:

- :func:`copy_to` (identity forward, the cotangents summed backward):
  where a replicated activation enters per-rank work (a column-parallel
  product, the expert banks, the pipeline's first stage);
- :func:`reduce_from` (sum forward, identity backward): where per-rank
  partial sums leave it (a row-parallel product, the pipeline's output);
- :func:`gather_from` (all-gather along a dim forward, this rank's
  slice of the cotangent backward): the vocab-sharded logits;
- :func:`all_to_all` (``lax.all_to_all(split_axis, concat_axis,
  tiled=True)``, its transpose backward): Ulysses' head/sequence swap;
- :func:`ppermute` (a shift by one along the axis, cyclic or not, the
  reverse shift backward): the ring's K/V rotation and the pipeline's
  hop to the next stage.

Under NCCL the tensors go to the collective as they are, on the card,
so a CUDA graph captures the collective with the step.  Under gloo a
CUDA tensor is staged through host memory (copied to the CPU, reduced
there, copied back): a rule on the backend, chosen before any launch.
A collective that fails raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from bigdl_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

__all__ = ["all_gather", "all_gather_rows", "all_reduce_sum",
           "all_reduce_sum_", "all_to_all", "broadcast_leaves", "copy_to",
           "gather_from", "gather_leaves", "ppermute", "reduce_from",
           "reduce_leaves"]


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


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int
               ) -> torch.Tensor:
    """Every rank's ``t`` of the axis concatenated along ``dim`` in rank
    order."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    rows = all_gather_rows(t.movedim(dim, 0), mesh, axis)
    return rows.movedim(0, dim).contiguous()


def _slice(t: torch.Tensor, mesh: Mesh, axis: str, dim: int
           ) -> torch.Tensor:
    """This rank's part of ``t``'s ``dim`` over the axis."""
    n = mesh.shape[axis]
    per = t.shape[dim] // n
    return t.narrow(dim, mesh.rank(axis) * per, per).contiguous()


def _all_to_all(t: torch.Tensor, mesh: Mesh, axis: str, split: int,
                concat: int) -> torch.Tensor:
    """``lax.all_to_all(t, axis, split, concat, tiled=True)``: part ``j``
    of ``split`` goes to rank ``j``, and the parts received are
    concatenated along ``concat`` in rank order."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    parts = t.movedim(split, 0)
    per = parts.shape[0] // n
    send = parts.reshape((n, per) + tuple(parts.shape[1:])).contiguous()
    group = mesh.group(axis)
    if _staged(mesh, send):
        host = send.cpu()
        got = torch.empty_like(host)
        dist.all_to_all_single(got, host, group=group)
        got = got.to(t.device)
    else:
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=group)
    # got[j]: rank j's part for this rank, split dim still leading
    got = got.movedim(1, split + 1)  # (n, ...) with t's layout after
    got = got.movedim(0, concat)     # the sources next to the concat dim
    shape = list(got.shape)
    shape[concat:concat + 2] = [shape[concat] * shape[concat + 1]]
    return got.reshape(shape)


def _shift(t: torch.Tensor, mesh: Mesh, axis: str, step: int,
           cyclic: bool) -> torch.Tensor:
    """Rank ``i``'s ``t`` on rank ``i + step`` of the axis (modulo its
    degree when ``cyclic``; otherwise the ranks nothing reaches get
    zeros)."""
    n = mesh.shape[axis]
    if n == 1:
        return t if cyclic else torch.zeros_like(t)
    group = mesh.group(axis)
    r = mesh.rank(axis)
    src, dst = r - step, r + step
    if cyclic:
        src, dst = src % n, dst % n
    staged = _staged(mesh, t)
    send = (t.cpu() if staged else t).contiguous()
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(t.device) if staged else recv


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over an axis whose ranks each stand for the global loss
    (the data axis); its backward is ``psum`` of the cotangent (every
    rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_sum_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.mesh, ctx.axis), None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh,
                   axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum of ``x`` over the axis (the data axis by default),
    differentiable, the backward summing the cotangents too."""
    return _AllReduceSum.apply(x, mesh, axis)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_sum_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.args = (mesh, axis, concat, split)
        return _all_to_all(x, mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g.contiguous(), *ctx.args), None, None, None,
                None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, cyclic):
        ctx.mesh, ctx.axis, ctx.cyclic = mesh, axis, cyclic
        return _shift(x, mesh, axis, 1, cyclic)

    @staticmethod
    def backward(ctx, g):
        return (_shift(g.contiguous(), ctx.mesh, ctx.axis, -1, ctx.cyclic),
                None, None, None)


def _active(mesh: Optional[Mesh], axis: str) -> bool:
    return mesh is not None and mesh.shape.get(axis, 1) > 1


def copy_to(x: torch.Tensor, mesh: Optional[Mesh],
            axis: str) -> torch.Tensor:
    """Identity forward; the cotangent summed over the axis backward."""
    return _CopyTo.apply(x, mesh, axis) if _active(mesh, axis) else x


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh],
                axis: str) -> torch.Tensor:
    """The sum over the axis forward; identity backward."""
    return _ReduceFrom.apply(x, mesh, axis) if _active(mesh, axis) else x


def gather_from(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
                dim: int) -> torch.Tensor:
    """The parts of the axis concatenated along ``dim`` forward; this
    rank's part of the cotangent backward."""
    return (_GatherFrom.apply(x, mesh, axis, dim)
            if _active(mesh, axis) else x)


def all_to_all(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``,
    differentiable."""
    if not _active(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def ppermute(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
             cyclic: bool = True) -> torch.Tensor:
    """``lax.ppermute`` with the pairs ``(i, i + 1)`` (and ``(n - 1, 0)``
    when ``cyclic``): rank ``i``'s ``x`` on rank ``i + 1``; a rank no
    pair reaches gets zeros.  The backward shifts the cotangent back."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x if cyclic else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, axis, cyclic)


def _by_dtype(tensors: Sequence[torch.Tensor]
              ) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def reduce_leaves(tensors: Sequence[torch.Tensor], mesh: Mesh,
                  axes: Sequence[str] = (DATA_AXIS,)
                  ) -> List[torch.Tensor]:
    """Each tensor summed over the axes (the data axis by default): one
    collective per dtype and axis over the tensors flattened into one
    buffer (a bucket)."""
    out: List[torch.Tensor] = list(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for axis in axes:
            if mesh.shape.get(axis, 1) > 1:
                all_reduce_sum_(flat, mesh, axis)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def broadcast_leaves(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     src: int = 0, axis: str = DATA_AXIS):
    """Rank ``src``'s values of the axis (the data axis by default)
    copied into each tensor on every rank of it, in place: one
    collective per dtype over one flat buffer."""
    for idx in _by_dtype(tensors).values():
        flat = broadcast_(torch.cat([tensors[i].reshape(-1) for i in idx]),
                          mesh, src, axis)
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
