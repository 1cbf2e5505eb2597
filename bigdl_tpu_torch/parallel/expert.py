"""Expert (MoE) parallelism: Switch-style top-1 routing with
capacity-bounded dispatch, the expert banks split over the ``expert``
mesh axis (counterpart of bigdl_tpu/parallel/expert.py).

The JAX layer builds a dense one-hot dispatch tensor (tokens, E, C) and
contracts it with the tokens; the port computes the same selection with
index operations of fixed shapes (each token lands in slot ``pos`` of
its expert's queue when ``pos < capacity``, else in a spare row that is
dropped, and its output is the expert's row times its gate, exactly the
one-hot contraction's value), so no op waits on the host and a CUDA
graph captures the step.

The statistics follow the shapes the JAX body sees.  With ``mesh`` (the
``--ep`` path, one GSPMD program over the global batch) the capacity
takes the global token count, a token's queue position counts the
tokens of its expert on the earlier data ranks first, and the
load-balance loss is the global batch's: the per-expert sums are summed
over the data axis.  Without it (inside the pipeline, which is manual
over ``data``) they are the local microbatch's.  A bank holding ``E /
ep`` experts runs its experts on the tokens, which every rank of the
``expert`` axis holds whole, and the combined outputs are summed over
that axis (``comm.reduce_from``; the tokens and gates enter with
``comm.copy_to``, so their gradients sum every bank's part).

The router softmax runs in f32; ``aux_loss`` is a buffer at JAX's state
path (``.../ffn/aux_loss``), which ``make_train_step`` adds to the loss
times ``aux_loss_weight``.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.init import Xavier
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.partition import current_kernel_mesh
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS, Mesh,
                                           Replicated, sharded)

__all__ = ["MoE", "expert_param_shardings", "transformer_expert_shardings"]


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """``index`` (T,) -> (T, n) int64 one-hot, with no host sync (which
    ``F.one_hot`` may make to check its range)."""
    return (index[:, None] == torch.arange(n, device=index.device)).long()


def _top1_dispatch(gates: torch.Tensor, capacity: int,
                   offset: Optional[torch.Tensor] = None):
    """``gates`` (T, E) -> ``(expert, pos, keep, gate_val, onehot)``:
    each token's expert (the first of equal gates), its place in that
    expert's queue (after ``offset[e]`` tokens routed there before this
    batch), whether it is under ``capacity``, its gate and the one-hot
    routing (T, E) in the gates' type (JAX's ``_top1_dispatch`` in index
    form)."""
    e = gates.shape[1]
    expert = gates.argmax(-1)
    gate_val = gates.gather(1, expert[:, None])[:, 0]
    onehot = _one_hot(expert, e).to(gates.dtype)
    queue = onehot.cumsum(0) - 1.0
    if offset is not None:
        queue = queue + offset.to(queue.dtype)[None]
    pos = queue.gather(1, expert[:, None])[:, 0]
    keep = pos < capacity
    return expert, pos.to(torch.int64).clamp(0, capacity - 1), keep, \
        gate_val, onehot


class MoE(Module):
    """Mixture-of-experts FFN (top-1 switch routing): ``(B, T, D)`` ->
    ``(B, T, D)``.  Leaves ``router`` (D, E), ``w_in`` (E, D, F) and
    ``w_out`` (E, F, D); ``mesh`` as in the module's docstring."""

    def __init__(self, hidden_size: int, ffn_size: int, num_experts: int,
                 capacity_factor: float = 1.25, mesh: Optional[Mesh] = None,
                 expert_axis: str = EXPERT_AXIS, name: Optional[str] = None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.ffn_size = ffn_size
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.mesh = mesh
        self.expert_axis = expert_axis
        d, f, e = hidden_size, ffn_size, num_experts
        self.router = torch.nn.Parameter(torch.empty(d, e))
        self.w_in = torch.nn.Parameter(torch.empty(e, d, f))
        self.w_out = torch.nn.Parameter(torch.empty(e, f, d))
        self.register_buffer("aux_loss", torch.zeros(()))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        d, f, e = self.hidden_size, self.ffn_size, self.num_experts
        init = Xavier()
        with torch.no_grad():
            self.router.copy_(init(generator, (d, e), fan_in=d, fan_out=e))
            self.w_in.copy_(init(generator, (e, d, f), fan_in=d, fan_out=f))
            self.w_out.copy_(init(generator, (e, f, d), fan_in=f,
                                  fan_out=d))

    def _data_mesh(self) -> Optional[Mesh]:
        mesh = self.mesh
        if mesh is None or mesh.shape.get(DATA_AXIS, 1) == 1:
            return None
        if current_kernel_mesh() is None:  # a whole batch, one process
            return None
        return mesh

    def forward(self, x, rng=None):
        b, t, d = x.shape
        tokens = x.reshape(b * t, d)
        e = self.num_experts
        data = self._data_mesh()
        n = b * t * (data.shape[DATA_AXIS] if data is not None else 1)
        capacity = max(int(self.capacity_factor * n / e), 1)

        logits = tokens @ self.router.to(x.dtype)
        gates = torch.softmax(logits.float(), dim=-1)
        offset = None
        if data is not None:  # queue positions in the global token order
            with torch.no_grad():
                counts = _one_hot(gates.argmax(-1), e).sum(0)
                every = comm.all_gather_rows(counts[None], data)
                offset = every[:data.rank(DATA_AXIS)].sum(0)
        expert, pos, keep, gate_val, onehot = _top1_dispatch(
            gates, capacity, offset)
        # load balance: fraction routed x mean gate, per expert
        density, proxy = onehot.sum(0), gates.sum(0)
        if data is not None:
            density = comm.all_reduce_sum(density, data)
            proxy = comm.all_reduce_sum(proxy, data)
        aux = torch.sum((density / n) * (proxy / n)) * e

        out = self._experts(tokens, expert, pos, keep, gate_val, capacity)
        buf = self.aux_loss
        buf.detach_()  # no graph kept from an earlier forward
        buf.copy_(aux)
        return out.reshape(b, t, d)

    def _experts(self, tokens, expert, pos, keep, gate_val, capacity):
        """The banks this rank holds on the tokens routed to them, each
        token's output its expert's row times its gate (zero where the
        token overflowed), summed over the expert axis."""
        e_loc = self.w_in.shape[0]
        mesh, first = None, 0
        if e_loc < self.num_experts:
            mesh = self.mesh or current_kernel_mesh()
            if mesh is None or (mesh.shape.get(self.expert_axis, 1)
                                != self.num_experts // e_loc):
                raise ValueError(
                    f"MoE: a bank of {e_loc} of {self.num_experts} experts "
                    f"needs a mesh whose {self.expert_axis!r} axis splits "
                    "them")
            first = mesh.rank(self.expert_axis) * e_loc
            tokens = comm.copy_to(tokens, mesh, self.expert_axis)
            gate_val = comm.copy_to(gate_val, mesh, self.expert_axis)
        # fixed shapes (a CUDA graph captures the step): every token has a
        # row of the flat queues, the spare last row taking the tokens
        # this bank does not run (another bank's or over capacity)
        mine = keep & (expert >= first) & (expert < first + e_loc)
        spare = e_loc * capacity
        slot = torch.where(mine, (expert - first) * capacity + pos,
                           torch.full_like(pos, spare))
        dt = tokens.dtype
        expert_in = tokens.new_zeros((spare + 1, tokens.shape[1]))
        expert_in = expert_in.index_put((slot,), tokens)
        expert_in = expert_in[:spare].reshape(e_loc, capacity, -1)
        h = torch.relu(torch.einsum("ecd,edf->ecf", expert_in,
                                    self.w_in.to(dt)))
        expert_out = torch.einsum("ecf,efd->ecd", h, self.w_out.to(dt))
        expert_out = torch.cat([expert_out.reshape(spare, -1),
                                expert_out.new_zeros((1, tokens.shape[1]))])
        out = expert_out[slot] * gate_val.to(dt)[:, None]
        if mesh is not None:
            out = comm.reduce_from(out, mesh, self.expert_axis)
        return out


def _check_expert_divisible(name, n_experts, mesh, expert_axis):
    if n_experts % mesh.shape[expert_axis]:
        # silent replication would still spend ranks on the expert axis
        raise ValueError(
            f"{name}: {n_experts} experts do not divide over the "
            f"{mesh.shape[expert_axis]}-way '{expert_axis}' mesh axis")


def expert_param_shardings(mesh: Mesh, params,
                           expert_axis: str = EXPERT_AXIS):
    """One MoE's layouts: the banks (leading E dim) over the expert axis,
    the router replicated."""
    out = {}
    for k, v in params.items():
        if k in ("w_in", "w_out"):
            _check_expert_divisible(k, v.shape[0], mesh, expert_axis)
            out[k] = sharded(mesh, (expert_axis,))
        else:
            out[k] = Replicated()
    return out


def transformer_expert_shardings(mesh: Mesh, params,
                                 expert_axis: str = EXPERT_AXIS):
    """A whole model's layouts (``DistriOptimizer``'s ``param_shardings``
    for ``transformer_train --ep N``): every 3-d leaf named ``w_in`` or
    ``w_out`` over the expert axis, everything else replicated."""
    from bigdl_tpu_torch.parallel.tensor_parallel import map_with_paths

    def spec(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name in ("w_in", "w_out") and len(leaf.shape) == 3:
            _check_expert_divisible(name, leaf.shape[0], mesh, expert_axis)
            return sharded(mesh, (expert_axis,))
        return Replicated()

    return map_with_paths(params, spec)
