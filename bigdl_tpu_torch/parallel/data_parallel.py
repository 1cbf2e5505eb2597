"""Data-parallel (+ ZeRO-1) training over the mesh (counterpart of
bigdl_tpu/parallel/data_parallel.py).

The JAX package states the schedule declaratively and GSPMD emits it;
the port's step calls the same collectives itself, one process per
device:

* each rank runs the forward and backward on its rows of the global
  batch, inside :func:`~bigdl_tpu_torch.ops.partition.kernel_mesh_scope`,
  so every BatchNorm (the kernels' statistics and the unfused layer's
  means) normalises with the global batch's statistics;
* the loss and the gradients are summed over the data axis in one
  collective and divided by its degree: the global batch's mean, as
  JAX's mean over the sharded batch is (the per-rank backward already
  summed the statistics' cotangents over the ranks, so only this pairing
  gives the global-batch gradient);
* the gradients are clipped whole, then with ``zero1=True`` each rank
  updates only its rows of every leaf that :func:`shard_leading_dim`
  splits (its optimizer state holds those rows alone) and the fresh rows
  are gathered back into whole parameters; the methods' per-leaf norms
  (LARS's trust ratio) are taken from the whole leaves first.

Under NCCL the step is one CUDA graph, collectives included
(``CompiledTrainStep``); under gloo, whose collectives are host calls, it
runs eagerly (``capture=False``): a rule on the backend, taken before
the first step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.ops.partition import kernel_mesh_scope
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.optimizer import (CompiledTrainStep,
                                             _eval_forward, make_train_step)
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, RowShard,
                                           _slice20, plan_info,
                                           shard_leading_dim)

__all__ = ["DataParallel", "build_dp_eval_step", "build_dp_train_step",
           "warm_communicator"]


def warm_communicator(mesh: Mesh):
    """One collective on the data group, so a lazily made communicator
    exists before a CUDA graph capture."""
    t = torch.zeros(1, device=mesh.device)
    comm.all_reduce_sum_(t, mesh)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class DataParallel:
    """The data-parallel parts of a train step over ``mesh``'s data axis
    (``make_train_step(..., data_parallel=)``): the scope of the forward
    and backward, the reduction of the loss and gradients, and each
    method's update, over row shards with ``zero1``."""

    def __init__(self, mesh: Mesh, zero1: bool = True):
        for axis, deg in plan_info(mesh).degrees:
            if axis != DATA_AXIS and deg > 1:
                raise _slice20(f"a data-parallel step over {axis}={deg}")
        self.mesh = mesh
        self.zero1 = zero1
        self.n = mesh.shape[DATA_AXIS]

    def scope(self):
        return kernel_mesh_scope(self.mesh)

    def reduce(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor]):
        """The loss and gradients averaged over the data axis: summed in
        one collective per dtype, then divided by its degree.  The new
        model state is returned as it is: the global batch's statistics
        leave every rank's running statistics equal."""
        keys = list(grads)
        summed = comm.reduce_leaves([loss] + [grads[k] for k in keys],
                                    self.mesh)
        return (summed[0] / self.n,
                {k: g / self.n for k, g in zip(keys, summed[1:])}, state)

    def layout(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Each leaf's ZeRO-1 layout (``RowShard`` or ``Replicated``);
        every leaf ``Replicated`` without ``zero1``."""
        spec = shard_leading_dim(self.mesh, tree)
        if not self.zero1:
            return {k: None for k in tree}
        return {k: (s if isinstance(s, RowShard) else None)
                for k, s in spec.items()}

    def local_state(self, state: Dict[str, Dict[str, torch.Tensor]],
                    params: Dict[str, torch.Tensor]):
        """A method's state ``{slot: {key: tensor}}``, built over whole
        ``params``, cut to this rank's rows of each leaf ZeRO-1 shards
        (contiguous copies)."""
        parts = self.layout(params)
        return {slot: {k: _rows(v, parts.get(k)).clone()
                       for k, v in flat.items()}
                for slot, flat in state.items()}

    def update(self, method: OptimMethod, grads, opt_state, params, lr,
               step):
        """``method.update`` of this rank's rows, the new rows gathered
        back into whole parameters (ZeRO-1); the plain update without
        ``zero1``."""
        if not self.zero1:
            return method.update(grads, opt_state, params, lr, step)
        norms = method.leaf_norms(grads, params)
        parts = self.layout(params)
        kw = {} if norms is None else {"norms": norms}
        new, new_state = method.update(
            {k: _rows(g, parts[k]) for k, g in grads.items()}, opt_state,
            {k: _rows(p, parts[k]) for k, p in params.items()}, lr, step,
            **kw)
        sharded = [k for k in new if parts[k] is not None]
        if sharded:
            whole = comm.gather_leaves([new[k] for k in sharded], self.mesh)
            new = dict(new)
            new.update(zip(sharded, whole))
        return new, new_state


def _rows(t: torch.Tensor, part: Optional[RowShard]) -> torch.Tensor:
    if part is None:
        return t
    lo, hi = part.rows(t.shape[0])
    return t[lo:hi]


def build_dp_train_step(model: torch.nn.Module, criterion: Criterion,
                        optim_methods: Dict[str, OptimMethod], mesh: Mesh,
                        zero1: bool = True, grad_clip_const=None,
                        grad_clip_norm=None,
                        compute_dtype: Optional[torch.dtype] = None,
                        param_shardings: Optional[Any] = None,
                        seq_dim: Optional[int] = None,
                        accum_steps: int = 1, numerics=None):
    """The data-parallel train step and its placement (JAX's
    ``(jitted_step, placement)``).

    The step is a :class:`CompiledTrainStep` over
    ``make_train_step(..., data_parallel=DataParallel(mesh, zero1))``:
    captured in one CUDA graph under NCCL, eager under gloo.  It is
    called as the local step is, with this rank's rows of the batch
    (``put_batch``) and this rank's optimizer state
    (``placement["data_parallel"].local_state(state, params)`` cuts a
    method's whole state to it).  ``placement`` also carries each
    parameter's ZeRO-1 layout (``"opt_states"``) and the mesh's plan.
    ``param_shardings`` and ``seq_dim`` are port slice 20."""
    if param_shardings is not None or seq_dim is not None:
        raise _slice20("param_shardings / seq_dim")
    dp = DataParallel(mesh, zero1)
    step = CompiledTrainStep(
        make_train_step(model, criterion, optim_methods, grad_clip_const,
                        grad_clip_norm, compute_dtype,
                        accum_steps=accum_steps, numerics=numerics,
                        data_parallel=dp),
        capture=mesh.backend == "nccl")
    step.program = "dp_train_step"
    warm_communicator(mesh)
    params = dict(model.named_parameters())
    placement = {
        "opt_states": dp.layout(params),
        "plan": plan_info(mesh),
        "data_parallel": dp,
    }
    return step, placement


def build_dp_eval_step(model: torch.nn.Module, mesh: Mesh,
                       param_shardings=None,
                       seq_dim: Optional[int] = None) -> Callable:
    """The sharded evaluation forward: ``fwd(params, state, x)`` runs the
    compiled forward (``evaluate``'s) on this rank's rows ``x`` and
    gathers every rank's output rows in rank order, so every rank holds
    the global batch's outputs."""
    if param_shardings is not None or seq_dim is not None:
        raise _slice20("param_shardings / seq_dim")

    def fwd(params, state, x):
        out = _eval_forward(model, params, state, x)
        if isinstance(out, (list, tuple)):
            return type(out)(comm.all_gather_rows(o, mesh) for o in out)
        return comm.all_gather_rows(out, mesh)

    return fwd
