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

With ``param_shardings`` (tensor, pipeline and expert layouts,
``parallel/tensor_parallel.py``) each rank's step runs on its shards of
the parameters, the layers' own collectives in the forward and backward;
the gradients are still averaged over the data axis only, since the
conjugate collectives leave every rank of the other axes the whole
gradient of its shard; a leaf a rank holds whole takes rank 0 of its
``model``/``expert``/``pipe`` line's gradient, so the replicas stay one
value.  With ``seq_dim`` the batch is split over the
``seq`` axis too, each rank's loss is its part's mean, and the loss and
gradients are averaged over ``data`` and ``seq``.  The clipping norm
sums the squares of a sharded leaf over its axes and counts a
replicated one once; ZeRO-1 splits each rank's shard over ``data``.

Under NCCL the step is one CUDA graph, collectives included
(``CompiledTrainStep``), unless the mesh splits the sequence or the
pipeline, whose all-to-alls and point-to-point hops run eagerly; under
gloo, whose collectives are host calls, it always runs eagerly
(``capture=False``): a rule on the backend and the mesh, taken before
the first step (:func:`captures`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.ops.partition import kernel_mesh_scope
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.optimizer import (CompiledTrainStep, _eval_forward,
                                             _sq_norm, make_train_step)
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                           MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                                           Mesh, Replicated, RowShard,
                                           plan_info, shard_leading_dim)

__all__ = ["DataParallel", "build_dp_eval_step", "build_dp_train_step",
           "captures", "flat_layouts", "warm_communicator"]


def captures(mesh: Mesh) -> bool:
    """The capture rule: one CUDA graph under NCCL, except where the mesh
    splits the sequence or the pipeline (all-to-all and point-to-point
    collectives run eagerly); eager under gloo."""
    return (mesh.backend == "nccl" and mesh.shape.get(SEQ_AXIS, 1) == 1
            and mesh.shape.get(PIPE_AXIS, 1) == 1)


def flat_layouts(model: torch.nn.Module, shardings) -> Dict[str, Any]:
    """Each parameter's layout keyed as ``named_parameters``, from a flat
    or nested tree of layouts (``Replicated`` where it has none)."""
    from bigdl_tpu_torch.parallel.tensor_parallel import _layout_of

    return {k: _layout_of(shardings, k) for k, _ in model.named_parameters()}


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

    def __init__(self, mesh: Mesh, zero1: bool = True,
                 layouts: Optional[Dict[str, Any]] = None,
                 seq_dim: Optional[int] = None):
        self.mesh = mesh
        self.zero1 = zero1
        self.layouts = layouts or {}
        self.seq_dim = seq_dim
        self.axes = (DATA_AXIS,) + ((SEQ_AXIS,) if seq_dim is not None
                                    else ())
        self.n = 1
        for axis in self.axes:
            self.n *= mesh.shape[axis]

    def scope(self):
        return kernel_mesh_scope(self.mesh, self.seq_dim)

    def reduce(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor]):
        """The loss and gradients averaged over the data axis (and the
        seq axis with ``seq_dim``): summed in one collective per dtype and
        axis, then divided by the ranks.  The new model state is returned
        as it is: the global batch's statistics leave every rank's running
        statistics equal."""
        keys = list(grads)
        summed = comm.reduce_leaves([loss] + [grads[k] for k in keys],
                                    self.mesh, self.axes)
        grads = {k: g / self.n for k, g in zip(keys, summed[1:])}
        self._sync_replicas(grads)
        return summed[0] / self.n, grads, state

    def _sync_replicas(self, grads: Dict[str, torch.Tensor]):
        """Every rank of a ``model``, ``expert`` or ``pipe`` line holds a
        leaf it is not split over whole and computes its gradient
        redundantly; rank 0 of the line's gradient is copied to the
        others (one collective per axis and dtype), so the replicas stay
        one value, as JAX's replicated arrays are, whatever an op's
        nondeterministic order (an embedding's scatter-add) did."""
        for axis in (MODEL_AXIS, EXPERT_AXIS, PIPE_AXIS):
            if self.mesh.shape.get(axis, 1) == 1:
                continue
            keys = [k for k in grads if axis not in self.layout_of(k).axes]
            if keys:
                comm.broadcast_leaves([grads[k] for k in keys], self.mesh,
                                      axis=axis)

    def layout_of(self, key: str):
        return self.layouts.get(key, Replicated())

    def sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The squared global L2 norm: each leaf's squares summed over the
        axes it is split over, a replicated leaf's counted once."""
        groups: Dict[tuple, Dict[str, torch.Tensor]] = {}
        for k, g in grads.items():
            groups.setdefault(self.layout_of(k).axes, {})[k] = g
        total = None
        for axes, part in groups.items():
            sq = _sq_norm(part)
            for axis in axes:
                sq = comm.all_reduce_sum_(sq.clone(), self.mesh, axis)
            total = sq if total is None else total + sq
        return total

    def local_params(self, model: torch.nn.Module
                     ) -> Dict[str, torch.Tensor]:
        """This rank's shard of each of ``model``'s parameters (detached
        copies)."""
        from bigdl_tpu_torch.parallel.tensor_parallel import shard_variables

        return shard_variables({k: p.detach() for k, p in
                                model.named_parameters()}, self.mesh,
                               self.layouts)

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
                        seq_dim: Optional[int] = None, *,
                        accum_steps: int = 1, numerics=None):
    """The data-parallel train step and its placement (JAX's
    ``(jitted_step, placement)``).

    The step is a :class:`CompiledTrainStep` over
    ``make_train_step(..., data_parallel=DataParallel(mesh, zero1,
    layouts, seq_dim))``, captured or eager by :func:`captures`.  It is
    called as the local step is, with this rank's part of the batch
    (``put_batch(mesh, x, seq_dim)``), this rank's shard of each
    parameter (``placement["data_parallel"].local_params(model)``) and
    this rank's optimizer state (``placement["data_parallel"]
    .local_state(state, params)`` cuts a method's state built over the
    local parameters to its ZeRO-1 rows).  ``placement`` also carries
    each parameter's layout (``"params"``), its ZeRO-1 layout
    (``"opt_states"``) and the mesh's plan.  JAX's ``donate`` and
    ``template_variables`` (``jit`` plumbing) have no counterpart, so
    ``accum_steps`` and ``numerics`` are keyword-only."""
    layouts = flat_layouts(model, param_shardings)
    dp = DataParallel(mesh, zero1, layouts, seq_dim)
    step = CompiledTrainStep(
        make_train_step(model, criterion, optim_methods, grad_clip_const,
                        grad_clip_norm, compute_dtype,
                        accum_steps=accum_steps, numerics=numerics,
                        data_parallel=dp),
        capture=captures(mesh))
    step.program = "dp_train_step"
    warm_communicator(mesh)
    params = {k: torch.empty(layouts[k].local_shape(p.shape))
              for k, p in model.named_parameters()}
    placement = {
        "params": layouts,
        "opt_states": dp.layout(params),
        "plan": plan_info(mesh),
        "data_parallel": dp,
    }
    return step, placement


def build_dp_eval_step(model: torch.nn.Module, mesh: Mesh,
                       param_shardings=None,
                       seq_dim: Optional[int] = None) -> Callable:
    """The sharded evaluation forward: ``fwd(params, state, x)`` runs the
    forward on this rank's part ``x`` (the compiled forward,
    ``evaluate``'s; with ``param_shardings`` or ``seq_dim`` an eager one
    in the mesh's scope, over this rank's shards) and gathers every
    rank's outputs (the sequence parts over ``seq``, then the rows in
    rank order), so every rank holds the global batch's outputs."""
    sharded = param_shardings is not None or seq_dim is not None

    def gather(o):
        if seq_dim is not None:
            o = comm.all_gather(o, mesh, SEQ_AXIS, seq_dim)
        return comm.all_gather_rows(o, mesh)

    def forward(params, state, x):
        if not sharded:
            return _eval_forward(model, params, state, x)
        with torch.no_grad(), kernel_mesh_scope(mesh, seq_dim):
            return functional_call(model, {**params, **state}, (x,))

    def fwd(params, state, x):
        out = forward(params, state, x)
        if isinstance(out, (list, tuple)):
            return type(out)(gather(o) for o in out)
        return gather(out)

    return fwd
