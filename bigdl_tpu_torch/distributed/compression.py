"""Compressed gradient exchange: a reduced-precision sum over the data
axis with f32 master accumulation (counterpart of
bigdl_tpu/distributed/compression.py).

The reference moved every gradient as an ``FP16CompressedTensor``: f32
values truncated to their upper 16 bits on the wire, decompressed and
accumulated in f32 (AllReduceParameter.scala:155-328).  The JAX package's
step computes each replica's gradients in a fully manual ``shard_map``,
casts them to the wire type (bf16 by default, round to nearest; fp8 on
request), ``psum``s them at that width and divides the f32 upcast by the
data degree before the clipping and the update.  Parameters and
optimizer state stay f32 and replicated (no ZeRO-1) and there is no
gradient accumulation.

The port's step is the same, one process per device:

* **BatchNorm is per replica.**  The data axis is manual inside JAX's
  step, so its kernels' statistics are not ``psum``-ed
  (``ops/pallas/partition.py:27-29``): each replica normalises with its
  own rows' statistics.  The port runs the forward and backward outside
  ``kernel_mesh_scope`` to match (ROADMAP's reference quirks);
* **the wire sum** is an all-gather of every rank's wire-type bits,
  summed in rank order in the accumulator XLA's CPU ``psum`` uses (f32
  for bf16, f16 for fp8; measured against JAX at 2 and 4 devices) and
  rounded once to the wire type.  Every wire type takes this route on
  both backends: NCCL's bf16 all-reduce rounds at every ring hop, and
  neither NCCL through torch nor gloo reduces fp8;
* the new running statistics are averaged over the same wire (each
  replica's, cast to the wire type, summed, upcast and divided), and the
  loss is averaged in f32.

:func:`fp16_compress` is the reference's host codec, bit for bit.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.optimizer import CompiledTrainStep, make_train_step
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, plan_info
from bigdl_tpu_torch.telemetry import programs

__all__ = ["WIRE_DTYPES", "build_compressed_dp_train_step",
           "fp16_compress", "wire_sum"]

#: wire types the sum may run at
WIRE_DTYPES: Dict[str, torch.dtype] = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_WIRE_NAME = {torch.bfloat16: "bfloat16",
              torch.float8_e4m3fn: "float8_e4m3fn",
              torch.float8_e5m2: "float8_e5m2"}
#: the type a wire type is summed in
_ACCUM = {torch.bfloat16: torch.float32, torch.float8_e4m3fn: torch.float16,
          torch.float8_e5m2: torch.float16}


def fp16_compress(arr: np.ndarray) -> np.ndarray:
    """The reference's host codec: FP16CompressedTensor's truncation,
    the upper 16 bits of each f32 word kept (sign, 8-bit exponent, 7-bit
    mantissa: bf16's payload), as a numpy round trip.  The wire cast
    rounds to nearest instead, which tightens the same 2^-8 relative
    bound."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    u = a.view(np.uint32) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _resolve_wire(wire_dtype) -> torch.dtype:
    if isinstance(wire_dtype, torch.dtype):
        if wire_dtype not in _WIRE_NAME:
            raise ValueError(f"unknown wire dtype {wire_dtype}")
        return wire_dtype
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r} "
                         f"(have {sorted(WIRE_DTYPES)})")
    return WIRE_DTYPES[wire_dtype]


def wire_sum(tensors: Sequence[torch.Tensor], mesh: Mesh,
             wire: torch.dtype) -> List[torch.Tensor]:
    """Each tensor cast to ``wire`` and summed over the data axis at that
    width: one all-gather of the wire bytes, a sum in rank order in the
    accumulator type, one rounding to ``wire``.  Returned in ``wire``."""
    acc_t = _ACCUM[wire]
    narrow = [t.to(wire) for t in tensors]
    # the bits travel as bytes: gloo gathers no 16-bit integer type
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in narrow])
    every = comm.all_gather_rows(flat, mesh).view(
        mesh.shape[DATA_AXIS], flat.numel()).view(wire)
    acc = every[0].to(acc_t)
    for r in range(1, every.shape[0]):
        acc = acc + every[r].to(acc_t)
    total = acc.to(wire)
    out, off = [], 0
    for t in narrow:
        out.append(total[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


class CompressedDataParallel:
    """The parts of the compressed step for ``make_train_step(...,
    data_parallel=)``: no scope (BatchNorm per replica), the gradients
    and running statistics averaged over the wire, the loss in f32, the
    update as it is (replicated state)."""

    zero1 = False

    def __init__(self, mesh: Mesh, wire: torch.dtype):
        self.mesh = mesh
        self.wire = wire
        self.n = mesh.shape[DATA_AXIS]

    def scope(self):
        return contextlib.nullcontext()

    def reduce(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor]):
        keys = list(grads)
        summed = wire_sum([grads[k] for k in keys], self.mesh, self.wire)
        grads = {k: (s.float() / self.n).to(grads[k].dtype)
                 for k, s in zip(keys, summed)}
        # the scalar loss at full precision
        loss = comm.all_reduce_sum_(loss.float().clone(), self.mesh) / self.n
        # the per-replica running statistics averaged over the wire
        keys = [k for k, v in state.items() if v.is_floating_point()]
        if keys:
            summed = wire_sum([state[k] for k in keys], self.mesh, self.wire)
            state = dict(state)
            state.update({k: s.to(state[k].dtype) / self.n
                          for k, s in zip(keys, summed)})
        return loss, grads, state

    def update(self, method: OptimMethod, grads, opt_state, params, lr,
               step):
        return method.update(grads, opt_state, params, lr, step)


def build_compressed_dp_train_step(
        model: torch.nn.Module, criterion: Criterion,
        optim_methods: Dict[str, OptimMethod], mesh: Mesh,
        wire_dtype="bf16", grad_clip_const=None, grad_clip_norm=None,
        aux_loss_weight: float = 0.01, *, numerics=None):
    """The compressed data-parallel train step and its placement (JAX's
    ``(jitted_step, placement)``): a :class:`CompiledTrainStep` (one
    CUDA graph under NCCL, eager under gloo) called with this rank's
    rows of the batch and whole, replicated trees.  ``placement`` holds
    the plan and ``wire_dtype`` (the type's name).  The auxiliary losses
    of the model's state (the MoE load balance) join the loss times
    ``aux_loss_weight`` (compression.py:139-140).  ``donate`` and
    ``template_variables`` of the JAX function are ``jit`` plumbing with
    no counterpart here (the step updates its trees in place), so
    ``numerics`` is keyword-only: a positional call meant for JAX raises
    instead of binding it to another parameter.  A mesh with any degree
    above 1 but the data axis's raises ``ValueError``."""
    wire = _resolve_wire(wire_dtype)
    info = plan_info(mesh)
    for axis, deg in info.degrees:
        if axis != DATA_AXIS and deg > 1:
            raise ValueError("compressed allreduce step is data-parallel "
                             f"only; mesh declares {axis}={deg}")
    dp = CompressedDataParallel(mesh, wire)
    step = CompiledTrainStep(
        make_train_step(model, criterion, optim_methods, grad_clip_const,
                        grad_clip_norm, aux_loss_weight=aux_loss_weight,
                        numerics=numerics, data_parallel=dp),
        capture=mesh.backend == "nccl")
    step.program = "compressed_dp_train_step"
    programs.get_program_registry().annotate(
        step.program, wire_dtype=_WIRE_NAME[wire],
        ndata=mesh.shape[DATA_AXIS], donate=True)
    placement: Dict[str, Any] = {
        "plan": info, "wire_dtype": _WIRE_NAME[wire],
        "data_parallel": dp}
    return step, placement
