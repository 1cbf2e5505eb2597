"""Pipeline parallelism: GPipe-style microbatched stages over the
``pipe`` mesh axis (counterpart of bigdl_tpu/parallel/pipeline.py).

A homogeneous trunk of ``S`` stages keeps its parameters stacked on a
leading dim of ``S``, split over the ``pipe`` axis: each rank holds its
stage's slice (leading dim 1).  :func:`pipeline_apply` runs JAX's
schedule on every rank, ``M + S - 1`` ticks: at tick ``t`` stage 0 takes
microbatch ``t`` (row ``j`` of the batch belongs to microbatch ``j %
M``), every other stage the activation its predecessor sent at tick
``t - 1`` (``comm.ppermute``, non-cyclic; its backward sends the
cotangent back), and the last stage keeps microbatch ``t - (S - 1)``.
Every stage computes every tick, bubbles included, as the JAX schedule
does: so each tick's hop is one collective all ranks join, forward and
backward, in the same order.  The last stage's buffer is summed over
``pipe`` (``comm.reduce_from``: each stage gets its cotangent once, not
``S`` times) and the input enters with ``comm.copy_to`` (the embedding
before the trunk gets stage 0's gradient on every stage).  ``remat``
recomputes each tick in the backward (``torch.utils.checkpoint``), the
step's mesh scope captured for the recompute.

:class:`PipelinedLM` is the embed / trunk / unembed split of the LM with
JAX's trees (``{"head", "trunk", "tail"}``, the trunk's MoE load balance
at ``trunk/aux_loss``), and :meth:`PipelinedLM.param_shardings` its
layouts: the trunk over ``pipe``, composed with tensor rules (shifted
one dim) and with expert banks over ``expert``.  Under ``pp x tp`` and
``pp x ep`` the stage's layers run their shards as they do outside the
pipeline, their collectives on the ``model``/``expert`` groups inside
each tick.
"""
from __future__ import annotations

import copy
import logging
from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint
from torch.func import functional_call

from bigdl_tpu_torch.nn.module import (Container, Module, Sequential,
                                       _forward_takes_rng, call_child,
                                       split_rng)
from bigdl_tpu_torch.ops.partition import (current_kernel_mesh,
                                           current_seq_dim,
                                           kernel_mesh_scope)
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import (PIPE_AXIS, Mesh, Replicated,
                                           sharded)

logger = logging.getLogger("bigdl_tpu_torch.parallel")

__all__ = ["PIPE_AXIS", "PipelinedLM", "build_pipeline_train_step",
           "init_stacked_params", "pipeline_apply",
           "pipelined_transformer_lm", "stacked_param_sharding"]


def init_stacked_params(stage: Module, num_stages: int,
                        generator: Optional[torch.Generator] = None,
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, torch.Tensor]:
    """``stage``'s parameters initialised ``num_stages`` times from
    ``generator`` (the port's counterpart of JAX's key), in ``dtype``,
    stacked on a new dim 0: ``{name: (S, ...)}``."""
    per = []
    for _ in range(num_stages):
        stage.initialize(generator)
        per.append({k: p.detach().to(dtype, copy=True)
                    for k, p in stage.named_parameters()})
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def stacked_param_sharding(mesh: Mesh, stacked_params, axis: str = PIPE_AXIS):
    """Each stacked leaf's layout: stage ``i``'s slice on pipe rank
    ``i``."""
    from bigdl_tpu_torch.parallel.tensor_parallel import map_with_paths

    return map_with_paths(stacked_params,
                          lambda path, leaf: sharded(mesh, (axis,)))


def pipeline_apply(stage: Module, mesh: Mesh, num_microbatches: int,
                   axis: str = PIPE_AXIS, data_axis: Optional[str] = None,
                   training: bool = False, remat: bool = True,
                   collect_aux: bool = False) -> Callable:
    """``f(stacked_params, x, rng=None) -> y`` (``(y, aux)`` with
    ``collect_aux``) running the schedule of the module's docstring on
    this rank's stage of ``stacked_params`` (its slice ``{name: (1,
    ...)}``, or whole ``(S, ...)`` leaves) and this rank's rows ``x``.  A batch that cannot carry ``num_microbatches``
    over the data ranks clamps the count for the call, with JAX's
    warning (a bigger bubble), and raises when no count fits.  ``aux``
    is the stages' ``aux_loss`` summed over active ticks and stages,
    divided by the microbatches and averaged over ``data_axis``."""
    num_stages = mesh.shape.get(axis, 1)
    m_req = num_microbatches
    rng_kw = _forward_takes_rng(type(stage))

    def make_tick(scope_mesh, seq):
        def stage_tick(params, inp, key):
            bufs = {k: torch.zeros_like(b, device=inp.device)
                    for k, b in stage.named_buffers()}
            with kernel_mesh_scope(scope_mesh, seq):
                out = functional_call(stage, {**params, **bufs}, (inp,),
                                      {"rng": key} if rng_kw else {})
            from bigdl_tpu_torch.optim.optimizer import _aux_losses

            aux = torch.zeros((), dtype=torch.float32, device=inp.device)
            for a in _aux_losses(bufs):  # the stage's MoE load balance
                aux = aux + a.float()
            return out, aux

        if not remat:
            return stage_tick

        def checkpointed(params, inp, key):
            return torch.utils.checkpoint.checkpoint(
                stage_tick, params, inp, key, use_reentrant=False,
                preserve_rng_state=False)

        return checkpointed

    def f(stacked_params, x, rng=None):
        stage.train(training)
        dd = mesh.shape.get(data_axis, 1) if data_axis else 1
        b = x.shape[0] * dd  # the global batch
        m = next((d for d in range(min(m_req, b), 0, -1)
                  if b % d == 0 and (b // d) % dd == 0), None)
        if m is None:
            raise ValueError(
                f"pipeline batch {b} does not divide over the "
                f"data-parallel degree {dd}; drop or pad ragged batches")
        if m != m_req:
            logger.warning(
                "pipeline: clamping microbatches %d -> %d for batch %d "
                "over %d data shards (bigger bubble this call)",
                m_req, m, b, dd)
        tick = make_tick(current_kernel_mesh(), current_seq_dim())
        stage_id = mesh.rank(axis) if num_stages > 1 else 0
        # this rank's slice, or its stage of whole stacked leaves
        params = {k: v[stage_id] if v.shape[0] > 1 else v[0]
                  for k, v in stacked_params.items()}
        first = torch.tensor(stage_id == 0, device=x.device)
        last = torch.tensor(stage_id == num_stages - 1, device=x.device)
        x = comm.copy_to(x, mesh, axis)
        xm = x.reshape((x.shape[0] // m, m) + tuple(x.shape[1:]))
        carry = torch.zeros_like(xm[:, 0])
        outs = [None] * m
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        ticks = m + num_stages - 1
        for t in range(ticks):
            feed = xm[:, t] if t < m else torch.zeros_like(carry)
            inp = torch.where(first, feed, carry)
            key = (split_rng(split_rng(rng, t), stage_id)
                   if rng is not None else None)
            out, aux = tick(params, inp, key)
            # stage s holds microbatch t - s at tick t: others are bubbles
            if stage_id <= t < stage_id + m:
                aux_sum = aux_sum + aux
            mb = t - (num_stages - 1)
            if mb >= 0:  # the last stage keeps it; zeros elsewhere
                outs[mb] = torch.where(last, out, torch.zeros_like(out))
            if t + 1 < ticks:
                carry = comm.ppermute(out, mesh, axis, cyclic=False)
        y = comm.reduce_from(torch.stack(outs, 1), mesh, axis)
        y = y.reshape(x.shape)
        aux = comm.reduce_from(aux_sum, mesh, axis) / m
        if data_axis and dd > 1:
            aux = comm.all_reduce_sum(aux, mesh, data_axis) / dd
        return (y, aux) if collect_aux else y

    return f


def _stacked(stage: Module, num_stages: int) -> Module:
    """The trunk's storage: ``stage``'s module tree holding ``(S, ...)``
    parameters and no buffers (the schedule runs ``stage`` itself)."""
    trunk = copy.deepcopy(stage)
    for mod in trunk.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(torch.zeros(
                    (num_stages,) + tuple(p.shape), dtype=p.dtype))
        mod._buffers.clear()
    return trunk


class PipelinedLM(Container):
    """Head -> pipelined trunk -> tail (see the module's docstring).
    ``head``/``tail`` run on every pipe rank; ``tied_embed_path`` (e.g.
    ``("embed", "weight")``) reads the head's embedding for weight-tied
    logits; ``collect_aux`` surfaces the stages' MoE loss at
    ``trunk.aux_loss``."""

    def __init__(self, head: Module, stage: Module, tail: Optional[Module],
                 mesh: Mesh, num_microbatches: int, axis: str = PIPE_AXIS,
                 data_axis: Optional[str] = None,
                 tied_embed_path: Optional[tuple] = None,
                 embed_scale: Optional[float] = None, remat: bool = True,
                 collect_aux: bool = False, name: Optional[str] = None):
        super().__init__(name=name)
        self.mesh = mesh
        self.num_stages = mesh.shape.get(axis, 1)
        self.num_microbatches = num_microbatches
        self.axis = axis
        self.data_axis = data_axis
        self.tied_embed_path = tied_embed_path
        self.embed_scale = embed_scale
        self.remat = remat
        self.collect_aux = collect_aux
        self.__dict__["stage"] = stage  # the template, not a child
        self._register_child("head", head)
        trunk = _stacked(stage, self.num_stages)
        if collect_aux:
            trunk.register_buffer("aux_loss", torch.zeros(()))
        self._register_child("trunk", trunk)
        if tail is not None:
            self._register_child("tail", tail)
        self._fwd_cache: dict = {}

    @property
    def tail_module(self) -> Optional[Module]:
        return self._modules.get("tail")

    def initialize(self, generator: Optional[torch.Generator] = None
                   ) -> "PipelinedLM":
        """The head, each stage (stacked in order) and the tail from
        ``generator``."""
        self.head.initialize(generator)
        stacked = init_stacked_params(self.stage, self.num_stages,
                                      generator)
        with torch.no_grad():
            for k, p in self.trunk.named_parameters():
                p.copy_(stacked[k])
        if self.tail_module is not None:
            self.tail_module.initialize(generator)
        return self

    def _fwd(self, training: bool):
        if training not in self._fwd_cache:
            self._fwd_cache[training] = pipeline_apply(
                self.stage, self.mesh, self.num_microbatches, self.axis,
                self.data_axis, training=training, remat=self.remat,
                collect_aux=True)
        return self._fwd_cache[training]

    def param_shardings(self, mesh: Optional[Mesh] = None, tp_rules=None,
                        expert_axis: Optional[str] = None) -> dict:
        """Each parameter's layout, keyed as ``named_parameters``: the
        head and tail replicated (under ``tp_rules``, the rules' specs),
        each trunk leaf ``P("pipe", ...)``: the tensor rules shifted one
        dim under the stacked dim, or with ``expert_axis`` the stacked
        banks (4-d ``w_in``/``w_out``) ``P("pipe", expert_axis)``."""
        from bigdl_tpu_torch.parallel.tensor_parallel import (
            _compile, match_rule_spec)

        mesh = mesh or self.mesh
        compiled = _compile(tp_rules or ())
        out = {}
        for key, p in self.named_parameters():
            path = "/" + key.replace(".", "/")
            name = path.rsplit("/", 1)[-1]
            if key.startswith("trunk."):
                if expert_axis and name in ("w_in", "w_out") \
                        and p.dim() == 4:
                    if p.shape[1] % mesh.shape[expert_axis]:
                        raise ValueError(
                            f"{path}: {p.shape[1]} experts do not divide "
                            f"over the {mesh.shape[expert_axis]}-way "
                            f"'{expert_axis}' mesh axis")
                    out[key] = sharded(mesh, (self.axis, expert_axis))
                    continue
                spec = match_rule_spec(mesh, path, p, compiled, shift=1)
                out[key] = sharded(mesh, (self.axis,) + tuple(spec or ()))
            else:
                spec = match_rule_spec(mesh, path, p, compiled)
                out[key] = (sharded(mesh, spec) if spec is not None
                            else Replicated())
        return out

    def forward(self, x, rng=None):
        h = call_child(self.head, x, rng)
        if self.embed_scale is not None:
            h = h * torch.tensor(self.embed_scale, dtype=h.dtype,
                                 device=h.device)
        trunk = dict(self.trunk.named_parameters())
        h, aux = self._fwd(self.training)(
            trunk, h, split_rng(rng, 1) if rng is not None else None)
        if self.collect_aux:
            buf = self.trunk.aux_loss
            buf.detach_()  # no graph kept from an earlier forward
            buf.copy_(aux)
        if self.tail_module is not None:
            h = call_child(self.tail_module, h, rng, 2)
        if self.tied_embed_path is not None:
            from bigdl_tpu_torch.nn.attention import tied_logits

            embed = self.head
            for k in self.tied_embed_path[:-1]:
                embed = getattr(embed, k)
            w = getattr(embed, self.tied_embed_path[-1])
            h = tied_logits(h, w, getattr(embed, "n_index", w.shape[0]))
        return h


def pipelined_transformer_lm(
        vocab_size: int, hidden_size: int, num_heads: int, filter_size: int,
        num_layers: int, mesh: Mesh, num_microbatches: int,
        dropout: float = 0.0, causal: bool = True,
        use_flash: Optional[bool] = None, axis: str = PIPE_AXIS,
        data_axis: Optional[str] = None, moe_experts: int = 0
) -> PipelinedLM:
    """The pipelined ``nn.Transformer`` (the same function of the same
    weights): embed, ``sqrt(hidden)`` scale, positions and dropout in the
    head, ``num_layers / S`` blocks a stage (``block{i}``), the final
    LayerNorm as the tail, weight-tied logits; ``moe_experts`` swaps the
    FFNs for Switch MoE banks.  What ``transformer_train --pp N``
    builds."""
    import math

    from bigdl_tpu_torch.nn.attention import PositionEncode, TransformerLayer
    from bigdl_tpu_torch.nn.dropout import Dropout
    from bigdl_tpu_torch.nn.embedding import LookupTable
    from bigdl_tpu_torch.nn.init import RandomNormal
    from bigdl_tpu_torch.nn.norm import LayerNormalization
    from bigdl_tpu_torch.nn.reshape import MulConstant

    num_stages = mesh.shape.get(axis, 1)
    assert num_layers % num_stages == 0, (
        f"num_layers={num_layers} must divide over {num_stages} pipe "
        "stages")
    per_stage = num_layers // num_stages
    head = Sequential(
        LookupTable(vocab_size, hidden_size,
                    weight_init=RandomNormal(0.0, hidden_size ** -0.5),
                    name="embed"),
        MulConstant(math.sqrt(hidden_size), name="scale"),
        PositionEncode(name="pos"),
        Dropout(dropout, name="drop"))
    stage = Sequential(*[
        TransformerLayer(hidden_size, num_heads, filter_size,
                         attn_dropout=dropout, ffn_dropout=dropout,
                         causal=causal, use_flash=use_flash,
                         moe_experts=moe_experts, name=f"block{i}")
        for i in range(per_stage)])
    tail = LayerNormalization(hidden_size, name="ln_f")
    return PipelinedLM(head, stage, tail, mesh, num_microbatches, axis=axis,
                       data_axis=data_axis,
                       tied_embed_path=("embed", "weight"),
                       collect_aux=moe_experts > 0)


def build_pipeline_train_step(stage: Module, mesh: Mesh,
                              num_microbatches: int, loss_fn: Callable,
                              axis: str = PIPE_AXIS, optim_method=None,
                              lr: float = 1e-2):
    """A homogeneous trunk's train step with a pluggable method (SGD(lr)
    by default): ``step(stacked_params, opt_state, x, targets,
    step_idx=1, lr=None) -> (params, opt_state, loss)`` over this rank's
    stage slice, and ``init(params)``."""
    from bigdl_tpu_torch.optim.optim_method import SGD

    method = optim_method if optim_method is not None else SGD(lr)
    fwd = pipeline_apply(stage, mesh, num_microbatches, axis, training=True)

    def init(params):
        return method.init_state(params)

    def step(params, opt_state, x, targets, step_idx=1, lr=None):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(fwd(leaves, x), targets)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        rate = method.current_rate() if lr is None else lr
        new_params, new_opt = method.update(grads, opt_state, params, rate,
                                            step_idx)
        return new_params, new_opt, loss.detach()

    return step, init
