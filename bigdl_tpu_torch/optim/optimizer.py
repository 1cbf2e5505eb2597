"""Training (counterpart of bigdl_tpu/optim/optimizer.py:69-373,
381-1144).

:func:`make_train_step` builds the train step the JAX package jits,

    (params, model_state, opt_states, step, rng, features, targets, lrs)
        -> (params', model_state', opt_states', loss)

over flat dicts of tensors keyed by ``named_parameters``/``named_buffers``
names (the JAX tree's paths joined by ``.``).  The parameters are f32
masters; with ``compute_dtype`` every parameter, BatchNorm's gamma/beta,
the embedding, LayerNorm's weights and the biases included, is cast to it
before the model sees it, and the gradient of that cast brings each
gradient back to f32.  The features are never cast.  The loss is the
criterion's, in the output's type, then f32.  ``rng`` is the step's
random seed (an int, a 0-dim int64 tensor, or ``None``); a model whose
``forward`` takes ``rng`` gets it, and its dropout layers draw from
streams split off it.  ``step`` and each of ``lrs`` are Python numbers or
0-dim tensors.  With ``accum_steps = k`` the batch is cut into k
micro-batches run one after the other (the BatchNorm state chained from
each to the next, micro-batch i seeded ``split_rng(rng, i)``), their f32
gradients summed, scaled by 1/k and cast to the parameters' dtype, and
the loss is their mean.  The gradients are clipped (a constant range,
then the global f32 L2 norm) before the update.  Each optimization
method updates the parameters it owns: ``"__all__"`` all of them, a
method named ``name`` the keys ``name`` and ``name.*`` (the JAX tree's
top-level subtree ``name``); the methods run in sorted order, each with
its rate from ``lrs`` in that order.

:class:`CompiledTrainStep` is that step as the JAX optimizer runs it,
``jax.jit(make_train_step(...), donate_argnums=(0, 1, 2))``
(bigdl_tpu/optim/optimizer.py:706-715): one CUDA graph per batch shape
(``utils/graphs.py``), with ``step``, the learning rates and ``rng`` in
device scalars filled before each replay and the three trees donated:
they are the graph's static inputs, and the captured step writes the new
trees into them at its end.  With accumulation all k micro-batches are
in the one capture.  On the CPU the same donated step runs eagerly.

:class:`Optimizer` is the fluent configuration and :class:`LocalOptimizer`
the single-device loop.  Each iteration runs the compiled step with the
seed ``split_rng(7, neval)`` (as ``fold_in(PRNGKey(7), neval)``) and the
methods' rates, moves the epoch/iteration bookkeeping, logs the
reference line ``[Epoch e n/N][Iteration i][Wall Clock t] Throughput is
X records/second. Loss is Y`` every 10 iterations and at each epoch's
end, validates when the validation trigger fires and writes a checkpoint
when the checkpoint trigger fires.  The loop is the JAX package's async
engine by default (docs/async_engine.md):

- batches are placed on the device by a prefetch thread
  (``dataset/prefetch.py``; ``data`` is its time per batch,
  ``data_stall`` the loop's wait for it);
- the step is only enqueued (``dispatch``); its loss goes into a slot of
  a ring of ``BIGDL_TPU_SYNC_WINDOW + 1`` pinned host scalars (default
  window 10) by a copy on the stream, behind an event, and is read
  (``sync``) when more than a window of losses is pending, at each log
  line, before validation and before a checkpoint: a divergence shows
  up at most one window late and goes into retry-from-checkpoint;
  throughput comes from the wall clock between log lines;
- a checkpoint waits for the previous write (``checkpoint_wait``, the
  JAX loop's backpressure), then is copied into host buffers pinned
  once per run (``checkpoint_pin``) by copies on the loop's stream
  (``checkpoint_snapshot``); a writer thread waits for the copies, nests
  the trees and writes the file (``checkpoint_write``).  The writer is
  joined before any restore and on every exit, where its error is raised
  unless another one is already on its way.

``BIGDL_TPU_SYNC_LOOP=1`` gives the synchronous loop: the batch placed on
the loop thread (``data``), the loss read after every step
(``compute``) and the checkpoint written on the loop thread.  Both loops
run the same steps on the same batches, seeds and rates, so they train
bit-identically; only where the host waits differs.

Checkpoints are the JAX package's blob, ``{"params", "model_state",
"opt_states", "driver_state"}`` with each tree in JAX's nesting
(``export_variables``/``export_opt_state``, a named method's state as
``{name: subtree}``) and the loop's int and float bookkeeping, so either
package resumes from the other's.  A loss that is not finite, or a
``RuntimeError`` or ``ValueError`` of an iteration, restores the latest
checkpoint into the compiled step's trees and goes on, at most
``max_retry`` times in ``retry_window_sec``; with no checkpoint it is
raised again.  ``resume_from`` starts from a checkpoint: trees,
bookkeeping, the optimization methods' counters and the dataset's
cursor, so the run goes on with the batches, seeds and learning rates of
the uninterrupted one.  ``request_stop`` ends the loop at the next
iteration with a final checkpoint.  After each validation a schedule
with ``record`` (``Plateau``) gets the score.  :func:`evaluate` runs
validation methods over one pass of a dataset and :func:`predict` yields
the outputs batch by batch, through one compiled forward per model and
input shape (JAX's ``_jit_forward``, optimizer.py:1098-1144).

Checkpoint directories and files go through ``utils/file_io.py``, so a
checkpoint path may be remote (``gs://``, ``memory://``; fsspec).
``set_train_summary``/``set_val_summary`` write TensorBoard scalars
(optimizer.py:161-166, 770-772, 928-954, 981-982): ``Loss`` against
its own iteration (the async loop writes it when the loss is read, the
synchronous loop after each step), ``Throughput`` and ``LearningRate``
every iteration, the ``Parameters`` histogram (a subsample of the
parameters, reduced on the device) when its trigger fires, and each
validation method's score.

Telemetry (``bigdl_tpu_torch.telemetry``, optimizer.py:778-918,
1052-1071): each iteration's spans carry ``step:<n>`` while the tracer
is on; the compiled step is stamped with its flops and bytes (counted
from one eager call before its capture) and registered as
``train_step`` in the program registry, which counts its calls; each log
line adds ``mfu`` and ``bytes_per_sec`` to the metrics' values (so to
``summary()``) and samples the HBM ledger; a divergence read by a drain
emits a ``loss_divergence`` instant and a retry a
``divergence_recovery`` one; a checkpoint's write is a span on the
writer thread correlated with its step.

Numerics (``telemetry/numerics.py``; optimizer.py:181-186, 426-457,
583-614, 742-748, 895-954): with ``set_numerics(True)`` or
``BIGDL_TPU_NUMERICS=1`` the step returns a fifth output, per-layer
gradient, parameter and update norms, non-finite gradient counts and
histograms, computed in the step (so in its CUDA graph) from the
parameters, the clipped gradients and the new parameters.  The loop
copies them into a pinned ring beside the losses' and reads them at the
drain, each before its own iteration's loss (``numerics``, so a
``numerics_anomaly`` precedes the ``loss_divergence``); the log line
gains ``grad_norm`` and ``update_ratio``, the train summary
``GradNorm``, ``UpdateRatio`` and the per-layer ``Parameters``
histograms.  The last ``BIGDL_TPU_SYNC_WINDOW + 2`` batches stay
referenced (the tensors the prefetcher handed over, never the graph's
static inputs), and a retry re-runs the diverged one eagerly on the
restored parameters (``nan_provenance``).  With stats off the step is
the four-output one.  The loop attaches to the debug server
(``BIGDL_TPU_DEBUG_PORT``) and registers its metrics and the numerics
tail with the flight recorder, which a retry also dumps.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import math
import os
import re
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.prefetch import DevicePrefetcher, to_device
from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.module import _forward_takes_rng, _signed, split_rng
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult, _numpy)
from bigdl_tpu_torch.telemetry import (costmodel, debug_server,
                                       flightrecorder, programs)
from bigdl_tpu_torch.telemetry import numerics as numerics_mod
from bigdl_tpu_torch.telemetry.tracer import (CAT_TRAIN, correlate,
                                              get_tracer, set_correlation)
from bigdl_tpu_torch.utils import file_io, graphs
from bigdl_tpu_torch.utils.convert import (export_opt_state,
                                           export_variables, flatten,
                                           load_jax_variables)
from bigdl_tpu_torch.utils.serialization import (load_pytree,
                                                 save_pytree)

logger = logging.getLogger("bigdl_tpu_torch.optim")

__all__ = ["CompiledTrainStep", "Optimizer", "LocalOptimizer", "evaluate",
           "make_train_step", "predict"]

Tensors = Dict[str, torch.Tensor]
_LOOP_SEED = 7  # the loop's root seed, as PRNGKey(7) in the JAX loop


def _sq_norm(grads: Tensors) -> torch.Tensor:
    """The f32 sum of squares of every gradient."""
    return sum(torch.square(g.float()).sum() for g in grads.values())


def _clip_grads(grads: Tensors, clip_const: Optional[Tuple[float, float]],
                clip_norm: Optional[float],
                sq_norm: Callable[[Tensors], torch.Tensor] = _sq_norm
                ) -> Tensors:
    """Clip to a constant range, then scale by ``min(1, c / max(norm,
    1e-12))`` with ``norm`` the global f32 L2 norm of every gradient
    (optimizer.py:241-249, utils/flatten.py:61-66); ``sq_norm`` gives
    its square (over the shards of sharded leaves under a mesh)."""
    if clip_const is not None:
        lo, hi = clip_const
        grads = {k: torch.clamp(g, lo, hi) for k, g in grads.items()}
    if clip_norm is not None:
        norm = torch.sqrt(sq_norm(grads))
        scale = torch.clamp_max(clip_norm / torch.clamp_min(norm, 1e-12),
                                1.0)
        grads = {k: g * scale for k, g in grads.items()}
    return grads


def _aux_keys(state: Dict[str, Any]) -> List[str]:
    """The keys of the auxiliary losses a module surfaced through its
    state (leaf ``aux_loss``: the MoE router's load balance)."""
    return [k for k in state if k == "aux_loss" or k.endswith(".aux_loss")]


def _aux_losses(state: Dict[str, Any]) -> List[torch.Tensor]:
    """The auxiliary losses of a flat state dict (optimizer.py:252-263)."""
    return [state[k] for k in _aux_keys(state)]


def _owned(name: str, keys) -> List[str]:
    """The parameter keys the method ``name`` updates: every key for
    ``"__all__"``, else ``name`` and ``name.*`` (the JAX tree's top-level
    subtree ``name``)."""
    if name == "__all__":
        return list(keys)
    return [k for k in keys if k == name or k.startswith(name + ".")]


def _subset(flat: Dict[str, Any], name: str) -> Dict[str, Any]:
    return {k: flat[k] for k in _owned(name, flat)}


def _micro(tree: Any, i: int, m: int) -> Any:
    """Rows ``[i * m, (i + 1) * m)`` of every tensor of a batch tree."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_micro(v, i, m) for v in tree)
    return tree[i * m:(i + 1) * m]


def make_train_step(model: torch.nn.Module, criterion: Criterion,
                    optim_methods: Dict[str, OptimMethod],
                    grad_clip_const: Optional[Tuple[float, float]] = None,
                    grad_clip_norm: Optional[float] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    aux_loss_weight: float = 0.01,
                    accum_steps: int = 1,
                    numerics: Optional[numerics_mod.NumericsSpec] = None,
                    data_parallel=None) -> Callable:
    """The train step of bigdl_tpu/optim/optimizer.py:266-373.

    ``train_step(params, model_state, opt_states, step, rng, features,
    targets, lrs)`` runs ``model`` in training mode on ``features`` with
    ``params``/``model_state`` swapped in (``torch.func.functional_call``),
    takes the gradients of the f32 loss with respect to ``params`` (with
    ``accum_steps`` > 1: summed over that many micro-batches in f32, then
    their mean), clips them (``grad_clip_const`` then ``grad_clip_norm``),
    and applies each method of ``optim_methods`` (in sorted order, with
    its rate from ``lrs`` in that order) to the parameters it owns, with
    the 1-based ``step``.  ``rng`` (a seed or ``None``) goes to the
    model's ``forward`` when it takes one, so dropout draws from it.  It
    returns new dicts and the detached f32 loss; the inputs are not
    changed.  A batch that ``accum_steps`` does not divide raises
    ``ValueError``.  With a ``numerics`` spec
    (``telemetry.numerics.NumericsSpec``) it returns a fifth output, the
    stats tree of ``numerics.collect`` over ``params``, the clipped
    gradients and the new parameters (optimizer.py:275-291, 367-369).
    ``data_parallel`` (``parallel.data_parallel.DataParallel``) makes it
    the data-parallel step: the forward and backward run in its scope,
    the loss, the gradients and the new model state go through its
    ``reduce`` before the clipping, and each method's
    update through its ``update`` (ZeRO-1); the clipping norm is its
    ``sq_norm`` where it has one (each sharded leaf's shards counted
    once).  Auxiliary
    losses the model leaves in its state (``aux_loss`` buffers: the MoE
    load balance) join the loss times ``aux_loss_weight``
    (optimizer.py:311-314).
    """
    method_items = sorted(optim_methods.items())
    collector = (numerics_mod.Collector(numerics) if numerics is not None
                 else None)
    takes_rng = _forward_takes_rng(type(model))

    def loss_and_grads(params, state, rng, features, targets):
        """One forward and backward; ``state`` is updated in place."""
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        kwargs = {"rng": rng} if takes_rng else {}
        with torch.enable_grad():
            cast = ({k: v.to(compute_dtype) for k, v in leaves.items()}
                    if compute_dtype is not None else leaves)
            out = functional_call(model, {**cast, **state}, (features,),
                                  kwargs)
            loss = criterion.forward(out, targets).float()
            aux = _aux_keys(state)
            for k in aux:
                loss = loss + aux_loss_weight * state[k].float()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        for k in aux:  # the new state holds values, not their graph
            state[k] = state[k].detach()
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(params, model_state, opt_states, step, rng, features,
                   targets, lrs):
        model.train()
        with (data_parallel.scope() if data_parallel is not None
              else contextlib.nullcontext()):
            loss, grads, new_state = forward_backward(
                params, model_state, rng, features, targets)
        if data_parallel is not None:
            loss, grads, new_state = data_parallel.reduce(loss, grads,
                                                          new_state)
        grads = _clip_grads(grads, grad_clip_const, grad_clip_norm,
                            getattr(data_parallel, "sq_norm", _sq_norm))
        update = (data_parallel.update if data_parallel is not None
                  else _update)
        new_params = dict(params)
        new_opt_states = {}
        for (name, method), lr in zip(method_items, lrs):
            upd, new_opt_states[name] = update(
                method, _subset(grads, name), opt_states[name],
                _subset(params, name), lr, step)
            if name == "__all__":  # as JAX: "__all__" replaces the tree
                new_params = upd
            else:
                new_params.update(upd)
        if collector is not None:
            return (new_params, new_state, new_opt_states, loss,
                    collector(params, grads, new_params))
        return new_params, new_state, new_opt_states, loss

    def forward_backward(params, model_state, rng, features, targets):
        """The loss, the gradients and the new model state (on copies:
        the modules update their running statistics in place)."""
        new_state = {k: v.clone() for k, v in model_state.items()}
        if accum_steps <= 1:
            loss, grads = loss_and_grads(params, new_state, rng, features,
                                         targets)
        else:
            k = accum_steps
            bsz = graphs.leaves(features)[0].shape[0]
            if bsz % k:
                raise ValueError(
                    f"batch size {bsz} is not divisible by "
                    f"gradient-accumulation steps {k}")
            m = bsz // k
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            for i in range(k):
                li, gi = loss_and_grads(params, new_state, split_rng(rng, i),
                                        _micro(features, i, m),
                                        _micro(targets, i, m))
                with torch.no_grad():
                    for n, g in gi.items():
                        gsum[n].add_(g.float())
                lsum = lsum + li
                del gi  # freed before the next micro-batch runs
            grads = {n: (g * (1.0 / k)).to(params[n].dtype)
                     for n, g in gsum.items()}
            loss = lsum * (1.0 / k)
        return loss, grads, new_state

    return train_step


def _update(method: OptimMethod, grads, opt_state, params, lr, step):
    return method.update(grads, opt_state, params, lr, step)


class CompiledTrainStep:
    """``step_fn`` (a :func:`make_train_step` step) compiled per batch
    shape with its trees donated; called as the step is, it returns the
    trees it was given, updated in place, and the loss (and with numerics
    the stats tree; both valid until the next call).  ``step``, ``rng`` and ``lrs`` may be Python numbers:
    they are written into device scalars that the graphs read.
    ``graphs`` maps each batch's signature to its compiled call;
    ``captures`` and ``replays`` add them up.  The graphs share one
    memory pool: the first batch, the largest, is captured first.  Each
    compile is registered as :attr:`program` in the program registry,
    and ``cost`` is the latest one's stamp (``telemetry/costmodel.py``).
    ``capture=False`` runs the donated step eagerly on the card too (a
    step whose collectives are host calls, as gloo's are, cannot be
    captured)."""

    program = "train_step"

    def __init__(self, step_fn: Callable, capture: bool = True):
        self.step_fn = step_fn
        self.capture = capture
        self.cost: Optional[costmodel.ProgramCost] = None
        self.graphs: Dict[Any, Callable] = {}
        self._pool = None
        self._scalars: Optional[tuple] = None

    def __call__(self, params, model_state, opt_states, step, rng, features,
                 targets, lrs):
        device = next(iter(params.values())).device
        if self._scalars is None:  # (step, rng, [lr, ...]), made once
            def zero(dtype):
                return torch.zeros((), dtype=dtype, device=device)
            self._scalars = (zero(torch.int64), zero(torch.int64),
                             [zero(torch.float32) for _ in lrs])
        step_t, rng_t, lrs_t = self._scalars
        with torch.no_grad():  # fills: no host-device copy, no wait
            step_t.fill_(step)
            for t, lr in zip(lrs_t, lrs):
                t.fill_(lr)
            if rng is None:
                rng_t = None
            else:
                rng_t.fill_(rng if torch.is_tensor(rng) else _signed(rng))
        args = (params, model_state, opt_states, step_t, rng_t, features,
                targets, lrs_t)
        key = graphs.signature((features, targets, rng is None))
        fn = self.graphs.get(key)
        first = fn is None
        if first:
            # on the CPU, or uncaptured, the first call itself is the
            # counted eager call
            eager = device.type != "cuda" or not self.capture
            if not eager and self._pool is None:
                self._pool = graphs.new_pool()
            sig = programs.signature_of(
                dict(zip(("params", "model_state", "opt_states", "step",
                          "rng", "features", "targets", "lrs"), args)),
                donated=("params", "model_state", "opt_states"))
            count = costmodel.new_count()
            t0 = time.perf_counter()
            donated = graphs.donate(self.step_fn, (0, 1, 2))
            fn = self.graphs[key] = donated if eager else graphs.compile(
                donated,
                args[:5] + graphs.clone((features, targets)) + (lrs_t,),
                self._pool, count)
            compile_s = time.perf_counter() - t0
        if first and eager and count is not None:
            rest = graphs.counted(fn, args, count)[3:]
        else:
            rest = fn(*args)[3:]
        if first:
            self.cost = costmodel.stamp(self.program, count) or self.cost
            programs.register_program(self.program, sig, fn, compile_s,
                                      cost=self.cost, expected=True)
        else:
            programs.get_program_registry().record_call(self.program)
        return (params, model_state, opt_states) + tuple(rest)

    @property
    def captures(self) -> int:
        return sum(getattr(g, "captures", 0) for g in self.graphs.values())

    @property
    def replays(self) -> int:
        return sum(getattr(g, "replays", 0) for g in self.graphs.values())




def _eval_forward(model: torch.nn.Module, params: Tensors,
                  model_state: Tensors, x):
    """``model``'s forward with ``params`` and ``model_state`` swapped in,
    compiled once per signature of the arguments and cached on the model
    (JAX's ``_jit_forward``).  On the card each graph has static inputs
    of its own, into which a call copies the arguments; its output is
    valid until the next call."""
    cache = model.__dict__.get("_compiled_eval")
    if cache is None:
        cache = model._compiled_eval = graphs.Cache()
    args = (params, model_state, x)
    key = graphs.signature(args)
    fwd = cache.get(key)
    if fwd is None:
        def forward(p, s, xx):
            return functional_call(model, {**p, **s}, (xx,))
        fwd = cache[key] = graphs.compile(forward, graphs.clone(args))
    return fwd(*args)


@torch.no_grad()
def evaluate(model: torch.nn.Module, params: Tensors, model_state: Tensors,
             dataset: AbstractDataSet, methods: List[ValidationMethod],
             batch_to_device: bool = True
             ) -> List[Tuple[ValidationMethod, Optional[ValidationResult]]]:
    """Run ``methods`` over one pass of ``dataset`` with ``params`` and
    ``model_state`` swapped into ``model`` in evaluation mode (reference
    Evaluator.scala:40-100; optimizer.py:1110-1137), one compiled forward
    per input shape.  The parameters are used as given (the loop's f32
    masters).  Returns ``[(method, folded result)]``; a result is
    ``None`` when the dataset had no batch.  ``batch_to_device=False``
    skips placing each batch on the parameters' device, for a dataset
    whose batches are already there."""
    device = next(iter(params.values())).device
    model.eval()
    totals: List[Optional[ValidationResult]] = [None] * len(methods)
    for batch in dataset.data(train=False):
        x = batch.get_input()
        out = _eval_forward(model, params, model_state,
                            to_device(x, device) if batch_to_device else x)
        for i, m in enumerate(methods):
            r = m(out, batch.get_target())
            totals[i] = r if totals[i] is None else totals[i] + r
    return list(zip(methods, totals))


@torch.no_grad()
def predict(model: torch.nn.Module, params: Tensors, model_state: Tensors,
            dataset: AbstractDataSet) -> Iterator[Any]:
    """Yield ``model``'s outputs batch by batch over one pass of
    ``dataset``, as host numpy arrays (reference Predictor.scala:152;
    optimizer.py:1140-1144), through the compiled evaluation forward of
    :func:`evaluate`."""
    device = next(iter(params.values())).device
    model.eval()
    for batch in dataset.data(train=False):
        yield _numpy(_eval_forward(model, params, model_state,
                                   to_device(batch.get_input(), device)))


class Optimizer:
    """Fluent training configuration and factory (reference
    Optimizer.scala).  ``device=None`` trains on the card; pass
    ``device="cpu"`` for the CPU."""

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion, end_trigger: Optional[Trigger] = None,
                 batch_size: Optional[int] = None,
                 device: DeviceLike = None):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.end_trigger = end_trigger or Trigger.max_epoch(1)
        self.device = resolve_device(device)
        self.optim_methods: Dict[str, OptimMethod] = {"__all__": SGD(1e-2)}
        self.compute_dtype: Optional[torch.dtype] = None
        self.grad_clip_const: Optional[Tuple[float, float]] = None
        self.grad_clip_norm: Optional[float] = None
        self.val_trigger: Optional[Trigger] = None
        self.val_dataset: Optional[AbstractDataSet] = None
        self.val_methods: List[ValidationMethod] = []
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.train_summary = None
        self.val_summary = None
        self.overwrite_checkpoint = True
        self.accum_steps = 1
        self.max_retry = 5
        self.retry_window_sec = 600.0
        self._resume_from: Optional[str] = None
        self._initial_variables: Optional[Dict[str, Any]] = None
        self._stop_requested = False
        # numerics: None follows BIGDL_TPU_NUMERICS; the spec when the
        # step carries stats (optimizer.py:112-117)
        self._numerics_requested: Optional[bool] = None
        self._numerics: Optional[numerics_mod.NumericsSpec] = None
        self._numerics_monitor: Optional[numerics_mod.NumericsMonitor] = None
        self._recent_batches: Optional[deque] = None
        # the background checkpoint writer (the async loop starts it)
        self._ckpt_pool: Optional[ThreadPoolExecutor] = None
        self._ckpt_future = None

    def request_stop(self) -> None:
        """Ask the loop to stop at the next iteration boundary; it reads
        the pending losses, writes a final checkpoint (when checkpoints
        are set) and joins the writer.  Safe from another thread or a
        signal handler."""
        self._stop_requested = True

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_methods = {"__all__": method}
        return self

    def set_optim_methods(self, methods: Dict[str, OptimMethod]
                          ) -> "Optimizer":
        """A method per top-level submodule (reference multi-optim): the
        method keyed ``name`` updates the parameters ``name`` and
        ``name.*``; ``"__all__"`` updates every parameter."""
        self.optim_methods = dict(methods)
        return self

    def set_gradient_accumulation(self, steps: int) -> "Optimizer":
        """Split every batch into ``steps`` micro-batches run one after
        the other, with f32 gradient accumulation (the batch size must
        divide by it)."""
        if steps < 1:
            raise ValueError(f"gradient-accumulation steps {steps} < 1")
        self.accum_steps = int(steps)
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_trigger = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset: AbstractDataSet,
                       methods: List[ValidationMethod]) -> "Optimizer":
        """Run ``methods`` over ``dataset`` whenever ``trigger`` fires
        after an iteration."""
        self.val_trigger = trigger
        self.val_dataset = dataset
        self.val_methods = list(methods)
        return self

    def set_checkpoint(self, path: str, trigger: Trigger) -> "Optimizer":
        """Write a checkpoint under the directory ``path`` (local or
        remote) whenever ``trigger`` fires after an iteration."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        """Write the loop's training scalars to ``summary`` (a
        ``visualization.TrainSummary``)."""
        self.train_summary = summary
        return self

    def set_val_summary(self, summary) -> "Optimizer":
        """Write each validation method's score to ``summary`` (a
        ``visualization.ValidationSummary``)."""
        self.val_summary = summary
        return self

    def over_write_checkpoint(self, overwrite: bool = True) -> "Optimizer":
        """``True``: one ``model.npz`` in ``path``, rewritten each time;
        ``False``: a timestamped directory per run holding
        ``model.<iteration>.npz``."""
        self.overwrite_checkpoint = overwrite
        return self

    def resume_from(self, checkpoint: str) -> "Optimizer":
        """Start from ``checkpoint`` (a path as written, ``.npz`` optional),
        which either package's loop wrote."""
        self._resume_from = checkpoint
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float
                                       ) -> "Optimizer":
        self.grad_clip_const = (min_v, max_v)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float
                                         ) -> "Optimizer":
        self.grad_clip_norm = clip_norm
        return self

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> "Optimizer":
        self.compute_dtype = dtype
        return self

    def set_numerics(self, on: bool = True) -> "Optimizer":
        """Turn the step's numerics stats on (or off), over the
        ``BIGDL_TPU_NUMERICS`` knob (optimizer.py:181-186)."""
        self._numerics_requested = bool(on)
        return self

    def set_initial_variables(self, variables: Dict[str, Any]
                              ) -> "Optimizer":
        """Start from a JAX-shaped ``{"params", "state"}`` tree of numpy
        arrays (loaded with ``load_jax_variables``) instead of the
        model's current weights."""
        self._initial_variables = variables
        return self

    def optimize(self) -> torch.nn.Module:
        raise NotImplementedError

    def _numerics_spec(self, model: torch.nn.Module
                       ) -> Optional[numerics_mod.NumericsSpec]:
        """Whether the step carries stats: ``set_numerics`` wins over
        ``BIGDL_TPU_NUMERICS`` (optimizer.py:696-704); kept in
        ``_numerics``."""
        on = self._numerics_requested
        if on is None:
            on = numerics_mod.enabled()
        self._numerics = numerics_mod.spec_for(model) if on else None
        return self._numerics

    def _build_step_fn(self, model: torch.nn.Module) -> CompiledTrainStep:
        """The compiled, donated train step (optimizer.py:706-715)."""
        return CompiledTrainStep(make_train_step(
            model, self.criterion, self.optim_methods, self.grad_clip_const,
            self.grad_clip_norm, self.compute_dtype,
            accum_steps=self.accum_steps,
            numerics=self._numerics_spec(model)))

    @staticmethod
    def apply(model, dataset, criterion, end_trigger=None, batch_size=None,
              device: DeviceLike = None, **distri_kwargs) -> "Optimizer":
        """Factory matching the reference Optimizer.apply
        (Optimizer.scala:660-681; optimizer.py:211-237): a
        ``DistriOptimizer`` when a mesh is passed, or when the world has
        more than one rank (an initialised process group, or
        ``torchrun``'s ``WORLD_SIZE``) and the dataset's batch (looked
        up through ``base`` wrappers when ``batch_size`` is not given)
        divides evenly over it; else a :class:`LocalOptimizer` (async
        unless ``BIGDL_TPU_SYNC_LOOP=1``).  ``distri_kwargs`` go to
        ``DistriOptimizer`` only."""
        from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
        from bigdl_tpu_torch.parallel.mesh import world_size

        if distri_kwargs.get("mesh") is not None:
            return DistriOptimizer(model, dataset, criterion, end_trigger,
                                   batch_size, device=device,
                                   **distri_kwargs)
        n_dev = world_size()
        ds_batch = batch_size
        probe = dataset
        while ds_batch is None and probe is not None:
            # a DistributedDataSet's global batch is its base's
            ds_batch = getattr(probe, "batch_size", None)
            probe = getattr(probe, "base", None)
        if n_dev > 1 and ds_batch is not None and ds_batch % n_dev == 0:
            return DistriOptimizer(model, dataset, criterion, end_trigger,
                                   batch_size, device=device,
                                   **distri_kwargs)
        return LocalOptimizer(model, dataset, criterion, end_trigger,
                              batch_size, device)


class _LossRing:
    """The async loop's pending losses: iteration ``it``'s loss is copied
    into slot ``it % size`` of a pinned host buffer by a copy on the
    device's stream, with an event behind it, so neither the copy nor
    the next step waits on the host; ``get`` waits for that event alone.
    On the CPU the slot is filled at once.  The loop keeps at most
    ``size - 1`` losses pending before it reads one, so a slot is never
    overwritten before it was read."""

    def __init__(self, size: int, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros(size, dtype=torch.float32, pin_memory=cuda)
        self.events: List[Optional[torch.cuda.Event]] = [None] * size
        self.cuda = cuda

    def put(self, it: int, loss: torch.Tensor) -> int:
        slot = it % len(self.events)
        with torch.no_grad():
            self.host[slot].copy_(loss, non_blocking=self.cuda)
        if self.cuda:
            ev = self.events[slot] = self.events[slot] or torch.cuda.Event()
            ev.record()
        return slot

    def get(self, slot: int) -> float:
        if self.cuda:
            self.events[slot].synchronize()
        return float(self.host[slot])


class _StatsRing:
    """The numerics stats beside :class:`_LossRing`: iteration ``it``'s
    stats tree (the graph's static outputs, which the next replay
    overwrites) is copied into slot ``it % size``, a pinned host tree
    made at the slot's first use, with an event behind the copies;
    ``get`` waits for that event and returns the tree as numpy arrays."""

    def __init__(self, size: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host: List[Any] = [None] * size
        self.events: List[Optional[torch.cuda.Event]] = [None] * size

    def put(self, it: int, stats: Any) -> int:
        slot = it % len(self.host)
        if self.host[slot] is None:
            self.host[slot] = _host_like(stats)
        with torch.no_grad():
            _copy_to_host(self.host[slot], stats)
        if self.cuda:
            ev = self.events[slot] = self.events[slot] or torch.cuda.Event()
            ev.record()
        return slot

    def get(self, slot: int) -> Any:
        if self.cuda:
            self.events[slot].synchronize()
        return _numpy_tree(self.host[slot])


def _numpy_tree(tree: Any) -> Any:
    """A tree of tensors as numpy arrays of their own."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy().copy()


def _host_like(tree: Any) -> Any:
    """Host buffers shaped as a tree's tensors: pinned for a CUDA device's
    (allocated once per run: pinning is the slow part of a copy)."""
    if isinstance(tree, dict):
        return {k: _host_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host_like(v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype, pin_memory=tree.is_cuda)


def _copy_to_host(host: Any, tree: Any):
    """Copy a tree's tensors into its host buffers; from a CUDA device by
    copies enqueued on the current stream (the caller waits on an event
    before reading them)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_to_host(host[k], v)
    elif isinstance(tree, tuple):
        for h, v in zip(host, tree):
            _copy_to_host(h, v)
    else:
        host.copy_(tree.detach(), non_blocking=tree.is_cuda)


class LocalOptimizer(Optimizer):
    """Single-device training loop (reference LocalOptimizer.scala;
    bigdl_tpu/optim/optimizer.py:381-1096): the async engine, or with
    ``BIGDL_TPU_SYNC_LOOP=1`` the synchronous loop; see the module's
    docstring.  After ``optimize()``, ``train_step`` is the
    :class:`CompiledTrainStep` it ran: on the card its ``captures`` count
    the batch shapes and its ``replays`` the iterations."""

    def optimize(self) -> torch.nn.Module:
        model = self.model.to(self.device)
        if self._initial_variables is not None:
            load_jax_variables(model, self._initial_variables)
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        model_state = {k: b.detach().clone()
                       for k, b in model.named_buffers()}
        step_fn = self.train_step = self._build_step_fn(model)
        self._sync_replicas(params, model_state)
        opt_states = self._init_opt_states(params)
        loop_state: Dict[str, Any] = {
            "epoch": 0, "neval": 0, "loss": float("nan"),
            "score": float("-inf"), "records_processed": 0,
            "batch_in_epoch": 0, "epoch_finished": False}
        self._loop_state = loop_state  # train_log_line reads it
        # the step's trees: the compiled step updates these very tensors,
        # and a restore copies a checkpoint into them
        trees = (params, model_state, opt_states)
        if self._resume_from:
            self._load_resume(trees, loop_state)
        self.metrics = metrics = Metrics()
        batches_per_epoch = max(1, self.dataset.batches_per_epoch())
        wall_start = time.time()
        self._sync_loop = os.environ.get("BIGDL_TPU_SYNC_LOOP") == "1"
        self.sync_window = max(
            1, int(os.environ.get("BIGDL_TPU_SYNC_WINDOW", "10")))
        self._pending = deque()  # (iteration, ring slot, records)
        self._ring = _LossRing(self.sync_window + 1, self.device)
        self._numerics_monitor = self._recent_batches = None
        self._stats_ring = None
        if self._numerics is not None:
            self._numerics_monitor = numerics_mod.NumericsMonitor(
                self._numerics)
            self._stats_ring = _StatsRing(self.sync_window + 1, self.device)
            # the batches a provenance replay may need, kept by reference
            # (optimizer.py:116, 435)
            self._recent_batches = deque(maxlen=self.sync_window + 2)
        self._host = None  # the checkpoints' host buffers
        self._retries = 0
        self._last_failure = 0.0
        self._diverged_at: Optional[int] = None
        self._log_t0 = time.perf_counter()
        self._log_records = 0
        self._last_throughput = 0.0
        prefetcher = None
        if self._sync_loop:
            data_iter = self.dataset.data(train=True)
        else:
            # 'data' is the producer thread's time per batch; the loop
            # only waits on an empty queue ('data_stall')
            metrics.no_span("data")
            prefetcher = data_iter = DevicePrefetcher(
                self.dataset.data(train=True),
                place=functools.partial(self._place_batch, non_blocking=True),
                timer=lambda dt: metrics.add("data", dt), device=self.device)
        ckpt_dir = self._prepare_ckpt_dir()
        # the live plane: host-side registration only, nothing reaches
        # the step (optimizer.py:441-457)
        detach_debug = debug_server.attach_engine(
            "train", role="train", metrics=lambda: self.metrics,
            status=self.train_log_line)
        dbg = debug_server.get_debug_server(create=False)
        if dbg is not None and self._numerics_monitor is not None:
            dbg.set_numerics(self._numerics_monitor)
        flight = flightrecorder.get_flight_recorder()
        if flight is not None:
            flight.add_metrics("train", lambda: self.metrics)
            if self._numerics_monitor is not None:
                mon = self._numerics_monitor
                flight.add_blob("numerics", lambda: {
                    "last": dict(getattr(mon, "last", None) or {})})
        try:
            while not self._stop_requested \
                    and not self.end_trigger(loop_state):
                try:
                    trees = self._one_iteration(step_fn, trees, loop_state,
                                                data_iter, batches_per_epoch,
                                                wall_start)
                    if loop_state["epoch_finished"]:
                        for m in self.optim_methods.values():
                            m.state["epoch"] = loop_state["epoch"]
                    self._maybe_validate(model, trees[0], trees[1],
                                         loop_state)
                    self._maybe_checkpoint(ckpt_dir, model, trees,
                                           loop_state)
                except (FloatingPointError, RuntimeError, ValueError) as e:
                    self._recover_or_reraise(e, ckpt_dir, trees, loop_state)
                    continue
                loop_state["epoch_finished"] = False
            # the last window: a divergence here still goes back to the
            # latest checkpoint instead of being raised
            try:
                self._drain_losses(loop_state)
                if self._stop_requested:
                    # the iteration it stopped at, so that a resume goes
                    # on there
                    self._maybe_checkpoint(ckpt_dir, model, trees,
                                           loop_state, force=True)
            except FloatingPointError as e:
                self._recover_or_reraise(e, ckpt_dir, trees, loop_state)
        finally:
            detach_debug()
            if prefetcher is not None:
                prefetcher.close()
            # an exception already on its way is not masked by the
            # writer's
            self._finish_checkpoints(raise_errors=sys.exc_info()[0] is None)
        return self._finish_model(model, trees[0], trees[1])

    def _finish_model(self, model: torch.nn.Module, params: Tensors,
                      model_state: Tensors) -> torch.nn.Module:
        """Copy the trained trees into ``model``; they become
        ``final_params``/``final_state``."""
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
            for k, b in model.named_buffers():
                b.copy_(model_state[k])
        self.final_params, self.final_state = params, model_state
        return model

    def _sync_replicas(self, params: Tensors, model_state: Tensors):
        """Make every replica's starting trees equal (one device: no
        replica to sync)."""

    def _init_opt_states(self, params: Tensors) -> Dict[str, Any]:
        """Each method's state, started from its subtree
        (optimizer.py:387-391)."""
        return {name: m.init_state(_subset(params, name))
                for name, m in self.optim_methods.items()}

    def _place_batch(self, batch, non_blocking: bool = False):
        """``(features, targets, records)`` of one batch, the tensors on
        the device (the prefetch thread's placement: ``non_blocking``)."""
        return (to_device(batch.get_input(), self.device,
                          non_blocking=non_blocking),
                to_device(batch.get_target(), self.device,
                          non_blocking=non_blocking),
                batch.size)

    # -- checkpoints (bigdl_tpu/optim/optimizer.py:529-581, 616-676,
    # 989-1096) --------------------------------------------------------
    def _prepare_ckpt_dir(self) -> Optional[str]:
        """The run's checkpoint directory, made (through ``file_io``):
        ``checkpoint_path`` itself when overwriting, else a timestamped
        subdirectory."""
        if not self.checkpoint_path:
            return None
        d = self.checkpoint_path
        if not self.overwrite_checkpoint:
            d = file_io.join(d, time.strftime("%Y%m%d_%H%M%S"))
        file_io.makedirs(d)
        return d

    def _ckpt_file(self, d: str, it: int) -> str:
        return file_io.join(d, "model" if self.overwrite_checkpoint
                            else f"model.{it}")

    @staticmethod
    def _latest_ckpt(d: str) -> Optional[str]:
        """The newest checkpoint in ``d`` (without ``.npz``), or ``None``:
        only ``model.npz`` and ``model.<iteration>.npz`` count, so a
        temporary file left by a killed write is ignored."""
        names = [f for f in file_io.listdir(d)
                 if re.fullmatch(r"model(\.\d+)?\.npz", f)]
        if not names:
            return None
        latest = max(names, key=lambda f: int(f.split(".")[1])
                     if f.count(".") > 1 else 1 << 60)
        return file_io.join(d, latest[:-len(".npz")])

    def _blob(self, model, params, model_state, opt_states, driver_state):
        """The checkpoint blob, each tree in JAX's nesting."""
        variables = export_variables(model, params, model_state)
        return {
            "params": variables["params"],
            "model_state": variables["state"],
            "opt_states": {name: export_opt_state(model, st, name)
                           for name, st in opt_states.items()},
            "driver_state": driver_state,
        }

    def _maybe_checkpoint(self, ckpt_dir, model, trees, loop_state,
                          force: bool = False):
        """Write the blob when the trigger fires (or ``force``), after
        the pending losses were read: a checkpoint the retry may restore
        never holds a diverged step.  The synchronous loop writes it on
        the loop thread; the async loop snapshots the trees to the host
        and hands them to the writer thread."""
        if not ckpt_dir or not (force or (
                self.checkpoint_trigger is not None
                and self.checkpoint_trigger(loop_state))):
            return
        self._drain_losses(loop_state)
        self._save_checkpoint(ckpt_dir, model, trees, loop_state)

    @staticmethod
    def _driver_state(loop_state) -> Dict[str, Any]:
        """The loop's int and float bookkeeping; no bools: a saved
        epoch_finished would fire the epoch triggers again right after a
        resume."""
        return {k: v for k, v in loop_state.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}

    def _save_checkpoint(self, ckpt_dir, model, trees, loop_state):
        """Write the blob: on the loop thread (sync loop) or through the
        writer thread (async loop)."""
        driver_state = self._driver_state(loop_state)
        it = loop_state["neval"]
        path = self._ckpt_file(ckpt_dir, it)
        if self._sync_loop:
            save_pytree(path, self._blob(model, *trees, driver_state))
            logger.info("Checkpoint saved to %s (iteration %d)", path, it)
            return
        self._submit_checkpoint(path, model, trees, driver_state, it)

    def _submit_checkpoint(self, path, model, trees, driver_state,
                           iteration):
        """Hand one checkpoint to the writer thread: wait for the previous
        write (backpressure; its error is raised here), copy the trees
        into the run's host buffers (the loop's stall), and submit."""
        if self._ckpt_pool is None:
            self._ckpt_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bigdl-ckpt")
        with self.metrics.time("checkpoint_wait"):
            if self._ckpt_future is not None:
                fut, self._ckpt_future = self._ckpt_future, None
                fut.result()
        if self._host is None:
            with self.metrics.time("checkpoint_pin"):
                self._host = _host_like(trees)
        # the copies are enqueued before the next step, which overwrites
        # the trees in place, so they read this iteration's values
        with self.metrics.time("checkpoint_snapshot"):
            _copy_to_host(self._host, trees)
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record()
        host = self._host

        def write():
            if ready is not None:
                ready.synchronize()
            # a span on the writer's own track, joined to its step
            with correlate(f"step:{iteration}"), \
                    self.metrics.time("checkpoint_write"):
                save_pytree(path, self._blob(model, *host, driver_state))
            logger.info("Checkpoint saved to %s (iteration %d)", path,
                        iteration)

        self._ckpt_future = self._ckpt_pool.submit(write)

    def _wait_writer(self):
        """Join the write in flight; its error is logged, not raised, so
        that a recovery goes back to the latest complete checkpoint."""
        fut, self._ckpt_future = self._ckpt_future, None
        if fut is None:
            return
        try:
            fut.result()
        except Exception:
            logger.warning("in-flight checkpoint write failed during "
                           "recovery; restoring an older checkpoint",
                           exc_info=True)

    def _finish_checkpoints(self, raise_errors: bool = True):
        """Wait for the write in flight and stop the writer; called on
        every exit of ``optimize``.  The write's error is raised when
        ``raise_errors``, else logged."""
        pool, fut = self._ckpt_pool, self._ckpt_future
        self._ckpt_pool = self._ckpt_future = None
        if pool is None:
            return
        pool.shutdown(wait=True)
        if fut is not None:
            try:
                fut.result()
            except Exception:
                if raise_errors:
                    raise
                logger.warning("background checkpoint write failed",
                               exc_info=True)

    def _restore(self, blob: dict, trees, loop_state):
        """Copy a checkpoint blob into the step's trees in place (so the
        compiled step replays on them with no new capture) and into the
        loop's bookkeeping and the methods' counters."""
        params, model_state, opt_states = trees
        plan = [(params, blob["params"], "params"),
                (model_state, blob["model_state"], "model_state")]
        for name, st in opt_states.items():
            for slot, flat in st.items():
                plan.append((flat, blob["opt_states"][name][slot],
                             f"opt_states/{name}/{slot}"))
        for flat, tree, what in plan:  # check all before copying any
            got = flatten(tree)
            missing, extra = set(flat) - set(got), set(got) - set(flat)
            if missing or extra:
                raise KeyError(f"checkpoint {what}: keys differ: missing "
                               f"{sorted(missing)[:8]}, unexpected "
                               f"{sorted(extra)[:8]}")
            for k, t in flat.items():
                if tuple(np.shape(got[k])) != tuple(t.shape):
                    raise ValueError(f"checkpoint {what} {k}: shape "
                                     f"{np.shape(got[k])} != "
                                     f"{tuple(t.shape)}")
        with torch.no_grad():
            for flat, tree, _ in plan:
                got = flatten(tree)
                for k, t in flat.items():
                    t.copy_(torch.from_numpy(np.asarray(got[k])))
        loop_state.update({k: v.item() if hasattr(v, "item") else v
                           for k, v in blob["driver_state"].items()})
        loop_state["epoch_finished"] = False
        for m in self.optim_methods.values():
            m.state["neval"] = loop_state["neval"]
            m.state["epoch"] = loop_state["epoch"]

    def _load_latest(self, ckpt_dir: str, trees, loop_state) -> bool:
        """Restore the newest checkpoint in ``ckpt_dir``; False when there
        is none."""
        latest = self._latest_ckpt(ckpt_dir)
        if latest is None:
            return False
        self._restore(load_pytree(latest), trees, loop_state)
        return True

    def _load_resume(self, trees, loop_state):
        """Start from ``resume_from``: the trees, the bookkeeping and the
        dataset's cursor."""
        self._restore(load_pytree(self._resume_from), trees, loop_state)
        self._restore_data_cursor(loop_state)
        logger.info("Resumed from %s at iteration %d", self._resume_from,
                    loop_state["neval"])

    def _restore_data_cursor(self, loop_state):
        """Rewind a dataset that has ``restore_cursor`` to the checkpoint's
        epoch and batch, so the next batches are the ones the
        uninterrupted run read."""
        rc = getattr(self.dataset, "restore_cursor", None)
        if rc is not None:
            rc(loop_state.get("epoch", 0), loop_state.get("batch_in_epoch",
                                                          0))

    def _recover_or_reraise(self, e: BaseException, ckpt_dir, trees,
                            loop_state):
        """Retry from the latest checkpoint (rate-limited: at most
        ``max_retry`` failures within ``retry_window_sec`` of each
        other); ``e`` is raised again when retries are used up or there
        is no checkpoint to go back to.  The writer is joined first, and
        the pending losses, of the diverged run, are dropped."""
        now = time.time()
        if now - self._last_failure > self.retry_window_sec:
            self._retries = 0
        self._retries += 1
        self._last_failure = now
        if self._retries > self.max_retry or not ckpt_dir:
            raise e
        self._wait_writer()
        detected_at = loop_state["neval"]
        if not self._load_latest(ckpt_dir, trees, loop_state):
            raise e
        self._pending.clear()
        logger.warning("Training failure (%s); retry %d from checkpoint "
                       "at iteration %d", e, self._retries,
                       loop_state["neval"])
        diverged_at, self._diverged_at = self._diverged_at, None
        if diverged_at is not None:
            # one-shot and off the loop's path: the diverged batch on the
            # restored parameters
            self._maybe_diagnose_divergence(trees, diverged_at)
        get_tracer().instant(
            numerics_mod.RECOVERY_EVENT, CAT_TRAIN,
            corr=f"step:{detected_at if diverged_at is None else diverged_at}",
            args={"iteration": diverged_at, "detected_at": detected_at,
                  "restored_iteration": loop_state["neval"],
                  "replayed_steps": detected_at - loop_state["neval"],
                  "checkpoint_dir": ckpt_dir, "retry": self._retries})
        # the failure's window into a bundle before the retry overwrites
        # it (rate-limited: the loss_divergence instant may have dumped)
        flight = flightrecorder.get_flight_recorder()
        if flight is not None:
            flight.dump(trigger="loss_divergence" if diverged_at is not None
                        else "train_retry",
                        note=f"retry {self._retries}: {e}"[:400])

    def _maybe_diagnose_divergence(self, trees, diverged_at: int):
        """NaN provenance (optimizer.py:583-614): with numerics on and the
        diverged batch still kept, re-run it eagerly on the restored
        trees with its own seed and emit the ``nan_provenance`` instant.
        Never raises into the recovery."""
        if self._numerics is None or not self._recent_batches:
            return
        batch = next((b for b in self._recent_batches
                      if b[0] == diverged_at), None)
        self._recent_batches.clear()
        if batch is None:
            return
        _, features, targets = batch
        params, model_state, _ = trees
        try:
            report = numerics_mod.nan_provenance(
                self.model, params, model_state, features, targets,
                criterion=self.criterion, compute_dtype=self.compute_dtype,
                rng=split_rng(_LOOP_SEED, diverged_at - 1))
        except Exception:
            logger.warning("nan provenance diagnostic failed",
                           exc_info=True)
            return
        numerics_mod.emit_provenance(report, diverged_at)
        if report.get("layer") is not None:
            logger.warning(
                "nan provenance: first offending layer %r (site=%s) for "
                "the divergence at iteration %d", report["layer"],
                report.get("site"), diverged_at)

    def train_log_line(self) -> str:
        """One-line training status (bigdl_tpu/optim/optimizer.py:683)."""
        m = getattr(self, "metrics", None)
        ds = getattr(self, "_loop_state", None)
        if m is None or ds is None:
            return "train: starting"
        return (f"train: iter={ds.get('neval', 0)} "
                f"epoch={ds.get('epoch', 0)} "
                f"loss={ds.get('loss', float('nan')):.4f} | {m.summary()}")

    def _maybe_validate(self, model, params, model_state, loop_state):
        """Validate when the trigger fires (optimizer.py:964-987), after
        the pending losses were read: log ``<method> is <result>`` per
        method, keep the first method's value as ``loop_state["score"]``
        and hand it to every schedule with ``record`` (``Plateau``)."""
        if (self.val_trigger is None or self.val_dataset is None
                or not self.val_methods or not self.val_trigger(loop_state)):
            return
        self._drain_losses(loop_state)
        results = self._evaluate(model, params, model_state)
        if any(res is None for _, res in results):
            logger.warning("validation produced no batches "
                           "(val set < batch size); skipping")
            return
        for method, res in results:
            logger.info("%s is %s", method.name, res)
            if self.val_summary is not None:
                self.val_summary.add_scalar(method.name, res.result()[0],
                                            loop_state["neval"])
        loop_state["score"] = results[0][1].result()[0]
        for m in self.optim_methods.values():
            record = getattr(m.schedule, "record", None)
            if record is not None:
                record(loop_state["score"], m.learning_rate)

    def _evaluate(self, model, params, model_state):
        """The validation methods over one pass of the validation set."""
        return evaluate(model, params, model_state, self.val_dataset,
                        self.val_methods)

    def _drain_losses(self, loop_state, keep: int = 0):
        """Read pending losses, the oldest first, until at most ``keep``
        remain (optimizer.py:735-772): the async loop's only waits on the
        device.  A loss that is not finite raises ``FloatingPointError``
        naming its iteration and the one it was read at."""
        while len(self._pending) > keep:
            it, slot, _ = self._pending.popleft()
            if self._stats_ring is not None:
                # the stats of iteration it before its loss: a
                # non-finite gradient count raises numerics_anomaly ahead
                # of the loss_divergence below
                with self.metrics.time("numerics"):
                    self._numerics_monitor.observe(
                        it, self._stats_ring.get(slot))
            with self.metrics.time("sync"):
                loss = self._ring.get(slot)
            if math.isnan(loss) or math.isinf(loss):
                self._pending.clear()
                self._diverged_at = it
                # the iteration that produced it and the one that read
                # it: the watchdog counts these as nan_windows
                get_tracer().instant(
                    "loss_divergence", CAT_TRAIN, corr=f"step:{it}",
                    args={"iteration": it,
                          "detected_at": loop_state["neval"],
                          "lag_steps": loop_state["neval"] - it,
                          "sync_window": self.sync_window,
                          "loss": str(loss)})
                raise FloatingPointError(
                    f"loss diverged: {loss} (iteration {it}, detected at "
                    f"iteration {loop_state['neval']})")
            loop_state["loss"] = loss
            if self.train_summary is not None:
                # against its own iteration, not the one it was read at
                self.train_summary.add_scalar("Loss", loss, it)

    def _one_iteration(self, step_fn, trees, loop_state, data_iter,
                       batches_per_epoch, wall_start):
        metrics = self.metrics
        if get_tracer().enabled:
            # every span this thread records in the iteration carries it
            set_correlation(f"step:{loop_state['neval'] + 1}")
        if self._sync_loop:
            with metrics.time("data"):
                features, targets, n_records = self._place_batch(
                    next(data_iter))
        else:  # placed on the prefetch thread; this is the wait for it
            with metrics.time("data_stall"):
                features, targets, n_records = next(data_iter)
        lrs = [m.current_rate() for _, m in sorted(self.optim_methods.items())]
        it = loop_state["neval"] + 1
        if self._recent_batches is not None:
            # the tensors handed over, not the graph's static inputs,
            # which the next step overwrites
            self._recent_batches.append((it, features, targets))
        # async: 'dispatch' only enqueues the step; sync: 'compute' waits
        # for its loss
        with metrics.time("compute" if self._sync_loop else "dispatch"):
            params, model_state, opt_states, loss, *stats = step_fn(
                *trees, it, split_rng(_LOOP_SEED, loop_state["neval"]),
                features, targets, lrs)
            if self._sync_loop:
                loss = float(loss)
            else:  # a slot of its own before the next step overwrites it
                slot = self._ring.put(it, loss)
                if stats:
                    self._stats_ring.put(it, stats[0])
        if self._sync_loop:
            if stats:
                self._numerics_monitor.observe(it, self._stats_ring.get(
                    self._stats_ring.put(it, stats[0])))
            if math.isnan(loss) or math.isinf(loss):
                self._diverged_at = it
                raise FloatingPointError(f"loss diverged: {loss}")
            loop_state["loss"] = loss
        else:
            self._pending.append((it, slot, n_records))
        loop_state["neval"] = it
        loop_state["records_processed"] += n_records
        loop_state["batch_in_epoch"] += 1
        self._log_records += n_records
        for m in self.optim_methods.values():
            m.state["neval"] = it
        if loop_state["batch_in_epoch"] >= batches_per_epoch:
            loop_state["epoch"] += 1
            loop_state["records_processed"] = 0
            loop_state["batch_in_epoch"] = 0
            loop_state["epoch_finished"] = True

        log_due = it % 10 == 1 or loop_state["epoch_finished"]
        if not self._sync_loop:  # the window, read in full at a log line
            self._drain_losses(loop_state,
                               keep=0 if log_due else self.sync_window)
        if log_due:
            if self._sync_loop:
                throughput = n_records / max(metrics.get("compute"), 1e-9)
            else:  # dispatch times nothing of the step: the wall clock
                now = time.perf_counter()
                throughput = self._log_records / max(now - self._log_t0,
                                                     1e-9)
                self._log_t0 = now
                self._last_throughput = throughput
            self._log_records = 0
            metrics.set_value("throughput", round(throughput, 1))
            mon = self._numerics_monitor
            if mon is not None and mon.last is not None:
                # the log line, the metrics records and the shipped
                # segments (the cluster's grad-norm skew) read these
                metrics.set_value("grad_norm", round(mon.last["grad_norm"], 6))
                metrics.set_value("update_ratio",
                                  round(mon.last["update_ratio"], 8))
            cost = step_fn.cost
            if cost is not None and throughput > 0 and n_records:
                step_s = n_records / throughput
                metrics.set_value("mfu", round(cost.mfu(step_s), 5))
                metrics.set_value("bytes_per_sec",
                                  round(cost.bytes_per_s(step_s), 1))
                programs.get_program_registry().record_mfu(
                    step_fn.program, cost.mfu(step_s))
            # the HBM ledger rides the log cadence (rate-limited by its
            # own knob)
            programs.get_hbm_ledger().maybe_sample()
            logger.info(
                "[Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                "Throughput is %.1f records/second. Loss is %.4f. %s",
                loop_state["epoch"]
                + (0 if loop_state["epoch_finished"] else 1),
                loop_state["records_processed"],
                batches_per_epoch * n_records, it,
                time.time() - wall_start, throughput, loop_state["loss"],
                metrics.summary())
        if self.train_summary is not None:
            self._write_summary(params, loop_state, n_records)
        return params, model_state, opt_states

    def _write_summary(self, params, loop_state, n_records):
        """The iteration's training scalars (optimizer.py:928-954): the
        sync loop's Loss, Throughput (the sync loop's step, the async
        loop's rate at its last log line), the first method's
        LearningRate, with numerics the latest drained GradNorm and
        UpdateRatio, and the Parameters histograms when they are due
        (per layer from the drained stats)."""
        summary, it = self.train_summary, loop_state["neval"]
        if self._sync_loop:
            summary.add_scalar("Loss", loop_state["loss"], it)
            throughput = n_records / max(self.metrics.get("compute"), 1e-9)
        else:
            throughput = self._last_throughput
        summary.add_scalar("Throughput", throughput, it)
        summary.add_scalar(
            "LearningRate",
            sorted(self.optim_methods.items())[0][1].current_rate(), it)
        mon = self._numerics_monitor
        if mon is not None and mon.last is not None:
            summary.add_scalar("GradNorm", mon.last["grad_norm"],
                               mon.last["iteration"])
            summary.add_scalar("UpdateRatio", mon.last["update_ratio"],
                               mon.last["iteration"])
        maybe = getattr(summary, "maybe_add_parameters", None)
        if maybe is not None:
            maybe(params, it,
                  stats=mon.last_stats if mon is not None else None)
