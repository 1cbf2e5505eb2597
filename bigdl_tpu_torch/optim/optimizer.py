"""Training (counterpart of bigdl_tpu/optim/optimizer.py:69-249, 266-373,
381-581, 630-693, 774-1050, 1110-1137).

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
0-dim tensors.  The gradients are clipped (a constant range, then the
global f32 L2 norm) before the update.

:class:`CompiledTrainStep` is that step as the JAX optimizer runs it,
``jax.jit(make_train_step(...), donate_argnums=(0, 1, 2))``
(bigdl_tpu/optim/optimizer.py:706-715): one CUDA graph per batch shape
(``utils/graphs.py``), with ``step``, the learning rates and ``rng`` in
device scalars filled before each replay and the three trees donated:
they are the graph's static inputs, and the captured step writes the new
trees into them at its end.  On the CPU the same donated step runs
eagerly.

:class:`Optimizer` is the fluent configuration and :class:`LocalOptimizer` the
synchronous loop of the JAX package (its ``BIGDL_TPU_SYNC_LOOP=1``
path): each iteration places a batch on the device (``data``), runs the
compiled step with the seed ``split_rng(7, neval)`` (as
``fold_in(PRNGKey(7), neval)``) and reads the loss back (``compute``),
moves the epoch/iteration bookkeeping, logs the reference line ``[Epoch e
n/N][Iteration i][Wall Clock t] Throughput is X records/second. Loss is
Y`` every 10 iterations and at each epoch's end, validates when the
validation trigger fires (``Loss is Loss(v, n records)``) and writes a
checkpoint when the checkpoint trigger fires.

Checkpoints are the JAX package's blob, ``{"params", "model_state",
"opt_states", "driver_state"}`` with each tree in JAX's nesting
(``export_variables``/``export_opt_state``) and the loop's int and float
bookkeeping, written by ``save_pytree`` on the loop thread (the JAX
loop's synchronous branch), so either package resumes from the other's.
A loss that is not finite, or a ``RuntimeError`` or ``ValueError`` of
an iteration, restores the latest checkpoint into the compiled step's
trees and goes on, at most ``max_retry`` times in ``retry_window_sec``;
with no checkpoint it is raised again.  ``resume_from`` starts from a
checkpoint: trees, bookkeeping, the optimization methods' counters and
the dataset's cursor, so the run goes on with the batches, seeds and
learning rates of the uninterrupted one.  ``request_stop`` ends the loop
at the next iteration with a final checkpoint.
:func:`evaluate` runs validation methods over one pass of a dataset,
through one compiled forward per model and input shape (JAX's
``_jit_forward``, optimizer.py:1098-1107).  The async engine and its
background checkpoint writer, accumulation, numerics and telemetry are
not ported yet.
"""
from __future__ import annotations

import inspect
import logging
import math
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.module import _signed, split_rng
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.utils import graphs
from bigdl_tpu_torch.utils.convert import (export_opt_state,
                                           export_variables, flatten,
                                           load_jax_variables)
from bigdl_tpu_torch.utils.serialization import (_local, load_pytree,
                                                 save_pytree)

logger = logging.getLogger("bigdl_tpu_torch.optim")

__all__ = ["CompiledTrainStep", "Optimizer", "LocalOptimizer", "evaluate",
           "make_train_step"]

Tensors = Dict[str, torch.Tensor]
_LOOP_SEED = 7  # the loop's root seed, as PRNGKey(7) in the JAX loop


def _clip_grads(grads: Tensors, clip_const: Optional[Tuple[float, float]],
                clip_norm: Optional[float]) -> Tensors:
    """Clip to a constant range, then scale by ``min(1, c / max(norm,
    1e-12))`` with ``norm`` the global f32 L2 norm of every gradient
    (optimizer.py:241-249, utils/flatten.py:61-66)."""
    if clip_const is not None:
        lo, hi = clip_const
        grads = {k: torch.clamp(g, lo, hi) for k, g in grads.items()}
    if clip_norm is not None:
        norm = torch.sqrt(sum(torch.square(g.float()).sum()
                              for g in grads.values()))
        scale = torch.clamp_max(clip_norm / torch.clamp_min(norm, 1e-12),
                                1.0)
        grads = {k: g * scale for k, g in grads.items()}
    return grads


def make_train_step(model: torch.nn.Module, criterion: Criterion,
                    optim_methods: Dict[str, OptimMethod],
                    grad_clip_const: Optional[Tuple[float, float]] = None,
                    grad_clip_norm: Optional[float] = None,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Callable:
    """The train step of bigdl_tpu/optim/optimizer.py:266-373 for one
    micro-batch and the ``"__all__"`` method.

    ``train_step(params, model_state, opt_states, step, rng, features,
    targets, lrs)`` runs ``model`` in training mode on ``features`` with
    ``params``/``model_state`` swapped in (``torch.func.functional_call``),
    takes the gradients of the f32 loss with respect to ``params``, clips
    them (``grad_clip_const`` then ``grad_clip_norm``), and applies each
    method's update with its learning rate from ``lrs`` and the 1-based
    ``step``.  ``rng`` (a seed or ``None``) goes to the model's
    ``forward`` when it takes one, so dropout draws from it.  It returns
    new dicts and the detached f32 loss; the inputs are not changed.
    """
    if set(optim_methods) != {"__all__"}:
        raise NotImplementedError(
            "only the '__all__' optimization method is ported; got "
            f"{sorted(optim_methods)}")
    method = optim_methods["__all__"]
    takes_rng = "rng" in inspect.signature(model.forward).parameters

    def train_step(params, model_state, opt_states, step, rng, features,
                   targets, lrs):
        model.train()
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        cast = ({k: v.to(compute_dtype) for k, v in leaves.items()}
                if compute_dtype is not None else leaves)
        # the modules update their running statistics in place: on copies
        new_state = {k: v.clone() for k, v in model_state.items()}
        kwargs = {"rng": rng} if takes_rng else {}
        with torch.enable_grad():
            out = functional_call(model, {**cast, **new_state}, (features,),
                                  kwargs)
            loss = criterion.forward(out, targets).float()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = _clip_grads(dict(zip(leaves, grads)), grad_clip_const,
                            grad_clip_norm)
        new_params, opt_state = method.update(
            grads, opt_states["__all__"], params, lrs[0], step)
        return new_params, new_state, {"__all__": opt_state}, loss.detach()

    return train_step


class CompiledTrainStep:
    """``step_fn`` (a :func:`make_train_step` step) compiled per batch
    shape with its trees donated; called as the step is, it returns the
    trees it was given, updated in place, and the loss (valid until the
    next call).  ``step``, ``rng`` and ``lrs`` may be Python numbers:
    they are written into device scalars that the graphs read.
    ``graphs`` maps each batch's signature to its compiled call;
    ``captures`` and ``replays`` add them up.  The graphs share one
    memory pool: the first batch, the largest, is captured first."""

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
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
        if fn is None:
            if device.type == "cuda" and self._pool is None:
                self._pool = graphs.new_pool()
            fn = self.graphs[key] = graphs.compile(
                graphs.donate(self.step_fn, (0, 1, 2)), args[:5] + graphs.clone((features, targets))
                + (lrs_t,), self._pool)
        loss = fn(*args)[3]
        return params, model_state, opt_states, loss

    @property
    def captures(self) -> int:
        return sum(getattr(g, "captures", 0) for g in self.graphs.values())

    @property
    def replays(self) -> int:
        return sum(getattr(g, "replays", 0) for g in self.graphs.values())


def _place(a, device):
    """A batch's numpy array (or list of them) as tensors on ``device``."""
    if isinstance(a, (list, tuple)):
        return [_place(v, device) for v in a]
    return torch.as_tensor(np.asarray(a)).to(device)


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
             dataset: AbstractDataSet, methods: List[ValidationMethod]
             ) -> List[Tuple[ValidationMethod, Optional[ValidationResult]]]:
    """Run ``methods`` over one pass of ``dataset`` with ``params`` and
    ``model_state`` swapped into ``model`` in evaluation mode (reference
    Evaluator.scala:40-100; optimizer.py:1110-1137), one compiled forward
    per input shape.  The parameters are used as given (the loop's f32
    masters).  Returns ``[(method, folded result)]``; a result is
    ``None`` when the dataset had no batch."""
    device = next(iter(params.values())).device
    model.eval()
    totals: List[Optional[ValidationResult]] = [None] * len(methods)
    for batch in dataset.data(train=False):
        out = _eval_forward(model, params, model_state,
                            _place(batch.get_input(), device))
        for i, m in enumerate(methods):
            r = m(out, batch.get_target())
            totals[i] = r if totals[i] is None else totals[i] + r
    return list(zip(methods, totals))


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
        self.overwrite_checkpoint = True
        self.max_retry = 5
        self.retry_window_sec = 600.0
        self._resume_from: Optional[str] = None
        self._initial_variables: Optional[Dict[str, Any]] = None
        self._stop_requested = False

    def request_stop(self) -> None:
        """Ask the loop to stop at the next iteration boundary; it writes
        a final checkpoint first (when checkpoints are set).  Safe from
        another thread or a signal handler."""
        self._stop_requested = True

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_methods = {"__all__": method}
        return self

    def set_optim_methods(self, methods: Dict[str, OptimMethod]
                          ) -> "Optimizer":
        """Per-submodule methods; only ``{"__all__": method}`` is ported."""
        if set(methods) != {"__all__"}:
            raise NotImplementedError(
                "only the '__all__' optimization method is ported")
        self.optim_methods = dict(methods)
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
        """Write a checkpoint under the local directory ``path`` whenever
        ``trigger`` fires after an iteration."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
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

    def set_initial_variables(self, variables: Dict[str, Any]
                              ) -> "Optimizer":
        """Start from a JAX-shaped ``{"params", "state"}`` tree of numpy
        arrays (loaded with ``load_jax_variables``) instead of the
        model's current weights."""
        self._initial_variables = variables
        return self

    def optimize(self) -> torch.nn.Module:
        raise NotImplementedError

    def _build_step_fn(self, model: torch.nn.Module) -> CompiledTrainStep:
        """The compiled, donated train step (optimizer.py:706-715)."""
        return CompiledTrainStep(make_train_step(
            model, self.criterion, self.optim_methods, self.grad_clip_const,
            self.grad_clip_norm, self.compute_dtype))

    @staticmethod
    def apply(model, dataset, criterion, end_trigger=None, batch_size=None,
              device: DeviceLike = None) -> "LocalOptimizer":
        """Factory matching the reference Optimizer.apply; the port has
        the single-device loop only, so this is a :class:`LocalOptimizer`.
        ``batch_size`` is accepted for the reference signature: the
        dataset's batches are what the loop reads."""
        return LocalOptimizer(model, dataset, criterion, end_trigger,
                              batch_size, device)


class LocalOptimizer(Optimizer):
    """Single-device synchronous training loop (reference
    LocalOptimizer.scala; bigdl_tpu/optim/optimizer.py:381-527 with
    ``BIGDL_TPU_SYNC_LOOP=1``).  After ``optimize()``, ``train_step`` is
    the :class:`CompiledTrainStep` it ran: on the card its ``captures``
    count the batch shapes and its ``replays`` the iterations."""

    def optimize(self) -> torch.nn.Module:
        model = self.model.to(self.device)
        if self._initial_variables is not None:
            load_jax_variables(model, self._initial_variables)
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        model_state = {k: b.detach().clone()
                       for k, b in model.named_buffers()}
        opt_states = {name: m.init_state(params)
                      for name, m in self.optim_methods.items()}
        step_fn = self.train_step = self._build_step_fn(model)
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
        self.metrics = Metrics()
        batches_per_epoch = max(1, self.dataset.batches_per_epoch())
        data_iter = self.dataset.data(train=True)
        wall_start = time.time()
        self._retries = 0
        self._last_failure = 0.0
        ckpt_dir = self._prepare_ckpt_dir()
        while not self._stop_requested and not self.end_trigger(loop_state):
            try:
                trees = self._one_iteration(step_fn, trees, loop_state,
                                            data_iter, batches_per_epoch,
                                            wall_start)
                if loop_state["epoch_finished"]:
                    for m in self.optim_methods.values():
                        m.state["epoch"] = loop_state["epoch"]
                self._maybe_validate(model, trees[0], trees[1], loop_state)
                self._maybe_checkpoint(ckpt_dir, model, trees, loop_state)
            except (FloatingPointError, RuntimeError, ValueError) as e:
                self._recover_or_reraise(e, ckpt_dir, trees, loop_state)
                continue
            loop_state["epoch_finished"] = False
        if self._stop_requested:
            # the iteration it stopped at, so that a resume goes on there
            self._maybe_checkpoint(ckpt_dir, model, trees, loop_state,
                                   force=True)
        params, model_state, _ = trees
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
            for k, b in model.named_buffers():
                b.copy_(model_state[k])
        self.final_params, self.final_state = params, model_state
        return model

    # -- checkpoints (bigdl_tpu/optim/optimizer.py:529-581, 630-676,
    # 989-1050) --------------------------------------------------------
    def _prepare_ckpt_dir(self) -> Optional[str]:
        """The run's checkpoint directory, made: ``checkpoint_path``
        itself when overwriting, else a timestamped subdirectory."""
        if not self.checkpoint_path:
            return None
        d = _local(self.checkpoint_path)
        if not self.overwrite_checkpoint:
            d = os.path.join(d, time.strftime("%Y%m%d_%H%M%S"))
        os.makedirs(d, exist_ok=True)
        return d

    def _ckpt_file(self, d: str, it: int) -> str:
        return os.path.join(d, "model" if self.overwrite_checkpoint
                            else f"model.{it}")

    @staticmethod
    def _latest_ckpt(d: str) -> Optional[str]:
        """The newest checkpoint in ``d`` (without ``.npz``), or ``None``:
        only ``model.npz`` and ``model.<iteration>.npz`` count, so a
        temporary file left by a killed write is ignored."""
        names = [f for f in os.listdir(d)
                 if re.fullmatch(r"model(\.\d+)?\.npz", f)]
        if not names:
            return None
        latest = max(names, key=lambda f: int(f.split(".")[1])
                     if f.count(".") > 1 else 1 << 60)
        return os.path.join(d, latest[:-len(".npz")])

    def _maybe_checkpoint(self, ckpt_dir, model, trees, loop_state,
                          force: bool = False):
        """Write the blob when the trigger fires (or ``force``): each tree
        copied to host numpy in JAX's nesting, then saved on the loop
        thread, before the next step runs."""
        if not ckpt_dir or not (force or (
                self.checkpoint_trigger is not None
                and self.checkpoint_trigger(loop_state))):
            return
        params, model_state, opt_states = trees
        variables = export_variables(model, params, model_state)
        blob = {
            "params": variables["params"],
            "model_state": variables["state"],
            "opt_states": {name: export_opt_state(model, st)
                           for name, st in opt_states.items()},
            # no bools: a saved epoch_finished would fire the epoch
            # triggers again right after a resume
            "driver_state": {k: v for k, v in loop_state.items()
                             if isinstance(v, (int, float))
                             and not isinstance(v, bool)},
        }
        path = self._ckpt_file(ckpt_dir, loop_state["neval"])
        save_pytree(path, blob)
        logger.info("Checkpoint saved to %s (iteration %d)", path,
                    loop_state["neval"])

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
        is no checkpoint to go back to."""
        now = time.time()
        if now - self._last_failure > self.retry_window_sec:
            self._retries = 0
        self._retries += 1
        self._last_failure = now
        if self._retries > self.max_retry or not ckpt_dir \
                or not self._load_latest(ckpt_dir, trees, loop_state):
            raise e
        logger.warning("Training failure (%s); retry %d from checkpoint "
                       "at iteration %d", e, self._retries,
                       loop_state["neval"])

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
        """Validate when the trigger fires (optimizer.py:964-987): log
        ``<method> is <result>`` per method and keep the first method's
        value as ``loop_state["score"]``."""
        if (self.val_trigger is None or self.val_dataset is None
                or not self.val_methods or not self.val_trigger(loop_state)):
            return
        results = evaluate(model, params, model_state, self.val_dataset,
                           self.val_methods)
        if any(res is None for _, res in results):
            logger.warning("validation produced no batches "
                           "(val set < batch size); skipping")
            return
        for method, res in results:
            logger.info("%s is %s", method.name, res)
        loop_state["score"] = results[0][1].result()[0]

    def _one_iteration(self, step_fn, trees, loop_state, data_iter,
                       batches_per_epoch, wall_start):
        metrics = self.metrics
        with metrics.time("data"):
            batch = next(data_iter)
            features = _place(batch.get_input(), self.device)
            targets = _place(batch.get_target(), self.device)
            n_records = batch.size
        lrs = [m.current_rate() for _, m in sorted(self.optim_methods.items())]
        with metrics.time("compute"):
            params, model_state, opt_states, loss = step_fn(
                *trees, loop_state["neval"] + 1,
                split_rng(_LOOP_SEED, loop_state["neval"]), features,
                targets, lrs)
            loss = float(loss)  # sync point
        if math.isnan(loss) or math.isinf(loss):
            raise FloatingPointError(f"loss diverged: {loss}")
        loop_state["loss"] = loss
        loop_state["neval"] += 1
        loop_state["records_processed"] += n_records
        loop_state["batch_in_epoch"] += 1
        for m in self.optim_methods.values():
            m.state["neval"] = loop_state["neval"]
        if loop_state["batch_in_epoch"] >= batches_per_epoch:
            loop_state["epoch"] += 1
            loop_state["records_processed"] = 0
            loop_state["batch_in_epoch"] = 0
            loop_state["epoch_finished"] = True

        if loop_state["neval"] % 10 == 1 or loop_state["epoch_finished"]:
            throughput = n_records / max(metrics.get("compute"), 1e-9)
            metrics.set_value("throughput", round(throughput, 1))
            logger.info(
                "[Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                "Throughput is %.1f records/second. Loss is %.4f. %s",
                loop_state["epoch"]
                + (0 if loop_state["epoch_finished"] else 1),
                loop_state["records_processed"],
                batches_per_epoch * n_records, loop_state["neval"],
                time.time() - wall_start, throughput, loop_state["loss"],
                metrics.summary())
        return params, model_state, opt_states
