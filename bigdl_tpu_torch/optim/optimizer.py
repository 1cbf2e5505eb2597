"""Training (counterpart of bigdl_tpu/optim/optimizer.py:69-249, 266-373,
381-527, 683-693, 774-987, 1110-1137).

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
random seed (an int, or ``None``); a model whose ``forward`` takes
``rng`` gets it, and its dropout layers draw from streams split off it.
The gradients are clipped (a constant range, then the global f32 L2
norm) before the update.

:class:`Optimizer` is the fluent configuration and :class:`LocalOptimizer` the
synchronous loop of the JAX package (its ``BIGDL_TPU_SYNC_LOOP=1``
path): each iteration places a batch on the device (``data``), runs the
step with the seed ``split_rng(7, neval)`` (as ``fold_in(PRNGKey(7),
neval)``) and reads the loss back (``compute``), moves the
epoch/iteration bookkeeping, logs the reference line ``[Epoch e
n/N][Iteration i][Wall Clock t] Throughput is X records/second. Loss is
Y`` every 10 iterations and at each epoch's end, and validates when the
validation trigger fires (``Loss is Loss(v, n records)``).
:func:`evaluate` runs validation methods over one pass of a dataset.  The
async engine, checkpoints and retry, accumulation, numerics and
telemetry are not ported yet.
"""
from __future__ import annotations

import inspect
import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.module import split_rng
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.utils.convert import load_jax_variables

logger = logging.getLogger("bigdl_tpu_torch.optim")

__all__ = ["Optimizer", "LocalOptimizer", "evaluate", "make_train_step"]

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
    ``step``.  ``rng`` (an int seed or ``None``) goes to the model's
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


def _place(a, device):
    """A batch's numpy array (or list of them) as tensors on ``device``."""
    if isinstance(a, (list, tuple)):
        return [_place(v, device) for v in a]
    return torch.as_tensor(np.asarray(a)).to(device)


@torch.no_grad()
def evaluate(model: torch.nn.Module, params: Tensors, model_state: Tensors,
             dataset: AbstractDataSet, methods: List[ValidationMethod]
             ) -> List[Tuple[ValidationMethod, Optional[ValidationResult]]]:
    """Run ``methods`` over one pass of ``dataset`` with ``params`` and
    ``model_state`` swapped into ``model`` in evaluation mode (reference
    Evaluator.scala:40-100; optimizer.py:1110-1137).  The parameters are
    used as given (the loop's f32 masters).  Returns ``[(method, folded
    result)]``; a result is ``None`` when the dataset had no batch."""
    device = next(iter(params.values())).device
    model.eval()
    totals: List[Optional[ValidationResult]] = [None] * len(methods)
    for batch in dataset.data(train=False):
        out = functional_call(model, {**params, **model_state},
                              (_place(batch.get_input(), device),))
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
        self._initial_variables: Optional[Dict[str, Any]] = None

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
    ``BIGDL_TPU_SYNC_LOOP=1``)."""

    def optimize(self) -> torch.nn.Module:
        model = self.model.to(self.device)
        if self._initial_variables is not None:
            load_jax_variables(model, self._initial_variables)
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        model_state = {k: b.detach().clone()
                       for k, b in model.named_buffers()}
        opt_states = {name: m.init_state(params)
                      for name, m in self.optim_methods.items()}
        step_fn = make_train_step(model, self.criterion, self.optim_methods,
                                  self.grad_clip_const, self.grad_clip_norm,
                                  self.compute_dtype)
        loop_state: Dict[str, Any] = {
            "epoch": 0, "neval": 0, "loss": float("nan"),
            "score": float("-inf"), "records_processed": 0,
            "batch_in_epoch": 0, "epoch_finished": False}
        self._loop_state = loop_state  # train_log_line reads it
        self.metrics = Metrics()
        batches_per_epoch = max(1, self.dataset.batches_per_epoch())
        data_iter = self.dataset.data(train=True)
        wall_start = time.time()
        trees = (params, model_state, opt_states)
        while not self.end_trigger(loop_state):
            trees = self._one_iteration(step_fn, trees, loop_state,
                                        data_iter, batches_per_epoch,
                                        wall_start)
            if loop_state["epoch_finished"]:
                for m in self.optim_methods.values():
                    m.state["epoch"] = loop_state["epoch"]
            self._maybe_validate(model, trees[0], trees[1], loop_state)
            loop_state["epoch_finished"] = False
        params, model_state, _ = trees
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
            for k, b in model.named_buffers():
                b.copy_(model_state[k])
        self.final_params, self.final_state = params, model_state
        return model

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
