"""Optimization methods (counterpart of bigdl_tpu/optim/optim_method.py:
34-197).

Every method is a pair ``init_state(params)`` /
``update(grads, state, params, lr, step)`` over flat dicts of tensors
keyed by parameter name (``named_parameters`` names, which are the JAX
tree's paths joined by ``.``), returning new dicts.  The updates are
plain tensor arithmetic under ``torch.no_grad()`` in f32, the JAX
package's update rules written out: not ``torch.optim``, whose SGD seeds
its momentum buffer differently.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


class OptimMethod:
    """Base class; subclasses set hyper-parameters and implement the
    pair."""

    def __init__(self, learning_rate: float = 1e-3,
                 schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.schedule = schedule or Default()
        # host-side bookkeeping as in the reference OptimMethod.state;
        # the training loop advances it
        self.state: Dict[str, Any] = {"epoch": 0, "neval": 0}

    def init_state(self, params: Params) -> State:
        return {}

    def update(self, grads: Params, opt_state: State, params: Params,
               lr: float, step: Optional[int] = None
               ) -> Tuple[Params, State]:
        raise NotImplementedError

    def current_rate(self) -> float:
        """LR for the current host step (schedule applied)."""
        return self.learning_rate * self.schedule.rate(
            self.state["neval"], self.state["epoch"])


class SGD(OptimMethod):
    """SGD with momentum / nesterov / dampening / weight decay (reference
    optim/SGD.scala).  ``dampening`` defaults to ``momentum`` and the
    velocity starts at 0, so the first step's velocity is
    ``(1 - dampening) * g``."""

    def __init__(self, learning_rate: float = 1e-3, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.weight_decay = weight_decay
        if nesterov and (momentum <= 0 or self.dampening != 0.0):
            raise ValueError("nesterov needs momentum > 0 and dampening "
                             "== 0")

    def init_state(self, params: Params) -> State:
        if self.momentum <= 0:
            return {}
        return {"velocity": {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        wd = self.weight_decay
        eff = {k: g.float() + wd * params[k].float() if wd else g.float()
               for k, g in grads.items()}
        new_state: State = {}
        if self.momentum > 0:
            vel = {k: self.momentum * opt_state["velocity"][k]
                   + (1.0 - self.dampening) * g for k, g in eff.items()}
            if self.nesterov:
                eff = {k: g + self.momentum * vel[k] for k, g in eff.items()}
            else:
                eff = vel
            new_state = {"velocity": vel}
        new_params = {k: (p.float() - lr * eff[k]).to(p.dtype)
                      for k, p in params.items()}
        return new_params, new_state


class Adam(OptimMethod):
    """Adam (reference optim/Adam.scala; bigdl_tpu/optim/optim_method.py:
    154-197).  ``m`` and ``v`` are f32; the bias correction uses the
    step argument (1-based; 1 when ``None``), computed in f32 as the JAX
    update computes it."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def init_state(self, params: Params) -> State:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
        return {"m": zeros(), "v": zeros()}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        t = np.float32(1.0 if step is None else step)
        b1, b2 = self.beta1, self.beta2
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        new_p, new_m, new_v = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            if self.weight_decay:
                g = g + self.weight_decay * p.float()
            m = b1 * opt_state["m"][k] + (1 - b1) * g
            v = b2 * opt_state["v"][k] + (1 - b2) * torch.square(g)
            upd = lr * (m / c1) / (torch.sqrt(v / c2) + self.epsilon)
            new_p[k] = (p.float() - upd).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}
