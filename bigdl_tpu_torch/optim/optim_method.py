"""Optimization methods (counterpart of bigdl_tpu/optim/optim_method.py:
34-573).

Every method is a pair ``init_state(params)`` /
``update(grads, state, params, lr, step)`` over flat dicts of tensors
keyed by parameter name (``named_parameters`` names, which are the JAX
tree's paths joined by ``.``), returning new dicts.  ``lr`` and the
1-based ``step`` are Python numbers or 0-dim tensors on the parameters'
device, as the JAX update takes traced values: whatever depends on them
is computed on that device, so one captured train step serves every
iteration with new values in its scalar tensors.  The updates are
plain tensor arithmetic under ``torch.no_grad()`` in f32, the JAX
package's update rules written out: not ``torch.optim``, whose SGD seeds
its momentum buffer differently.  Every state slot is f32; a new
parameter is computed in f32 and cast back to the parameter's dtype.

``LarsSGD`` takes its trust ratio per parameter leaf, in f32, inside the
step.  ``LBFGS`` (with :func:`wolfe_line_search`) is driven by the host
over a flat vector through ``optimize(feval, x)``, as the other methods'
``optimize`` is: ``feval(x) -> (loss, grad)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]
Scalar = Union[float, torch.Tensor]


def _zeros(params: Params, fill: float = 0.0) -> Params:
    return {k: torch.full(p.shape, fill, dtype=torch.float32,
                          device=p.device) for k, p in params.items()}


def _step_f32(step: Optional[Scalar], grads: Params) -> torch.Tensor:
    """The 1-based step (1 when ``None``) as an f32 scalar on the
    gradients' device, the JAX update's ``step.astype(float32)``."""
    device = next(iter(grads.values())).device
    return torch.as_tensor(1 if step is None else step,
                           device=device).to(torch.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.float())))


class OptimMethod:
    """Base class; subclasses set hyper-parameters and implement the
    pair."""

    def __init__(self, learning_rate: float = 1e-3,
                 schedule: Optional[LearningRateSchedule] = None):
        self.learning_rate = learning_rate
        self.schedule = schedule or Default()
        # host-side bookkeeping as in the reference OptimMethod.state;
        # the training loop advances it
        self.state: Dict[str, Any] = {"epoch": 0, "neval": 0,
                                      "records_processed": 0, "score": 0.0}

    def init_state(self, params: Params) -> State:
        return {}

    def update(self, grads: Params, opt_state: State, params: Params,
               lr: Scalar, step: Optional[Scalar] = None
               ) -> Tuple[Params, State]:
        raise NotImplementedError

    def leaf_norms(self, grads: Params, params: Params) -> Optional[Dict]:
        """What the update needs of each whole leaf beyond its elements,
        or ``None`` when it is elementwise.  ZeRO-1
        (``parallel/data_parallel.py``) takes it from the whole leaves
        and hands it to :meth:`update` of a row shard as ``norms=``."""
        return None

    # -- host-side helpers (optim_method.py:61-95) ----------------------
    def current_rate(self) -> float:
        """LR for the current host step (schedule applied; an additive
        schedule is first bound to the base rate)."""
        self.schedule.bind(self.learning_rate)
        return self.learning_rate * self.schedule.rate(
            self.state["neval"], self.state["epoch"])

    def get_hyper_parameter(self) -> str:
        return f"lr={self.current_rate():.6g}"

    def optimize(self, feval: Callable, x: torch.Tensor):
        """One step on a flat parameter vector, the reference signature
        (OptimMethod.scala:38): ``feval(x) -> (loss, grad)``.  Returns
        ``(x', [loss])``."""
        loss, grad = feval(x)
        if not hasattr(self, "_flat_state"):
            self._flat_state = self.init_state({"x": x})
        new, self._flat_state = self.update(
            {"x": grad}, self._flat_state, {"x": x}, self.current_rate(),
            self.state["neval"] + 1)
        self.state["neval"] += 1
        return new["x"], [loss]

    def save(self, path: str):
        from bigdl_tpu_torch.utils.serialization import save_pytree

        save_pytree(path, {"class": type(self).__name__,
                           "learning_rate": self.learning_rate,
                           "state": dict(self.state)})

    def load_state(self, blob: Dict[str, Any]):
        self.state.update(blob.get("state", {}))
        return self


class SGD(OptimMethod):
    """SGD with momentum / nesterov / dampening / weight decay (reference
    optim/SGD.scala).  ``dampening`` defaults to ``momentum`` and the
    velocity starts at 0, so the first step's velocity is
    ``(1 - dampening) * g``.  Momentum, dampening and weight decay are
    constants of the method; the step does not enter the update, and
    ``lr`` multiplies it as a number or a device tensor alike."""

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
        return {"velocity": _zeros(params)}

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
    154-197).  ``m`` and ``v`` are f32; the bias corrections ``1 - b**t``
    use the step argument (1-based; 1 when ``None``) in f32 on the
    parameters' device, as the JAX update's ``jnp.power(b1, t)`` on its
    traced ``t``."""

    def __init__(self, learning_rate: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def init_state(self, params: Params) -> State:
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        t = _step_f32(step, grads)
        b1, b2 = self.beta1, self.beta2
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
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


class AdamW(Adam):
    """Adam with decoupled weight decay: the Adam step without decay,
    then ``p - lr * wd * p`` on the old parameter (optim_method.py:
    203-217)."""

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        wd, self.weight_decay = self.weight_decay, 0.0
        try:
            new_p, st = super().update(grads, opt_state, params, lr, step)
        finally:
            self.weight_decay = wd
        if wd:
            new_p = {k: (q.float() - lr * wd * params[k].float()
                         ).to(params[k].dtype) for k, q in new_p.items()}
        return new_p, st


class Adagrad(OptimMethod):
    """Adagrad (reference optim/Adagrad.scala; optim_method.py:220-248):
    the rate decays as ``lr / (1 + (t - 1) * learning_rate_decay)``."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, epsilon: float = 1e-10,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.epsilon = epsilon

    def init_state(self, params):
        return {"accum": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        t = _step_f32(step, grads)
        clr = lr / (1.0 + (t - 1.0) * self.learning_rate_decay)
        new_p, new_a = {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            if self.weight_decay:
                g = g + self.weight_decay * p.float()
            a = opt_state["accum"][k] + torch.square(g)
            new_p[k] = (p.float() - clr * g / (torch.sqrt(a) + self.epsilon)
                        ).to(p.dtype)
            new_a[k] = a
        return new_p, {"accum": new_a}


class Adadelta(OptimMethod):
    """Adadelta (reference optim/Adadelta.scala; optim_method.py:
    251-274); the rate is usually 1."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10,
                 learning_rate: float = 1.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.rho = decay_rate
        self.epsilon = epsilon

    def init_state(self, params):
        return {"accum": _zeros(params), "delta_accum": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        rho, eps = self.rho, self.epsilon
        new_p, new_a, new_d = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            a = rho * opt_state["accum"][k] + (1 - rho) * torch.square(g)
            upd = g * torch.sqrt(opt_state["delta_accum"][k] + eps) \
                / torch.sqrt(a + eps)
            new_d[k] = rho * opt_state["delta_accum"][k] \
                + (1 - rho) * torch.square(upd)
            new_p[k] = (p.float() - lr * upd).to(p.dtype)
            new_a[k] = a
        return new_p, {"accum": new_a, "delta_accum": new_d}


class Adamax(OptimMethod):
    """Adamax (reference optim/Adamax.scala; optim_method.py:277-303)."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        t = _step_f32(step, grads)
        b1, b2 = self.beta1, self.beta2
        clr = lr / (1 - torch.pow(b1, t))
        new_p, new_m, new_u = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            m = b1 * opt_state["m"][k] + (1 - b1) * g
            u = torch.maximum(b2 * opt_state["u"][k],
                              torch.abs(g) + self.epsilon)
            # u is 0 where the gradient is: a floor keeps 0 / 0 out
            new_p[k] = (p.float() - clr * m / torch.clamp_min(u, 1e-30)
                        ).to(p.dtype)
            new_m[k], new_u[k] = m, u
        return new_p, {"m": new_m, "u": new_u}


class RMSprop(OptimMethod):
    """RMSprop (reference optim/RMSprop.scala; optim_method.py:306-330)."""

    def __init__(self, learning_rate: float = 1e-2, decay_rate: float = 0.99,
                 epsilon: float = 1e-8,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.decay_rate = decay_rate
        self.epsilon = epsilon

    def init_state(self, params):
        return {"rms": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        rho = self.decay_rate
        new_p, new_r = {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            r = rho * opt_state["rms"][k] + (1 - rho) * torch.square(g)
            new_p[k] = (p.float() - lr * g / (torch.sqrt(r) + self.epsilon)
                        ).to(p.dtype)
            new_r[k] = r
        return new_p, {"rms": new_r}


class Ftrl(OptimMethod):
    """FTRL-proximal (reference optim/Ftrl.scala; optim_method.py:
    333-372)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0):
        super().__init__(learning_rate)
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_state(self, params):
        return {"accum": _zeros(params, self.init_accum),
                "linear": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None):
        new_p, new_n, new_z = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            p32 = p.float()
            n = opt_state["accum"][k]
            g_shrunk = g + 2 * self.l2_shrinkage * p32
            n_new = n + torch.square(g)
            sigma = (torch.pow(n_new, -self.lr_power)
                     - torch.pow(n, -self.lr_power)) / lr
            z = opt_state["linear"][k] + g_shrunk - sigma * p32
            quad = torch.pow(n_new, -self.lr_power) / lr + 2 * self.l2
            p_new = torch.where(torch.abs(z) > self.l1,
                                -(z - torch.sign(z) * self.l1) / quad,
                                torch.zeros_like(z))
            new_p[k] = p_new.to(p.dtype)
            new_n[k], new_z[k] = n_new, z
        return new_p, {"accum": new_n, "linear": new_z}


class LarsSGD(OptimMethod):
    """Layer-wise adaptive rate scaling (reference optim/LarsSGD.scala;
    optim_method.py:401-441), the large-batch ResNet recipe's method:
    per parameter leaf, the trust ratio ``trust * ||w|| / (||g|| + wd *
    ||w||)`` (1 where either norm is 0) scales the rate, with momentum
    ``v = momentum * v + lr * ratio * (g + wd * w)`` and ``w - v``.  The
    norms are f32 sums of squares computed in the step."""

    def __init__(self, learning_rate: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, trust: float = 1.0,
                 schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, schedule)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust = trust

    def init_state(self, params):
        return {"velocity": _zeros(params)}

    @torch.no_grad()
    def leaf_norms(self, grads, params):
        """``{key: (||w||, ||g||)}`` of the whole leaves, in f32."""
        return {k: (_norm(params[k].float()), _norm(g.float()))
                for k, g in grads.items()}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr, step=None, norms=None):
        """``norms`` (from :meth:`leaf_norms`) stands for the norms of
        the leaves when ``grads``/``params`` are row shards of them."""
        wd = self.weight_decay
        new_p, new_v = {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            p32 = p.float()
            w_norm, g_norm = (norms[k] if norms is not None
                              else (_norm(p32), _norm(g)))
            denom = g_norm + wd * w_norm
            ratio = torch.where((w_norm > 0) & (denom > 0),
                                self.trust * w_norm / (denom + 1e-12),
                                torch.ones_like(w_norm))
            v = self.momentum * opt_state["velocity"][k] \
                + lr * ratio * (g + wd * p32)
            new_p[k] = (p32 - v).to(p.dtype)
            new_v[k] = v
        return new_p, {"velocity": new_v}


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a.reshape(-1), b.reshape(-1)))


def wolfe_line_search(feval: Callable, x: torch.Tensor, d: torch.Tensor,
                      loss0, g0: torch.Tensor, lr0: float = 1.0,
                      c1: float = 1e-4, c2: float = 0.9,
                      max_evals: int = 25):
    """Strong-Wolfe line search along ``d`` (optim_method.py:443-511;
    Nocedal & Wright alg. 3.5): double the step until it brackets a
    point, then bisect until sufficient decrease (``c1``) and the
    curvature condition (``c2``) hold.  Returns ``(alpha, loss, grad,
    n_evals)``; when the budget runs out, the best point seen that
    satisfies sufficient decrease (``alpha`` 0 if none)."""
    dphi0 = _dot(g0, d)
    if dphi0 >= 0:  # not a descent direction: a tiny step
        loss, g = feval(x + 1e-8 * d)
        return 1e-8, loss, g, 1
    f0 = float(loss0)

    def phi(alpha):
        loss, g = feval(x + alpha * d)
        return float(loss), g, _dot(g, d)

    def armijo(alpha, phi_a):
        return phi_a <= f0 + c1 * alpha * dphi0

    best = (0.0, f0, g0)
    alpha_prev, phi_prev = 0.0, f0
    alpha = lr0
    evals = 0
    lo = hi = phi_lo = None
    for _ in range(max_evals):
        phi_a, g_a, dphi_a = phi(alpha)
        evals += 1
        if not armijo(alpha, phi_a) or (evals > 1 and phi_a >= phi_prev):
            lo, hi, phi_lo = alpha_prev, alpha, phi_prev
            break
        best = (alpha, phi_a, g_a)
        if abs(dphi_a) <= -c2 * dphi0:
            return alpha, phi_a, g_a, evals
        if dphi_a >= 0:
            lo, hi, phi_lo = alpha, alpha_prev, phi_a
            break
        alpha_prev, phi_prev = alpha, phi_a
        alpha *= 2.0
    else:
        return best[0], best[1], best[2], evals
    for _ in range(max_evals - evals):  # zoom by bisection
        mid = 0.5 * (lo + hi)
        phi_m, g_m, dphi_m = phi(mid)
        evals += 1
        if not armijo(mid, phi_m) or phi_m >= phi_lo:
            hi = mid
        else:
            best = (mid, phi_m, g_m)
            if abs(dphi_m) <= -c2 * dphi0:
                return mid, phi_m, g_m, evals
            if dphi_m * (hi - lo) >= 0:
                hi = lo
            lo, phi_lo = mid, phi_m
    return best[0], best[1], best[2], evals


class LBFGS(OptimMethod):
    """Limited-memory BFGS over a flat parameter vector (reference
    optim/LBFGS.scala; optim_method.py:514-573): the two-loop recursion
    on the host, a fixed step of ``learning_rate`` or, with
    ``line_search="wolfe"``, :func:`wolfe_line_search`.  Pairs with
    ``y.s <= 1e-10`` are dropped, as in the reference."""

    def __init__(self, max_iter: int = 20, history_size: int = 100,
                 learning_rate: float = 1.0, tolerance_grad: float = 1e-10,
                 line_search: Optional[str] = None):
        super().__init__(learning_rate)
        self.max_iter = max_iter
        self.history_size = history_size
        self.tolerance_grad = tolerance_grad
        if line_search not in (None, "wolfe"):
            raise ValueError("line_search must be None or 'wolfe'")
        self.line_search = line_search

    @torch.no_grad()
    def optimize(self, feval, x):
        s_list, y_list = [], []
        loss, g = feval(x)
        losses = [float(loss)]
        for _ in range(self.max_iter):
            if float(torch.max(torch.abs(g))) < self.tolerance_grad:
                break
            q = g.clone()
            alphas = []
            for s, y in reversed(list(zip(s_list, y_list))):
                rho = 1.0 / (torch.dot(y, s) + 1e-10)
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append((rho, a))
            if y_list:
                q = torch.dot(s_list[-1], y_list[-1]) / (
                    torch.dot(y_list[-1], y_list[-1]) + 1e-10) * q
            for (rho, a), (s, y) in zip(reversed(alphas),
                                        zip(s_list, y_list)):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            d = -q
            if self.line_search == "wolfe":
                alpha, loss_new, g_new, _ = wolfe_line_search(
                    feval, x, d, loss, g, lr0=self.learning_rate)
                x_new = x + alpha * d
            else:
                x_new = x + self.learning_rate * d
                loss_new, g_new = feval(x_new)
            s_new, y_new = x_new - x, g_new - g
            if _dot(y_new, s_new) > 1e-10:
                s_list.append(s_new)
                y_list.append(y_new)
            if len(s_list) > self.history_size:
                s_list.pop(0)
                y_list.pop(0)
            x, g, loss = x_new, g_new, loss_new
            losses.append(float(loss_new))
        self.state["neval"] += 1
        return x, losses
