"""Activations (counterpart of bigdl_tpu/nn/activation.py).

The parameter-free ones map every tensor of their input, a tensor or a
table of them, as the JAX layers ``tree_map``.  Constants are applied in
x's type, as JAX's weakly typed Python scalars are.  The learned ones
keep the JAX leaves: ``PReLU.weight``, ``SReLU.{t_left, a_left,
t_right, a_right}``, ``Scale.{weight, bias}``.  ``RReLU`` in training
draws its slopes from the port's seed streams
(:func:`bigdl_tpu_torch.nn.dropout.uniform`): JAX's law, not its stream.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module, Seed, tree_map


def _scalar(v, x: torch.Tensor) -> torch.Tensor:
    """The Python number ``v`` rounded to x's type, on x's device."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


class _Elementwise(Module):
    def _f(self, x):
        raise NotImplementedError

    def forward(self, x):
        return tree_map(self._f, x)


class ReLU(_Elementwise):
    def _f(self, x):
        return torch.relu(x)


class ReLU6(_Elementwise):
    """``min(max(x, 0), 6)`` with no gradient at either end
    (``jax.nn.relu6``)."""

    def _f(self, x):
        return torch.where(x >= 6.0, _scalar(6.0, x), torch.relu(x))


class Tanh(_Elementwise):
    def _f(self, x):
        return torch.tanh(x)


class Sigmoid(_Elementwise):
    def _f(self, x):
        return torch.sigmoid(x)


def _clip(x, lo, hi):
    """``jnp.clip``: min of max, so a value on a bound gets half the
    gradient, as JAX gives it."""
    return torch.minimum(torch.maximum(x, _scalar(lo, x)), _scalar(hi, x))


class HardSigmoid(_Elementwise):
    def _f(self, x):
        return _clip(_scalar(0.2, x) * x + _scalar(0.5, x), 0.0, 1.0)


class HardTanh(Module):
    def __init__(self, min_value=-1.0, max_value=1.0, name=None):
        super().__init__(name)
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return _clip(x, self.min_value, self.max_value)


class ELU(Module):
    def __init__(self, alpha: float = 1.0, name=None):
        super().__init__(name)
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(_Elementwise):
    def _f(self, x):
        return F.selu(x)


class GELU(_Elementwise):
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""

    def _f(self, x):
        return F.gelu(x, approximate="tanh")


class Swish(_Elementwise):
    def _f(self, x):
        return F.silu(x)


def _softplus(x):
    """``log(1 + exp(x))`` with no linear cut-off (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Mish(_Elementwise):
    def _f(self, x):
        return x * torch.tanh(_softplus(x))


class SoftPlus(Module):
    def __init__(self, beta: float = 1.0, name=None):
        super().__init__(name)
        self.beta = beta

    def forward(self, x):
        return _softplus(_scalar(self.beta, x) * x) / _scalar(self.beta, x)


class SoftSign(_Elementwise):
    def _f(self, x):
        return x / (1 + torch.abs(x))


class LeakyReLU(Module):
    def __init__(self, negval: float = 0.01, name=None):
        super().__init__(name)
        self.negval = negval

    def forward(self, x):
        return torch.where(x >= 0, x, _scalar(self.negval, x) * x)


class PReLU(Module):
    """Learned leaky slope per channel (the last dim), ``weight``
    initialised to 0.25 (reference nn/PReLU)."""

    def __init__(self, n_output_plane: int = 1, name=None):
        super().__init__(name)
        self.n_output_plane = n_output_plane
        self.weight = torch.nn.Parameter(torch.full((n_output_plane,), 0.25))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class RReLU(Module):
    """Randomised leaky ReLU (reference nn/RReLU): slopes ~ U(lower,
    upper) per element in training with an ``rng``, else their mean."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 name=None):
        super().__init__(name)
        self.lower, self.upper = lower, upper

    def forward(self, x, rng: Optional[Seed] = None):
        if self.training and rng is not None:
            from bigdl_tpu_torch.nn.dropout import uniform

            u = uniform(x.shape, rng, x.device, torch.float32)
            a = (self.lower + (self.upper - self.lower) * u).to(x.dtype)
        else:
            a = _scalar((self.lower + self.upper) / 2.0, x)
        return torch.where(x >= 0, x, a * x)


class Threshold(Module):
    def __init__(self, th: float = 1e-6, v: float = 0.0, name=None):
        super().__init__(name)
        self.th, self.v = th, v

    def forward(self, x):
        return torch.where(x > self.th, x, _scalar(self.v, x))


class SoftMax(Module):
    def __init__(self, axis: int = -1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.softmax(x, dim=self.axis)


class LogSoftMax(Module):
    def __init__(self, axis: int = -1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.log_softmax(x, dim=self.axis)


class SoftMin(Module):
    def __init__(self, axis: int = -1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.softmax(-x, dim=self.axis)


class Power(Module):
    """``(shift + scale * x) ** power`` (reference nn/Power)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 name=None):
        super().__init__(name)
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        base = _scalar(self.shift, x) + _scalar(self.scale, x) * x
        return torch.pow(base, self.power)


class Square(_Elementwise):
    def _f(self, x):
        return torch.square(x)


class Sqrt(_Elementwise):
    def _f(self, x):
        return torch.sqrt(x)


class Log(_Elementwise):
    def _f(self, x):
        return torch.log(x)


class Exp(_Elementwise):
    def _f(self, x):
        return torch.exp(x)


class Abs(_Elementwise):
    def _f(self, x):
        return torch.abs(x)


class Clamp(HardTanh):
    def __init__(self, min_value, max_value, name=None):
        super().__init__(min_value, max_value, name)


class Negative(_Elementwise):
    def _f(self, x):
        return -x


class HardShrink(Module):
    """``x`` where ``|x| > lam``, else 0 (reference nn/HardShrink)."""

    def __init__(self, lam: float = 0.5, name=None):
        super().__init__(name)
        self.lam = lam

    def forward(self, x):
        return torch.where(torch.abs(x) > self.lam, x, torch.zeros_like(x))


class SoftShrink(Module):
    """``sign(x) * max(|x| - lam, 0)`` (reference nn/SoftShrink)."""

    def __init__(self, lam: float = 0.5, name=None):
        super().__init__(name)
        self.lam = lam

    def forward(self, x):
        return torch.sign(x) * torch.clamp_min(
            torch.abs(x) - _scalar(self.lam, x), 0.0)


class TanhShrink(_Elementwise):
    def _f(self, x):
        return x - torch.tanh(x)


class LogSigmoid(_Elementwise):
    def _f(self, x):
        return F.logsigmoid(x)


class BinaryThreshold(Module):
    """1 where ``x > th``, else 0, in x's type (no gradient)."""

    def __init__(self, th: float = 1e-6, name=None):
        super().__init__(name)
        self.th = th

    def forward(self, x):
        return (x > self.th).to(x.dtype)


class SReLU(Module):
    """S-shaped ReLU (reference nn/SReLU.scala): ``t_right + a_right *
    (x - t_right)`` for ``x >= t_right``, ``t_left + a_left * (x -
    t_left)`` for ``x <= t_left``, ``x`` between.  Four learned tensors
    of ``shape`` (the per-sample trailing dims), size 1 along the 1-based
    ``shared_axes``; initialised as bigdl_tpu/nn/activation.py:287-298:
    ``t_left`` 0, ``a_left`` and ``t_right`` U(+-sqrt(3 / size)),
    ``a_right`` 1."""

    def __init__(self, shape, shared_axes=None, name=None):
        super().__init__(name)
        self.shape = tuple(int(s) for s in shape)
        self.shared_axes = tuple(shared_axes or ())
        ps = self._param_shape()
        self.t_left = torch.nn.Parameter(torch.zeros(ps))
        self.a_left = torch.nn.Parameter(torch.empty(ps))
        self.t_right = torch.nn.Parameter(torch.empty(ps))
        self.a_right = torch.nn.Parameter(torch.ones(ps))
        self.reset_parameters()

    def _param_shape(self):
        s = list(self.shape)
        for ax in self.shared_axes:
            s[ax - 1] = 1
        return tuple(s)

    def reset_parameters(self, generator=None):
        ps = self._param_shape()
        bound = math.sqrt(6.0 / (2.0 * max(1, math.prod(ps))))
        with torch.no_grad():
            self.t_left.zero_()
            self.a_left.uniform_(-bound, bound, generator=generator)
            self.t_right.uniform_(-bound, bound, generator=generator)
            self.a_right.fill_(1.0)

    def forward(self, x):
        tl, al = self.t_left.to(x.dtype), self.a_left.to(x.dtype)
        tr, ar = self.t_right.to(x.dtype), self.a_right.to(x.dtype)
        y = torch.where(x >= tr, tr + ar * (x - tr), x)
        return torch.where(x <= tl, tl + al * (x - tl), y)


class Scale(Module):
    """``x * weight + bias`` with learned tensors of ``size`` (reference
    nn/Scale), initialised to 1 and 0."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.weight = torch.nn.Parameter(torch.ones(self.size))
        self.bias = torch.nn.Parameter(torch.zeros(self.size))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)
