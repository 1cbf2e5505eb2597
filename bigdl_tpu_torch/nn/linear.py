"""Dense layers (counterpart of bigdl_tpu/nn/linear.py).

Weights keep the JAX package's layouts: ``Linear.weight`` is
``(in, out)`` (``y = x @ weight + bias``), ``Bilinear.weight`` ``(out,
in1, in2)``, ``Euclidean.weight`` ``(in, out)``, ``Cosine.weight``
``(out, in)``; ``Maxout`` holds its inner Linear's ``weight``/``bias``
at its own level and ``Highway`` its two Linears under ``gate`` and
``transform``, as the JAX params trees do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.init import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.module import Module


class Linear(Module):
    """``y = x @ weight + bias`` with an ``(in, out)`` weight, as the
    JAX layer stores it (bigdl_tpu/nn/linear.py:17); no bias without
    ``with_bias``."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        self.weight = torch.nn.Parameter(torch.empty(input_size,
                                                     output_size))
        self.bias = (torch.nn.Parameter(torch.empty(output_size))
                     if with_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(self.weight_init(
                generator, (self.input_size, self.output_size),
                fan_in=self.input_size, fan_out=self.output_size))
            if self.bias is not None:
                self.bias.copy_(self.bias_init(
                    generator, (self.output_size,), fan_in=self.input_size))

    def forward(self, x):
        y = x @ self.weight.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def _uniform(generator, shape, bound):
    return RandomUniform(-bound, bound)(generator, shape)


class Bilinear(Module):
    """``y_k = x1 W_k x2 + b_k`` over a table ``(x1, x2)`` (reference
    nn/Bilinear): ``weight`` (out, in1, in2) U(+-1/sqrt(in1 * in2)),
    ``bias`` zeros."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight = torch.nn.Parameter(
            torch.empty(output_size, input_size1, input_size2))
        self.bias = (torch.nn.Parameter(torch.zeros(output_size))
                     if with_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.input_size1 * self.input_size2)
        with torch.no_grad():
            self.weight.copy_(_uniform(generator, tuple(self.weight.shape),
                                       bound))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, inputs):
        if isinstance(inputs, dict):  # a Table: 1-based keys
            x1, x2 = inputs[1], inputs[2]
        else:
            x1, x2 = inputs
        y = torch.einsum("bi,oij,bj->bo", x1, self.weight.to(x1.dtype), x2)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Euclidean(Module):
    """Distances of the input to ``output_size`` centres, the columns of
    an ``(in, out)`` weight: ``y_j = ||x - w[:, j]||`` (reference
    nn/Euclidean.scala)."""

    def __init__(self, input_size: int, output_size: int, name=None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.weight = torch.nn.Parameter(torch.empty(input_size,
                                                     output_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(_uniform(generator, tuple(self.weight.shape),
                                       1.0 / math.sqrt(self.input_size)))

    def forward(self, x):
        w = self.weight.to(x.dtype)
        xb = x[None] if x.dim() == 1 else x
        d = xb[:, :, None] - w[None]  # (B, in, out)
        y = torch.sqrt(torch.sum(d * d, dim=1))
        return y[0] if x.dim() == 1 else y


class Cosine(Module):
    """Cosine similarity of the input to the rows of an ``(out, in)``
    weight, norms clamped at 1e-12 (reference nn/Cosine.scala)."""

    def __init__(self, input_size: int, output_size: int, name=None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.weight = torch.nn.Parameter(torch.empty(output_size,
                                                     input_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(_uniform(generator, tuple(self.weight.shape),
                                       1.0 / math.sqrt(self.input_size)))

    def forward(self, x):
        w = self.weight.to(x.dtype)
        xb = x[None] if x.dim() == 1 else x
        xn = torch.clamp_min(torch.linalg.vector_norm(xb, dim=-1,
                                                      keepdim=True), 1e-12)
        wn = torch.clamp_min(torch.linalg.vector_norm(w, dim=-1), 1e-12)
        y = (xb @ w.T) / (xn * wn[None])
        return y[0] if x.dim() == 1 else y


class Maxout(Module):
    """The max over ``maxout_number`` linear maps (reference
    nn/Maxout.scala): one ``(in, out * k)`` weight and ``(out * k,)``
    bias, initialised as a Linear's, then the max over the k groups of
    ``out``."""

    def __init__(self, input_size: int, output_size: int,
                 maxout_number: int, with_bias: bool = True, name=None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.maxout_number = maxout_number
        k = output_size * maxout_number
        self.weight = torch.nn.Parameter(torch.empty(input_size, k))
        self.bias = (torch.nn.Parameter(torch.empty(k)) if with_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        init = RandomUniform()
        n_in, k = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(init(generator, (n_in, k), fan_in=n_in,
                                   fan_out=k))
            if self.bias is not None:
                self.bias.copy_(init(generator, (k,), fan_in=n_in))

    def forward(self, x):
        y = x @ self.weight.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        y = y.reshape(y.shape[:-1] + (self.maxout_number, self.output_size))
        return torch.amax(y, dim=-2)


class Highway(Module):
    """``t = sigmoid(gate(x)); y = t * act(transform(x)) + (1 - t) * x``
    (reference nn/Highway.scala); ``activation`` is a parameter-free
    layer or None (the identity), held outside the module's variables."""

    def __init__(self, size: int, with_bias: bool = True,
                 activation: Optional[Module] = None, name=None):
        super().__init__(name)
        self.size = size
        self.gate = Linear(size, size, with_bias=with_bias)
        self.transform = Linear(size, size, with_bias=with_bias)
        self.__dict__["activation"] = activation

    def forward(self, x):
        t = torch.sigmoid(self.gate(x))
        h = self.transform(x)
        if self.activation is not None:
            h = self.activation(h)
        return t * h + (1.0 - t) * x


class CMul(Module):
    """A learned scale of ``size``, broadcast over the input, ones."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.weight = torch.nn.Parameter(torch.ones(self.size))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        return x * self.weight.to(x.dtype)


class CAdd(Module):
    """A learned bias of ``size``, broadcast over the input, zeros."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(size)
        self.bias = torch.nn.Parameter(torch.zeros(self.size))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return x + self.bias.to(x.dtype)


class Mul(Module):
    """One learned scalar factor (a 0-dim ``weight``), one."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.weight = torch.nn.Parameter(torch.ones(()))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        return x * self.weight.to(x.dtype)


class Add(Module):
    """A learned bias vector of ``input_size``, zeros."""

    def __init__(self, input_size: int, name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.bias = torch.nn.Parameter(torch.zeros(input_size))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return x + self.bias.to(x.dtype)
