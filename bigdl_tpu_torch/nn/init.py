"""Weight initialization methods (counterpart of bigdl_tpu/nn/init.py).

Each initializer is ``f(generator, shape, dtype, fan_in, fan_out) ->
tensor``: the JAX signature with a CPU ``torch.Generator`` in place of
the PRNG key.  The two frameworks draw different numbers from the same
seed, so parity tests make weights with numpy and load them into both.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


class InitializationMethod:
    def __call__(self, generator: Optional[torch.Generator], shape,
                 dtype=torch.float32, fan_in=None, fan_out=None):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def __call__(self, generator, shape, dtype=torch.float32, fan_in=None,
                 fan_out=None):
        return torch.zeros(shape, dtype=dtype)


class RandomUniform(InitializationMethod):
    """U(lower, upper); defaults to the Torch-style 1/sqrt(fan_in) bound."""

    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        self.lower, self.upper = lower, upper

    def __call__(self, generator, shape, dtype=torch.float32, fan_in=None,
                 fan_out=None):
        if self.lower is None:
            bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.05
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, dtype=dtype).uniform_(
            lo, hi, generator=generator)


class MsraFiller(InitializationMethod):
    """Kaiming/He normal: std ``sqrt(2 / fan_in)``."""

    def __call__(self, generator, shape, dtype=torch.float32, fan_in=None,
                 fan_out=None):
        std = math.sqrt(2.0 / (fan_in or shape[-1]))
        return std * torch.randn(shape, generator=generator, dtype=dtype)


class RandomNormal(InitializationMethod):
    """``mean + stdv * N(0, 1)``."""

    def __init__(self, mean: float = 0.0, stdv: float = 0.01):
        self.mean, self.stdv = mean, stdv

    def __call__(self, generator, shape, dtype=torch.float32, fan_in=None,
                 fan_out=None):
        return self.mean + self.stdv * torch.randn(shape, generator=generator,
                                                   dtype=dtype)


class Xavier(InitializationMethod):
    """Glorot uniform: U(+-sqrt(6 / (fan_in + fan_out)))."""

    def __call__(self, generator, shape, dtype=torch.float32, fan_in=None,
                 fan_out=None):
        fan_in = fan_in or shape[-1]
        fan_out = fan_out or shape[0]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=dtype).uniform_(
            -bound, bound, generator=generator)
