"""Dropout (counterpart of bigdl_tpu/nn/dropout.py).

Random numbers come from an explicit seed threaded through ``forward``
(the port's counterpart of the JAX ``rng`` key; see
:func:`bigdl_tpu_torch.nn.module.split_rng`), never from torch's global
generator.  The seed is an int or a 0-dim int64 tensor, and the mask is
a function of the seed alone, computed by tensor ops on x's device:
element ``j`` of x reads 32 bits of splitmix64's output ``j // 2``,
``mix64(seed + (j // 2 + 1) * 0x9E3779B97F4A7C15)``, and is kept when
they fall below ``(1 - p) * 2**32``.  So the same seed gives the same
mask eagerly, on either device and in a CUDA graph replayed with that
seed in its seed tensor; a new seed gives a new mask on every replay.
Torch cannot reproduce JAX's threefry bits, so the two packages drop
different elements from the same seed; the tests hold the distribution,
not the mask.

A tensor that is one rank's part of a sharded activation takes its part
of the global tensor's mask (``part``: the split dims, this rank's
index and the parts of each), so a tensor-parallel layer drops what the
one-rank layer drops; a replicated activation takes the whole mask on
every rank by construction.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.nn.module import Module, Seed, _lsr, _signed, mix64

_GAMMA = _signed(0x9E3779B97F4A7C15)  # splitmix64's increment


def _seed_tensor(rng: Seed, device) -> torch.Tensor:
    if torch.is_tensor(rng):
        return rng.to(device=device, dtype=torch.int64)
    return torch.tensor(_signed(rng), dtype=torch.int64, device=device)


Part = Sequence[Tuple[int, int, int]]  # (dim, index, parts) per split dim


def _global_index(shape, part: Part, device) -> torch.Tensor:
    """The flat index in the global tensor of each element of this
    rank's part (int64, ``shape``)."""
    full = list(shape)
    start = [0] * len(shape)
    for dim, index, parts in part:
        full[dim] = shape[dim] * parts
        start[dim] = index * shape[dim]
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        pos = torch.arange(start[d], start[d] + shape[d], dtype=torch.int64,
                           device=device)
        view = [1] * len(shape)
        view[d] = shape[d]
        idx = idx + pos.view(view) * stride
        stride *= full[d]
    return idx


def keep_mask(shape, p: float, rng: Seed, device,
              part: Optional[Part] = None) -> torch.Tensor:
    """The boolean mask of the elements dropout keeps (each with
    probability ``1 - p``) for seed ``rng``; see the module's
    docstring.  ``part``: ``shape`` is this rank's part of a global
    tensor split on those dims, and the mask is the global mask's part."""
    threshold = math.floor((1.0 - p) * 2 ** 32) - 2 ** 31
    if part:
        j = _global_index(shape, part, device)
        bits = mix64(torch.add(_seed_tensor(rng, device), j // 2 + 1,
                               alpha=_GAMMA))
        # element j reads the low (even j) or the high (odd j) 32 bits
        half = torch.where(j % 2 == 0, bits, _lsr(bits, 32)) & 0xFFFFFFFF
        u = torch.where(half >= 2 ** 31, half - 2 ** 32, half)  # as int32
        return u < threshold
    n = math.prod(shape)
    idx = torch.arange(1, (n + 1) // 2 + 1, dtype=torch.int64, device=device)
    bits = mix64(torch.add(_seed_tensor(rng, device), idx, alpha=_GAMMA))
    # two 32-bit draws per 64-bit output; signed, so shifted by 2**31
    u = bits.view(torch.int32)[:n]
    return (u < threshold).reshape(shape)


def random_bits(n: int, rng: Seed, device) -> torch.Tensor:
    """``n`` 32-bit draws for seed ``rng`` (int64 in ``[0, 2**32)``):
    draw ``j`` is 32 bits of ``mix64(seed + (j // 2 + 1) * gamma)``, the
    words :func:`keep_mask` reads."""
    idx = torch.arange(1, (n + 1) // 2 + 1, dtype=torch.int64, device=device)
    bits = mix64(torch.add(_seed_tensor(rng, device), idx, alpha=_GAMMA))
    return bits.view(torch.int32)[:n].to(torch.int64) & 0xFFFFFFFF


def uniform(shape, rng: Seed, device, dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) of ``shape`` for seed ``rng``: the top 24 bits of each
    draw of :func:`random_bits`, exact in f32, then cast to ``dtype``."""
    n = math.prod(shape)
    u = (random_bits(n, rng, device) >> 8).to(torch.float32) * 2.0 ** -24
    return u.reshape(shape).to(dtype)


def normal(shape, rng: Seed, device, dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) of ``shape`` for seed ``rng``: Box-Muller in f32 over two
    uniforms per element (draws ``j`` and ``n + j``), cast to ``dtype``.
    The law is JAX's ``jax.random.normal``; the stream is not."""
    n = math.prod(shape)
    u = (random_bits(2 * n, rng, device) >> 8).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log1p(-u[:n]))
    z = r * torch.cos((2.0 * math.pi) * u[n:])
    return z.reshape(shape).to(dtype)


def _need_rng(rng: Optional[Seed], layer: str):
    if rng is None:
        raise ValueError(f"{layer} in training mode needs an rng")


def dropout(x: torch.Tensor, p: float, rng: Seed,
            part: Optional[Part] = None) -> torch.Tensor:
    """Inverted dropout of ``x``: each element kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)`` in x's type, else 0;
    ``part`` as for :func:`keep_mask`."""
    keep = 1.0 - p
    mask = keep_mask(x.shape, p, rng, x.device, part)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(Module):
    """Inverted dropout (reference nn/Dropout.scala ``scale=true``): the
    identity when not training or when ``p == 0``; raises when training
    with ``p > 0`` and no ``rng``, as the JAX layer does."""

    def __init__(self, init_p: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p

    def forward(self, x, rng: Optional[Seed] = None):
        if not self.training or self.p <= 0.0:
            return x
        if rng is None:
            raise ValueError("Dropout in training mode needs an rng")
        from bigdl_tpu_torch.ops.partition import dropout_part

        return dropout(x, self.p, rng, dropout_part(x))


class _SpatialDropout(Module):
    """Drops whole channels: one keep draw per (sample, channel), shared
    by every position (bigdl_tpu/nn/dropout.py:37-80); ``rank`` is the
    input's rank."""

    rank = 4

    def __init__(self, init_p: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p

    def forward(self, x, rng: Optional[Seed] = None):
        if not self.training or self.p <= 0.0:
            return x
        _need_rng(rng, type(self).__name__)
        if x.dim() != self.rank:
            raise ValueError(f"{type(self).__name__} takes rank-{self.rank} "
                             f"input, got shape {tuple(x.shape)}")
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (self.rank - 2) + (x.shape[-1],)
        mask = keep_mask(shape, self.p, rng, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class SpatialDropout1D(_SpatialDropout):
    """Channel dropout of (N, T, C) sequences."""

    rank = 3


class SpatialDropout2D(_SpatialDropout):
    """Channel dropout of NHWC maps (reference nn/SpatialDropout2D)."""

    rank = 4


class SpatialDropout3D(_SpatialDropout):
    """Channel dropout of NDHWC volumes."""

    rank = 5


class GaussianDropout(Module):
    """Multiplicative ``N(1, rate / (1 - rate))`` noise in training
    (reference nn/GaussianDropout; bigdl_tpu/nn/dropout.py:83-96)."""

    def __init__(self, rate: float, name: Optional[str] = None):
        super().__init__(name)
        self.rate = rate

    def forward(self, x, rng: Optional[Seed] = None):
        if not self.training or self.rate <= 0.0:
            return x
        _need_rng(rng, "GaussianDropout")
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + stddev * normal(x.shape, rng, x.device, x.dtype))


class GaussianNoise(Module):
    """Additive ``N(0, stddev)`` noise in training (reference
    nn/GaussianNoise)."""

    def __init__(self, stddev: float, name: Optional[str] = None):
        super().__init__(name)
        self.stddev = stddev

    def forward(self, x, rng: Optional[Seed] = None):
        if not self.training:
            return x
        _need_rng(rng, "GaussianNoise")
        return x + self.stddev * normal(x.shape, rng, x.device, x.dtype)


class Masking(Module):
    """Zeroes the time steps whose every feature equals ``mask_value``
    (reference keras Masking)."""

    def __init__(self, mask_value: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        self.mask_value = mask_value

    def forward(self, x):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x))


class GaussianSampler(Module):
    """The reparameterised sample ``mean + exp(0.5 * log_var) * eps``,
    ``eps ~ N(0, 1)``, of a table ``(mean, log_var)`` (reference
    nn/GaussianSampler.scala); without an ``rng`` the mean, whatever the
    mode, as the JAX layer (bigdl_tpu/nn/dropout.py:121-137)."""

    def forward(self, inputs, rng: Optional[Seed] = None):
        if isinstance(inputs, dict):
            mean, logvar = inputs[1], inputs[2]
        else:
            mean, logvar = inputs
        if rng is None:
            return mean
        eps = normal(mean.shape, rng, mean.device, mean.dtype)
        return mean + torch.exp(0.5 * logvar) * eps
