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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module, Seed, _signed, mix64

_GAMMA = _signed(0x9E3779B97F4A7C15)  # splitmix64's increment


def _seed_tensor(rng: Seed, device) -> torch.Tensor:
    if torch.is_tensor(rng):
        return rng.to(device=device, dtype=torch.int64)
    return torch.tensor(_signed(rng), dtype=torch.int64, device=device)


def keep_mask(shape, p: float, rng: Seed, device) -> torch.Tensor:
    """The boolean mask of the elements dropout keeps (each with
    probability ``1 - p``) for seed ``rng``; see the module's
    docstring."""
    n = math.prod(shape)
    idx = torch.arange(1, (n + 1) // 2 + 1, dtype=torch.int64, device=device)
    bits = mix64(torch.add(_seed_tensor(rng, device), idx, alpha=_GAMMA))
    # two 32-bit draws per 64-bit output; signed, so shifted by 2**31
    u = bits.view(torch.int32)[:n]
    threshold = math.floor((1.0 - p) * 2 ** 32) - 2 ** 31
    return (u < threshold).reshape(shape)


def dropout(x: torch.Tensor, p: float, rng: Seed) -> torch.Tensor:
    """Inverted dropout of ``x``: each element kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)`` in x's type, else 0."""
    keep = 1.0 - p
    mask = keep_mask(x.shape, p, rng, x.device)
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
        return dropout(x, self.p, rng)
