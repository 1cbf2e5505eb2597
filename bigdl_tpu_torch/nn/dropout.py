"""Dropout (counterpart of bigdl_tpu/nn/dropout.py).

Random numbers come from an explicit seed threaded through ``forward``
(the port's counterpart of the JAX ``rng`` key; see
:func:`bigdl_tpu_torch.nn.module.split_rng`), drawn by a
``torch.Generator`` on x's device seeded with it: never from torch's
global generator.  Torch cannot reproduce JAX's threefry bits, so the
two packages drop different elements from the same seed; the tests hold
the distribution, not the mask.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


def dropout(x: torch.Tensor, p: float, rng: int) -> torch.Tensor:
    """Inverted dropout of ``x``: each element kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)`` in x's type, else 0."""
    keep = 1.0 - p
    gen = torch.Generator(device=x.device).manual_seed(rng)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(Module):
    """Inverted dropout (reference nn/Dropout.scala ``scale=true``): the
    identity when not training or when ``p == 0``; raises when training
    with ``p > 0`` and no ``rng``, as the JAX layer does."""

    def __init__(self, init_p: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p

    def forward(self, x, rng: Optional[int] = None):
        if not self.training or self.p <= 0.0:
            return x
        if rng is None:
            raise ValueError("Dropout in training mode needs an rng")
        return dropout(x, self.p, rng)
