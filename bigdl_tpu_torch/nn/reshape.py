"""Shape layers (counterpart of bigdl_tpu/nn/reshape.py)."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


class SpaceToDepth(Module):
    """NHWC (N, H, W, C) -> (N, H/b, W/b, b*b*C): each b x b block folds
    into channels (bigdl_tpu/nn/reshape.py:17)."""

    def __init__(self, block: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.block = block

    def forward(self, x):
        n, h, w, c = x.shape
        b = self.block
        if h % b or w % b:
            raise ValueError(f"SpaceToDepth({b}): spatial dims ({h}, {w}) "
                             "must be divisible by the block size")
        x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, b * b * c)


class Mean(Module):
    """The mean over ``dimension``, kept as a size-1 axis unless
    ``squeeze`` (bigdl_tpu/nn/reshape.py:264-270)."""

    def __init__(self, dimension: int = 0, squeeze: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        return x.mean(self.dimension, keepdim=not self.squeeze)


class MulConstant(Module):
    """``x * scalar``, the scalar rounded to x's type first, as JAX's
    weakly typed product (bigdl_tpu/nn/reshape.py:237)."""

    def __init__(self, scalar: float, name: Optional[str] = None):
        super().__init__(name)
        self.scalar = scalar

    def forward(self, x):
        return x * torch.tensor(self.scalar, dtype=x.dtype, device=x.device)
