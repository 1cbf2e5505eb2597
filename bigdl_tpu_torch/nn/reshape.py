"""Shape layers (counterpart of bigdl_tpu/nn/reshape.py)."""
from __future__ import annotations

from typing import Optional

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
