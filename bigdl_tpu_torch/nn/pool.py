"""Pooling, NHWC (counterpart of bigdl_tpu/nn/pool.py)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import _pair, same_pads
from bigdl_tpu_torch.nn.module import Module


def _pool_pads(padding, h, w, kh, kw, sh, sw):
    """``[(top, bottom), (left, right)]`` as bigdl_tpu/nn/pool.py
    ``_resolve_pool_padding`` gives them (ceil mode is not ported)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)]
        return [same_pads(h, kh, sh), same_pads(w, kw, sw)]
    ph, pw = _pair(padding)
    if (ph, pw) == (-1, -1):
        return [same_pads(h, kh, sh), same_pads(w, kw, sw)]
    return [(ph, ph), (pw, pw)]


class SpatialMaxPooling(Module):
    """Max pool; every pad, SAME's uneven ``(0, 1)`` included, is filled
    with -inf, as ``lax.reduce_window`` pads (bigdl_tpu/nn/pool.py:34)."""

    def __init__(self, kernel_size=2, stride=None, padding=0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None \
            else self.kernel_size
        self.padding = padding

    def forward(self, x):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        (t, b), (l, r) = _pool_pads(self.padding, x.shape[1], x.shape[2],
                                    kh, kw, sh, sw)
        xn = x.permute(0, 3, 1, 2)
        if t or b or l or r:
            xn = F.pad(xn, (l, r, t, b), value=float("-inf"))
        yn = F.max_pool2d(xn, (kh, kw), (sh, sw))
        return yn.permute(0, 2, 3, 1).contiguous()


class GlobalAveragePooling2D(Module):
    """Mean over H and W (bigdl_tpu/nn/pool.py:169)."""

    def forward(self, x):
        return torch.mean(x, dim=(1, 2))
