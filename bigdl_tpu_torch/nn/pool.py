"""Pooling, NHWC (counterpart of bigdl_tpu/nn/pool.py).

Every pad is explicit, as ``lax.reduce_window`` pads: max pooling pads
with -inf (the integer type's least value) at any width, average
pooling with zeros, and the windows are then taken with no padding of
torch's own.  ``ceil_mode`` adds the high-side pad that makes the
window count round up (bigdl_tpu/nn/pool.py:14-31), so a last window
that starts inside that pad is kept, where ``F.max_pool2d``'s own
``ceil_mode`` would drop it.  Average pooling sums in f32 and divides by
``kh * kw`` with ``count_include_pad`` (the ceil-mode pad included,
pool.py:95-104), else by the count of real pixels in the window.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import _pair, _triple, same_pads
from bigdl_tpu_torch.nn.module import Module


def _pool_pads(padding, ceil_mode, h, w, kh, kw, sh, sw):
    """``([(top, bottom), (left, right)], is_string)`` as
    ``_resolve_pool_padding`` gives them; ``is_string`` marks a padding
    named "SAME"/"VALID" (average pooling then divides by real counts)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)], True
        return [same_pads(h, kh, sh), same_pads(w, kw, sw)], True
    ph, pw = _pair(padding)
    if (ph, pw) == (-1, -1):
        return [same_pads(h, kh, sh), same_pads(w, kw, sw)], True
    if not ceil_mode:
        return [(ph, ph), (pw, pw)], False

    def extra(size, k, s, p):
        out = -(-(size + 2 * p - k) // s) + 1
        return max(0, (out - 1) * s + k - (size + 2 * p))

    return [(ph, ph + extra(h, kh, sh, ph)),
            (pw, pw + extra(w, kw, sw, pw))], False


def _pad_first(xn, pads, value):
    """Pad the spatial dims of channels-first ``xn`` by ``[(lo, hi)]``."""
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    if not any(flat):
        return xn
    return F.pad(xn, flat, value=value)


def _lowest(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


class SpatialMaxPooling(Module):
    """Max pool of NHWC maps (bigdl_tpu/nn/pool.py:34)."""

    def __init__(self, kernel_size=2, stride=None, padding=0,
                 ceil_mode: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.kernel_size = _pair(kernel_size)
        self.stride = (_pair(stride) if stride is not None
                       else self.kernel_size)
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        pads, _ = _pool_pads(self.padding, self.ceil_mode, x.shape[1],
                             x.shape[2], kh, kw, sh, sw)
        xn = _pad_first(x.permute(0, 3, 1, 2), pads, _lowest(x.dtype))
        yn = F.max_pool2d(xn, (kh, kw), (sh, sw))
        return yn.permute(0, 2, 3, 1).contiguous()


class SpatialAveragePooling(Module):
    """Average pool of NHWC maps, summed in f32 (bigdl_tpu/nn/pool.py:70)."""

    def __init__(self, kernel_size=2, stride=None, padding=0,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.kernel_size = _pair(kernel_size)
        self.stride = (_pair(stride) if stride is not None
                       else self.kernel_size)
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad

    def forward(self, x):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        pads, named = _pool_pads(self.padding, self.ceil_mode, x.shape[1],
                                 x.shape[2], kh, kw, sh, sw)
        xn = _pad_first(x.float().permute(0, 3, 1, 2), pads, 0.0)
        # the window mean of the padded map: its sum over kh * kw
        y = F.avg_pool2d(xn, (kh, kw), (sh, sw))
        if not self.count_include_pad or named:
            ones = _pad_first(torch.ones((1, 1) + tuple(x.shape[1:3]),
                                         device=x.device), pads, 0.0)
            y = y / F.avg_pool2d(ones, (kh, kw), (sh, sw))
        return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


class TemporalMaxPooling(Module):
    """Max pool over time of (N, T, C), no padding (reference
    nn/TemporalMaxPooling)."""

    def __init__(self, k_w: int, d_w: Optional[int] = None, name=None):
        super().__init__(name)
        self.k_w = k_w
        self.d_w = d_w or k_w

    def forward(self, x):
        y = F.max_pool1d(x.transpose(1, 2), self.k_w, self.d_w)
        return y.transpose(1, 2).contiguous()


class VolumetricMaxPooling(Module):
    """3-D max pool of NDHWC volumes, no padding (reference
    nn/VolumetricMaxPooling)."""

    def __init__(self, kernel=2, stride=None, name=None):
        super().__init__(name)
        self.kernel = _triple(kernel)
        self.stride = _triple(stride) if stride is not None else self.kernel

    def forward(self, x):
        y = F.max_pool3d(x.movedim(-1, 1), self.kernel, self.stride)
        return y.movedim(1, -1).contiguous()


class VolumetricAveragePooling(Module):
    """3-D average pool of NDHWC volumes in f32, no padding."""

    def __init__(self, kernel=2, stride=None, name=None):
        super().__init__(name)
        self.kernel = _triple(kernel)
        self.stride = _triple(stride) if stride is not None else self.kernel

    def forward(self, x):
        y = F.avg_pool3d(x.float().movedim(-1, 1), self.kernel, self.stride)
        return y.movedim(1, -1).to(x.dtype).contiguous()


class GlobalAveragePooling2D(Module):
    """Mean over H and W (bigdl_tpu/nn/pool.py:169), the two axes kept as
    size 1 with ``keepdims``."""

    def __init__(self, keepdims: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.keepdims = keepdims

    def forward(self, x):
        return torch.mean(x, dim=(1, 2), keepdim=self.keepdims)


class GlobalMaxPooling2D(Module):
    """Max over H and W."""

    def __init__(self, keepdims: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.keepdims = keepdims

    def forward(self, x):
        return torch.amax(x, dim=(1, 2), keepdim=self.keepdims)


class SpatialAdaptiveMaxPooling(Module):
    """Max pool to a fixed ``(out_h, out_w)`` grid (reference
    nn/SpatialAdaptiveMaxPooling): equal windows when the grid divides
    the map, else cell ``(i, j)`` covers rows ``[floor(i h / out_h),
    ceil((i + 1) h / out_h))`` and the same for columns."""

    def __init__(self, out_h: int, out_w: int, name=None):
        super().__init__(name)
        self.out_h, self.out_w = out_h, out_w

    def forward(self, x):
        n, h, w, c = x.shape
        oh, ow = self.out_h, self.out_w
        if h % oh == 0 and w % ow == 0:
            kh, kw = h // oh, w // ow
            y = F.max_pool2d(x.permute(0, 3, 1, 2), (kh, kw), (kh, kw))
            return y.permute(0, 2, 3, 1).contiguous()
        rows = []
        for i in range(oh):
            h0, h1 = (i * h) // oh, -(-((i + 1) * h) // oh)
            cols = []
            for j in range(ow):
                w0, w1 = (j * w) // ow, -(-((j + 1) * w) // ow)
                cols.append(torch.amax(x[:, h0:h1, w0:w1, :], dim=(1, 2)))
            rows.append(torch.stack(cols, dim=1))
        return torch.stack(rows, dim=1)
