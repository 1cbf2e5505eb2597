"""Convolution, NHWC in and out with an HWIO weight (counterpart of
bigdl_tpu/nn/conv.py).

``padding`` takes what the JAX layer takes: an int, an ``(h, w)`` pair,
an explicit ``((top, bottom), (left, right))`` nest, ``"SAME"`` or
``"VALID"``.  JAX's SAME puts the odd pixel of padding at the bottom and
right, so on even sizes with stride 2 it pads ``(0, 1)``; PyTorch's
``padding=`` is symmetric, so uneven pads go through ``F.pad`` first.
The NHWC tensor is handed to ``F.conv2d`` as an NCHW view (which is
channels-last memory) with an OIHW view of the weight; these are the
only transposes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.init import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.module import Module

PaddingT = Union[int, str, Tuple[int, int],
                 Tuple[Tuple[int, int], Tuple[int, int]]]
Pads = List[Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """``(lo, hi)`` of XLA's SAME padding along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def resolve_padding(padding: PaddingT, hw, kernel, stride) -> Pads:
    """Explicit ``[(top, bottom), (left, right)]`` for any accepted form
    (bigdl_tpu/nn/conv.py ``_resolve_padding``)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0), (0, 0)]
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return [same_pads(hw[i], kernel[i], stride[i]) for i in range(2)]
    if (isinstance(padding, (tuple, list)) and len(padding) == 2
            and all(isinstance(p, (tuple, list)) and len(p) == 2
                    for p in padding)):
        return [tuple(int(v) for v in p) for p in padding]
    ph, pw = _pair(padding)
    if (ph, pw) == (-1, -1):
        return resolve_padding("SAME", hw, kernel, stride)
    return [(ph, ph), (pw, pw)]


def conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, stride,
                pads: Pads) -> torch.Tensor:
    """``F.conv2d`` over an NHWC tensor with an HWIO weight; returns a
    contiguous NHWC tensor."""
    xn = x.permute(0, 3, 1, 2)
    wn = w_hwio.permute(3, 2, 0, 1)
    (t, b), (l, r) = pads
    if t == b and l == r:
        yn = F.conv2d(xn, wn, None, stride, (t, l))
    else:
        yn = F.conv2d(F.pad(xn, (l, r, t, b)), wn, None, stride, 0)
    return yn.permute(0, 2, 3, 1).contiguous()


class SpatialConvolution(Module):
    """2-D convolution, NHWC / HWIO (bigdl_tpu/nn/conv.py:53).  Groups
    and dilation are not ported yet."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_size=3, stride=1, padding: PaddingT = 0,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        kh, kw = self.kernel_size
        self.weight = torch.nn.Parameter(torch.empty(
            kh, kw, n_input_plane, n_output_plane))
        self.bias = (torch.nn.Parameter(torch.empty(n_output_plane))
                     if with_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        kh, kw = self.kernel_size
        fan_in = self.n_input_plane * kh * kw
        fan_out = self.n_output_plane * kh * kw
        with torch.no_grad():
            self.weight.copy_(self.weight_init(
                generator, tuple(self.weight.shape), fan_in=fan_in,
                fan_out=fan_out))
            if self.bias is not None:
                self.bias.copy_(self.bias_init(
                    generator, (self.n_output_plane,), fan_in=fan_in))

    def forward(self, x):
        pads = resolve_padding(self.padding, x.shape[1:3], self.kernel_size,
                               self.stride)
        y = conv2d_nhwc(x, self.weight.to(x.dtype), self.stride, pads)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
