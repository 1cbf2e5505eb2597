"""Convolution, NHWC in and out with an HWIO weight (counterpart of
bigdl_tpu/nn/conv.py).

``padding`` takes what the JAX layer takes: an int, an ``(h, w)`` pair,
an explicit ``((top, bottom), (left, right))`` nest, ``"SAME"`` or
``"VALID"``.  JAX's SAME puts the odd pixel of padding at the bottom and
right, so on even sizes with stride 2 it pads ``(0, 1)``; PyTorch's
``padding=`` is symmetric, so uneven pads go through ``F.pad`` first.
With dilation, SAME pads for the dilated extent ``d * (k - 1) + 1``, as
XLA does.  The NHWC tensor is handed to ``F.conv2d`` as an NCHW view
(which is channels-last memory) with an OIHW view of the weight; these
are the only transposes.  The 1-D and 3-D layers take (N, T, C) with a
WIO weight and NDHWC with a DHWIO weight the same way.

The transposed convolutions are the textbook fractionally strided
correlation of the JAX layers: the input dilated by the stride (zeros
between its pixels), padded ``(k - 1 - p, k - 1 - p + adj)`` and
correlated with the spatially flipped ``(kh, kw, in, out)`` weight.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.init import InitializationMethod, RandomUniform, Zeros
from bigdl_tpu_torch.nn.module import Module, constant_on

PaddingT = Union[int, str, Tuple[int, int],
                 Tuple[Tuple[int, int], Tuple[int, int]]]
Pads = List[Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _triple(v) -> Tuple:
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v, v)


def same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """``(lo, hi)`` of XLA's SAME padding along one axis, for a kernel of
    ``k`` taps ``d`` apart."""
    out = -(-size // s)
    total = max((out - 1) * s + d * (k - 1) + 1 - size, 0)
    return total // 2, total - total // 2


def resolve_padding(padding: PaddingT, hw, kernel, stride,
                    dilation=(1, 1)) -> Pads:
    """Explicit ``[(top, bottom), (left, right)]`` for any accepted form
    (bigdl_tpu/nn/conv.py ``_resolve_padding``)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0), (0, 0)]
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return [same_pads(hw[i], kernel[i], stride[i], dilation[i])
                for i in range(2)]
    if (isinstance(padding, (tuple, list)) and len(padding) == 2
            and all(isinstance(p, (tuple, list)) and len(p) == 2
                    for p in padding)):
        return [tuple(int(v) for v in p) for p in padding]
    ph, pw = _pair(padding)
    if (ph, pw) == (-1, -1):
        return resolve_padding("SAME", hw, kernel, stride, dilation)
    return [(ph, ph), (pw, pw)]


def _conv_nd(xn, wn, stride, pads, dilation=1, groups=1):
    """``F.conv{1,2,3}d`` of channels-first ``xn`` with explicit
    ``[(lo, hi)]`` pads per spatial dim (an uneven or negative pair goes
    through ``F.pad``)."""
    conv = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[xn.dim()]
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        return conv(xn, wn, None, stride, [lo for lo, _ in pads], dilation,
                    groups)
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    return conv(F.pad(xn, flat), wn, None, stride, 0, dilation, groups)


def _to_first(x):
    """Channels-last -> the channels-first view torch's convs take."""
    return x.movedim(-1, 1)


def _to_last(y):
    return y.movedim(1, -1).contiguous()


def _w_first(w):
    """A ``(*spatial, in, out)`` weight -> ``(out, in, *spatial)``."""
    n = w.dim()
    return w.permute(n - 1, n - 2, *range(n - 2))


def conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, stride,
                pads: Pads, dilation=(1, 1), groups: int = 1
                ) -> torch.Tensor:
    """``F.conv2d`` over an NHWC tensor with an HWIO weight; returns a
    contiguous NHWC tensor."""
    return _to_last(_conv_nd(_to_first(x), _w_first(w_hwio), stride, pads,
                             dilation, groups))


def _dilate(xn, stride):
    """Channels-first ``xn`` with ``s - 1`` zeros between neighbours
    along each spatial dim (``lhs_dilation``)."""
    if all(s == 1 for s in stride):
        return xn
    size = [(n - 1) * s + 1 for n, s in zip(xn.shape[2:], stride)]
    out = xn.new_zeros(tuple(xn.shape[:2]) + tuple(size))
    index = (slice(None), slice(None)) + tuple(slice(None, None, s)
                                               for s in stride)
    out[index] = xn
    return out


def transposed_conv(x, w, stride, pad, adj):
    """The transposed conv of channels-last ``x`` with a ``(*k, in,
    out)`` weight (bigdl_tpu/nn/conv.py:209-226, 730-746)."""
    nd = w.dim() - 2
    k = w.shape[:nd]
    wf = torch.flip(w, tuple(range(nd))).to(x.dtype)
    pads = [(k[i] - 1 - pad[i], k[i] - 1 - pad[i] + adj[i])
            for i in range(nd)]
    xn = _dilate(_to_first(x), stride)
    return _to_last(_conv_nd(xn, _w_first(wf), (1,) * nd, pads))


class _Conv(Module):
    """Shared weight and bias handling: ``weight_shape``, the fans, and
    the initialisers (bias zeros where the JAX layer makes them so)."""

    def _make(self, weight_shape, with_bias: bool, bias_shape,
              fan_in: float, fan_out: float,
              weight_init: Optional[InitializationMethod] = None,
              bias_init: Optional[InitializationMethod] = None):
        self.with_bias = with_bias
        self.fan_in, self.fan_out = fan_in, fan_out
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        self.weight = torch.nn.Parameter(torch.empty(tuple(weight_shape)))
        self.bias = (torch.nn.Parameter(torch.empty(bias_shape))
                     if with_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(self.weight_init(
                generator, tuple(self.weight.shape), fan_in=self.fan_in,
                fan_out=self.fan_out))
            if self.bias is not None:
                self.bias.copy_(self.bias_init(
                    generator, tuple(self.bias.shape), fan_in=self.fan_in))

    def _add_bias(self, y):
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class SpatialConvolution(_Conv):
    """2-D convolution, NHWC / HWIO (bigdl_tpu/nn/conv.py:53): ``n_group``
    groups (the weight is ``(kh, kw, in / n_group, out)``) and a
    ``dilation`` between kernel taps."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_size=3, stride=1, padding: PaddingT = 0,
                 n_group: int = 1, with_bias: bool = True, dilation=1,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not split into {n_group} groups")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        self.n_group = n_group
        self.dilation = _pair(dilation)
        kh, kw = self.kernel_size
        self._make((kh, kw, n_input_plane // n_group, n_output_plane),
                   with_bias, n_output_plane,
                   (n_input_plane // n_group) * kh * kw,
                   (n_output_plane // n_group) * kh * kw,
                   weight_init, bias_init)

    def forward(self, x):
        pads = resolve_padding(self.padding, x.shape[1:3], self.kernel_size,
                               self.stride, self.dilation)
        y = conv2d_nhwc(x, self.weight.to(x.dtype), self.stride, pads,
                        self.dilation, self.n_group)
        return self._add_bias(y)


# the reference's memory-sharing variant is the same math
SpatialShareConvolution = SpatialConvolution


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (reference nn/SpatialDilatedConvolution)."""

    def __init__(self, n_input_plane, n_output_plane, kernel_size=3,
                 stride=1, padding=0, dilation=2, **kw):
        super().__init__(n_input_plane, n_output_plane, kernel_size, stride,
                         padding, dilation=dilation, **kw)


class SpatialFullConvolution(_Conv):
    """Transposed convolution (reference nn/SpatialFullConvolution): a
    ``(kh, kw, in, out)`` weight, output ``(h - 1) * s - 2 * p + k +
    adj``, the bias initialised to zeros."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_size=3, stride=1, padding=0, adj=0,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.pad = _pair(padding)
        self.adj = _pair(adj)
        kh, kw = self.kernel_size
        self._make((kh, kw, n_input_plane, n_output_plane), with_bias,
                   n_output_plane, n_input_plane * kh * kw,
                   n_output_plane * kh * kw, weight_init, Zeros())

    def forward(self, x):
        y = transposed_conv(x, self.weight, self.stride, self.pad, self.adj)
        return self._add_bias(y)


class SpatialSeparableConvolution(Module):
    """Depthwise then pointwise convolution (reference
    nn/SpatialSeparableConvolution): ``depth_weight`` (kh, kw, 1, in *
    depth_multiplier), ``point_weight`` (1, 1, in * depth_multiplier,
    out), ``bias`` zeros."""

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int = 1, kernel_size=3, stride=1,
                 padding: PaddingT = 0, with_bias: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_channel = n_input_channel
        self.n_output_channel = n_output_channel
        self.depth_multiplier = depth_multiplier
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        self.with_bias = with_bias
        kh, kw = self.kernel_size
        mid = n_input_channel * depth_multiplier
        self.depth_weight = torch.nn.Parameter(torch.empty(kh, kw, 1, mid))
        self.point_weight = torch.nn.Parameter(
            torch.empty(1, 1, mid, n_output_channel))
        self.bias = (torch.nn.Parameter(torch.zeros(n_output_channel))
                     if with_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        kh, kw = self.kernel_size
        mid = self.n_input_channel * self.depth_multiplier
        init = RandomUniform()
        with torch.no_grad():
            self.depth_weight.copy_(init(generator, (kh, kw, 1, mid),
                                         fan_in=kh * kw, fan_out=kh * kw))
            self.point_weight.copy_(init(
                generator, (1, 1, mid, self.n_output_channel), fan_in=mid,
                fan_out=self.n_output_channel))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        pads = resolve_padding(self.padding, x.shape[1:3], self.kernel_size,
                               self.stride)
        y = conv2d_nhwc(x, self.depth_weight.to(x.dtype), self.stride, pads,
                        groups=self.n_input_channel)
        y = conv2d_nhwc(y, self.point_weight.to(x.dtype), (1, 1),
                        [(0, 0), (0, 0)])
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class TemporalConvolution(_Conv):
    """1-D convolution over (N, T, C) with a ``(kernel_w, in, out)``
    weight (reference nn/TemporalConvolution); ``padding`` an int,
    ``"SAME"`` or ``"VALID"``."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1,
                 padding: Union[int, str] = 0, with_bias: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.padding = padding
        self._make((kernel_w, input_frame_size, output_frame_size),
                   with_bias, output_frame_size,
                   input_frame_size * kernel_w,
                   output_frame_size * kernel_w)

    def forward(self, x):
        if isinstance(self.padding, str):
            mode = self.padding.upper()
            pads = [same_pads(x.shape[1], self.kernel_w, self.stride_w)
                    if mode == "SAME" else (0, 0)]
        else:
            pads = [(self.padding, self.padding)]
        y = _to_last(_conv_nd(_to_first(x), _w_first(self.weight.to(x.dtype)),
                              (self.stride_w,), pads))
        return self._add_bias(y)


class VolumetricConvolution(_Conv):
    """3-D convolution, NDHWC / DHWIO (reference nn/VolumetricConvolution);
    ``padding`` an int, a triple, ``"SAME"`` or ``"VALID"``."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_size=3, stride=1, padding=0, with_bias: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_size = _triple(kernel_size)
        self.stride = _triple(stride)
        self.pad = _triple(padding)
        kt, kh, kw = self.kernel_size
        self._make((kt, kh, kw, n_input_plane, n_output_plane), with_bias,
                   n_output_plane, n_input_plane * kt * kh * kw,
                   n_output_plane * kt * kh * kw)

    def forward(self, x):
        if isinstance(self.pad[0], str):
            if self.pad[0].upper() == "SAME":
                pads = [same_pads(x.shape[1 + i], self.kernel_size[i],
                                  self.stride[i]) for i in range(3)]
            else:
                pads = [(0, 0)] * 3
        else:
            pads = [(p, p) for p in self.pad]
        y = _to_last(_conv_nd(_to_first(x), _w_first(self.weight.to(x.dtype)),
                              self.stride, pads))
        return self._add_bias(y)


class VolumetricFullConvolution(_Conv):
    """3-D transposed convolution, NDHWC, weight ``(kd, kh, kw, in,
    out)``, bias zeros (reference nn/VolumetricFullConvolution.scala)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_size=3, stride=1, padding=0, adj=0,
                 with_bias: bool = True, name=None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_size = tuple(int(v) for v in _triple(kernel_size))
        self.stride = tuple(int(v) for v in _triple(stride))
        self.pad = tuple(int(v) for v in _triple(padding))
        self.adj = tuple(int(v) for v in _triple(adj))
        kd, kh, kw = self.kernel_size
        fan_in = n_input_plane * kd * kh * kw
        bound = 1.0 / math.sqrt(fan_in)
        self._make((kd, kh, kw, n_input_plane, n_output_plane), with_bias,
                   n_output_plane, fan_in, fan_in,
                   RandomUniform(-bound, bound), Zeros())

    def forward(self, x):
        y = transposed_conv(x, self.weight, self.stride, self.pad, self.adj)
        return self._add_bias(y)


class UpSampling1D(Module):
    """Repeats each time step ``length`` times (N, T, C)."""

    def __init__(self, length: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.length = length

    def forward(self, x):
        return torch.repeat_interleave(x, self.length, dim=1)


class UpSampling2D(Module):
    """Nearest-neighbour spatial upsampling, NHWC (reference
    nn/UpSampling2D)."""

    def __init__(self, size=(2, 2), name: Optional[str] = None):
        super().__init__(name)
        self.size = _pair(size)

    def forward(self, x):
        sh, sw = self.size
        return torch.repeat_interleave(
            torch.repeat_interleave(x, sh, dim=1), sw, dim=2)


class UpSampling3D(Module):
    def __init__(self, size=(2, 2, 2), name: Optional[str] = None):
        super().__init__(name)
        self.size = (tuple(size) if isinstance(size, (tuple, list))
                     else (size,) * 3)

    def forward(self, x):
        for axis, s in enumerate(self.size):
            x = torch.repeat_interleave(x, s, dim=axis + 1)
        return x


def _resize_weights(inp: int, out: int) -> np.ndarray:
    """``(out, inp)`` weights of ``jax.image.resize``'s bilinear
    (triangle) kernel with half-pixel centres and antialiasing: the
    kernel widened by ``inp / out`` when downsampling, each row
    normalised, rows whose sample lies outside the input zeroed
    (jax/_src/image/scale.py ``compute_weight_mat``)."""
    inv = inp / out
    kscale = max(inv, 1.0)
    sample = (np.arange(out, dtype=np.float64) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None]
                                     - np.arange(inp)[None, :]) / kscale)
    tot = w.sum(1, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= inp - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def _lerp_weights(inp: int, out: int, align: bool, half: bool) -> np.ndarray:
    """``(out, inp)`` weights of the legacy TF1 ResizeBilinear modes
    (bigdl_tpu/nn/conv.py:426-447): two taps, ``1 - frac`` and
    ``frac``, at the clipped source coordinate."""
    if align and out > 1:
        src = np.arange(out) * (inp - 1) / max(out - 1, 1)
    elif half:
        src = (np.arange(out) + 0.5) * inp / out - 0.5
    else:
        src = np.arange(out) * (inp / out)
    src = np.clip(src, 0.0, inp - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, inp - 1)
    frac = (src - lo).astype(np.float32)
    w = np.zeros((out, inp), np.float32)
    w[np.arange(out), lo] += 1.0 - frac
    w[np.arange(out), hi] += frac
    return w


class ResizeBilinear(Module):
    """Bilinear resize of NHWC maps to ``(out_height, out_width)``
    (reference nn/ResizeBilinear).  The default, half-pixel centres, is
    ``jax.image.resize``'s (antialiased when downsampling);
    ``align_corners`` and ``half_pixel_centers=False`` are the two
    legacy TF1 modes, computed in f32.  Each axis is one contraction
    with a fixed ``(out, in)`` weight matrix built on the host."""

    def __init__(self, out_height: int, out_width: int,
                 align_corners: bool = False,
                 half_pixel_centers: bool = True, name=None):
        super().__init__(name)
        self.out_height, self.out_width = out_height, out_width
        self.align_corners = align_corners
        self.half_pixel_centers = half_pixel_centers
        self._weights = {}

    def _matrix(self, inp: int, out: int, like: torch.Tensor):
        legacy = self.align_corners or not self.half_pixel_centers
        key = (inp, out)
        host = self._weights.get(key)
        if host is None:
            host = self._weights[key] = (
                torch.from_numpy(_lerp_weights(inp, out, self.align_corners,
                                               self.half_pixel_centers))
                if legacy else torch.from_numpy(_resize_weights(inp, out)),
                {})
        return constant_on(host[0], host[1], like)

    def forward(self, x):
        legacy = self.align_corners or not self.half_pixel_centers
        xf = x.float()
        wh = self._matrix(x.shape[1], self.out_height, xf)
        ww = self._matrix(x.shape[2], self.out_width, xf)
        y = torch.einsum("oh,nhwc->nowc", wh, xf)
        y = torch.einsum("pw,nowc->nopc", ww, y)
        return y if legacy else y.to(x.dtype)


class SpatialZeroPadding(Module):
    """Zero padding of NHWC maps: left, right, top, bottom (each
    defaulting to ``pad_left``)."""

    def __init__(self, pad_left, pad_right=None, pad_top=None,
                 pad_bottom=None, name=None):
        super().__init__(name)
        pr = pad_left if pad_right is None else pad_right
        pt = pad_left if pad_top is None else pad_top
        pb = pad_left if pad_bottom is None else pad_bottom
        self.pads = (pad_left, pr, pt, pb)

    def forward(self, x):
        pl, pr, pt, pb = self.pads
        return F.pad(x, (0, 0, pl, pr, pt, pb))


class Cropping2D(Module):
    def __init__(self, crop_top=1, crop_bottom=1, crop_left=1, crop_right=1,
                 name=None):
        super().__init__(name)
        self.crops = (crop_top, crop_bottom, crop_left, crop_right)

    def forward(self, x):
        ct, cb, cl, cr = self.crops
        h, w = x.shape[1], x.shape[2]
        return x[:, ct:h - cb, cl:w - cr, :]


class Cropping3D(Module):
    """Crops depth, height and width margins, NDHWC (reference
    nn/Cropping3D.scala)."""

    def __init__(self, dim1_crop=(1, 1), dim2_crop=(1, 1), dim3_crop=(1, 1),
                 name=None):
        super().__init__(name)
        self.crops = (tuple(dim1_crop), tuple(dim2_crop), tuple(dim3_crop))

    def forward(self, x):
        (d0, d1), (h0, h1), (w0, w1) = self.crops
        d, h, w = x.shape[1], x.shape[2], x.shape[3]
        return x[:, d0:d - d1, h0:h - h1, w0:w - w1, :]


class LocallyConnected1D(_Conv):
    """1-D convolution with a weight per output position (reference
    nn/LocallyConnected1D.scala): (N, T, C) in, ``weight`` (T_out,
    kernel_w * C, out) over patches ordered (k, C), ``bias`` (T_out,
    out), both U(+-1/sqrt(kernel_w * C))."""

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 with_bias: bool = True, name=None):
        super().__init__(name)
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.n_output_frame = (n_input_frame - kernel_w) // stride_w + 1
        fan_in = kernel_w * input_frame_size
        bound = 1.0 / math.sqrt(fan_in)
        init = RandomUniform(-bound, bound)
        self._make((self.n_output_frame, fan_in, output_frame_size),
                   with_bias, (self.n_output_frame, output_frame_size),
                   fan_in, fan_in, init, init)

    def forward(self, x):
        k, s, t = self.kernel_w, self.stride_w, self.n_output_frame
        patches = x.unfold(1, k, s)[:, :t]           # (N, T_out, C, k)
        patches = patches.transpose(2, 3).reshape(x.shape[0], t,
                                                  k * x.shape[-1])
        y = torch.einsum("ntk,tko->nto", patches, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[None]
        return y


class LocallyConnected2D(_Conv):
    """2-D convolution with a weight per output position (reference
    nn/LocallyConnected2D.scala:16-40), NHWC.  The constructor takes
    width before height; ``weight`` is (H_out, W_out, kh * kw * C, out)
    over patches ordered (kh, kw, C), ``bias`` (H_out, W_out, out)."""

    def __init__(self, n_input_plane: int, input_width: int,
                 input_height: int, n_output_plane: int, kernel_w: int,
                 kernel_h: int, stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True,
                 name=None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.input_width, self.input_height = input_width, input_height
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.out_h = (input_height + 2 * pad_h - kernel_h) // stride_h + 1
        self.out_w = (input_width + 2 * pad_w - kernel_w) // stride_w + 1
        fan_in = kernel_h * kernel_w * n_input_plane
        bound = 1.0 / math.sqrt(fan_in)
        init = RandomUniform(-bound, bound)
        self._make((self.out_h, self.out_w, fan_in, n_output_plane),
                   with_bias, (self.out_h, self.out_w, n_output_plane),
                   fan_in, fan_in, init, init)

    def forward(self, x):
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.pad
        xp = F.pad(x, (0, 0, pw, pw, ph, ph))
        p = xp.unfold(1, kh, sh).unfold(2, kw, sw)    # (N, Ho, Wo, C, kh, kw)
        n, ho, wo = p.shape[:3]
        p = p.permute(0, 1, 2, 4, 5, 3).reshape(n, ho, wo, -1)
        y = torch.einsum("nhwk,hwko->nhwo", p, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[None]
        return y


class SpatialConvolutionMap(_Conv):
    """Convolution with an input -> output connection table (reference
    nn/SpatialConvolutionMap.scala): a dense HWIO conv whose weight is
    masked by the (C_in, C_out) 0/1 connectivity.  ``conn`` is a list of
    0-based ``(in, out)`` pairs, a (C_in, C_out) 0/1 array, an (N, 2)
    array of pairs, or anything that reshapes to (C_in, C_out), read as
    bigdl_tpu/nn/conv.py:660-680 reads it.  The mask is a fixed tensor,
    not a variable."""

    def __init__(self, conn, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: Optional[int] = None, stride=1,
                 padding: PaddingT = 0, with_bias: bool = True, name=None):
        super().__init__(name)
        kernel_h = kernel_h or kernel_w
        self.kernel = (kernel_h, kernel_w)
        self.stride = _pair(stride)
        self.padding = padding
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        is_pair_list = isinstance(conn, (list, tuple))
        conn = np.asarray(conn)
        pairs = conn.ndim == 2 and conn.shape[-1] == 2
        if is_pair_list and pairs:
            mask = self._from_pairs(conn)
        elif conn.ndim == 2 and conn.shape == (n_input_plane,
                                               n_output_plane):
            mask = conn.astype(np.float32)
        elif pairs:
            mask = self._from_pairs(conn)
        else:
            mask = conn.astype(np.float32).reshape(n_input_plane,
                                                   n_output_plane)
        self.mask = torch.from_numpy(np.ascontiguousarray(mask))
        self._mask_on = {}
        kh, kw = self.kernel
        fan_in = max(float(mask.sum(0).mean()), 1.0) * kh * kw
        bound = 1.0 / math.sqrt(fan_in)
        init = RandomUniform(-bound, bound)
        self._make((kh, kw, n_input_plane, n_output_plane), with_bias,
                   n_output_plane, fan_in, fan_in, init, init)

    def _from_pairs(self, conn):
        mask = np.zeros((self.n_input_plane, self.n_output_plane),
                        np.float32)
        mask[conn[:, 0].astype(np.int64), conn[:, 1].astype(np.int64)] = 1.0
        return mask

    @staticmethod
    def one_to_one(n_planes: int):
        return [(i, i) for i in range(n_planes)]

    @staticmethod
    def full(n_in: int, n_out: int):
        return [(i, o) for i in range(n_in) for o in range(n_out)]

    def forward(self, x):
        w = self.weight.to(x.dtype) * constant_on(self.mask, self._mask_on,
                                                   x)
        pads = resolve_padding(self.padding, x.shape[1:3], self.kernel,
                               self.stride)
        y = conv2d_nhwc(x, w, self.stride, pads)
        return self._add_bias(y)
