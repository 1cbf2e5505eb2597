"""Fused ResNet bottleneck, eval path (counterpart of
bigdl_tpu/nn/fused_block.py:113-247).

The block holds the same layers as the unfused bottleneck graph, under
the JAX block's slot names (``conv1``, ``bn1``, ..., ``conv_sc``,
``bn_sc``) and leaf shapes, but schedules them around the two kernels:

- conv1 (1x1) is :func:`fused_matmul_bn` on the raw input;
- conv2 (3x3) at stride 1 is :func:`fused_conv3x3_bn`, with BN1's
  normalize + ReLU in its prologue; at stride 2 it is a library conv
  over ``relu(y1 * a1 + b1)`` computed in x's type;
- conv3 (1x1) is :func:`fused_matmul_bn` with BN2 in its prologue;
- a projection shortcut is :func:`fused_matmul_bn` over the strided
  input, and BN3 + residual + ReLU is one elementwise pass in x's type.

In eval the BatchNorm constants come from the running statistics, so the
kernels' ``ssum``/``ssq`` outputs are not read.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.conv import conv2d_nhwc, resolve_padding
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.init import MsraFiller, Zeros
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.norm import SpatialBatchNormalization
from bigdl_tpu_torch.ops import fused_matmul as fm

__all__ = ["FusedBottleneck", "use_plain_ops"]


class FusedBottleneck(Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with BatchNorm folded into the
    kernels: zero-gamma closing BN, type-B shortcut, eps/momentum as in
    the JAX block.

    ``plain=True`` runs the kernels' plain PyTorch versions on any device
    (the reference ``chip_smoke.py`` holds the kernels to); the default
    launches the kernels on CUDA tensors.
    """

    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 expansion: int = 4, eps: float = 1e-5,
                 momentum: float = 0.1, name: Optional[str] = None):
        super().__init__(name)
        self.n_in, self.planes, self.stride = n_in, planes, stride
        self.n_out = planes * expansion
        self.eps, self.momentum = eps, momentum
        self.project = stride != 1 or n_in != self.n_out
        self.plain = False

        def conv(ci, co, k):
            return SpatialConvolution(ci, co, k, with_bias=False,
                                      weight_init=MsraFiller())

        def bn(n, zero_gamma=False):
            return SpatialBatchNormalization(
                n, eps, momentum, weight_init=Zeros() if zero_gamma else None)

        self.conv1 = conv(n_in, planes, 1)
        self.conv2 = conv(planes, planes, 3)
        self.conv3 = conv(planes, self.n_out, 1)
        self.bn1 = bn(planes)
        self.bn2 = bn(planes)
        self.bn3 = bn(self.n_out, zero_gamma=True)
        if self.project:
            self.conv_sc = conv(n_in, self.n_out, 1)
            self.bn_sc = bn(self.n_out)

    def _bn_consts(self, bn: SpatialBatchNormalization):
        """Eval ``(scale, bias)`` (fused_block.py:94-100):
        ``scale = rsqrt(var + eps) * gamma``, ``bias = beta - mean*scale``."""
        scale = torch.rsqrt(bn.running_var + self.eps) * bn.weight.float()
        return scale, bn.bias.float() - bn.running_mean * scale

    def forward(self, x):
        self._require_eval()
        matmul = fm.fused_matmul_bn_plain if self.plain else fm.fused_matmul_bn
        conv3x3 = (fm.fused_conv3x3_bn_plain if self.plain
                   else fm.fused_conv3x3_bn)
        n, h, w, c = x.shape
        if c != self.n_in:
            raise ValueError(f"{self.name}: expected {self.n_in} channels, "
                             f"got {tuple(x.shape)}")
        dtype = x.dtype
        planes, n_out, s = self.planes, self.n_out, self.stride

        x2d = x.reshape(-1, c)
        y1, _, _ = matmul(x2d, self.conv1.weight.reshape(c, planes).to(dtype),
                          relu=False)
        a1, b1 = self._bn_consts(self.bn1)

        w2 = self.conv2.weight.to(dtype)
        if s == 1:
            raw2, _, _ = conv3x3(y1.reshape(n, h, w, planes), w2, a1, b1,
                                 relu=True)
        else:
            # strided conv2 stays a library conv; u1 in x's type
            u1 = torch.relu(y1 * a1.to(dtype) + b1.to(dtype))
            pads = resolve_padding("SAME", (h, w), (3, 3), (s, s))
            raw2 = conv2d_nhwc(u1.reshape(n, h, w, planes), w2, (s, s),
                               pads)
        ho, wo = raw2.shape[1], raw2.shape[2]
        a2, b2 = self._bn_consts(self.bn2)

        y3, _, _ = matmul(raw2.reshape(-1, planes),
                          self.conv3.weight.reshape(planes, n_out).to(dtype),
                          a2, b2, relu=True)
        a3, b3 = self._bn_consts(self.bn3)

        if self.project:
            xs = x if s == 1 else x[:, ::s, ::s, :].contiguous()
            ysc, _, _ = matmul(
                xs.reshape(-1, c),
                self.conv_sc.weight.reshape(c, n_out).to(dtype), relu=False)
            asc, bsc = self._bn_consts(self.bn_sc)
            sc = ysc * asc.to(dtype) + bsc.to(dtype)
        else:
            sc = x2d
        out = torch.relu(y3 * a3.to(dtype) + b3.to(dtype) + sc)
        return out.reshape(n, ho, wo, n_out)


def use_plain_ops(model: torch.nn.Module, plain: bool = True):
    """Switch every fused block of ``model`` to (or back from) the
    kernels' plain PyTorch versions."""
    for m in model.modules():
        if isinstance(m, FusedBottleneck):
            m.plain = plain
    return model
