"""Fused ResNet bottleneck (counterpart of bigdl_tpu/nn/fused_block.py:
48-247).

The block holds the same layers as the unfused bottleneck graph, under
the JAX block's slot names (``conv1``, ``bn1``, ..., ``conv_sc``,
``bn_sc``) and leaf shapes, but schedules them around the kernels:

- conv1 (1x1) is :func:`fused_matmul_bn` on the raw input;
- conv2 (3x3) at stride 1 is :func:`fused_conv3x3_bn`, with BN1's
  normalize + ReLU in its prologue; at stride 2 it is a library conv
  over ``relu(y1 * a1 + b1)`` computed in x's type, with its statistics
  taken from the rounded output;
- conv3 (1x1) is :func:`fused_matmul_bn` with BN2 in its prologue;
- a projection shortcut is :func:`fused_matmul_bn` over the strided
  input, and BN3 + residual + ReLU is one elementwise pass in x's type.

In eval the BatchNorm constants come from the running statistics.  In
training they come from the kernels' ``ssum``/``ssq`` through
:func:`bn_constants`, which autograd differentiates, so the backward runs
the kernels' backward (dgrad, wgrad).  The running statistics move once
per forward, with the unbiased variance.

``remat=True`` (the JAX block's default) wraps the training body in
``torch.utils.checkpoint``: the block's activations are dropped after
the forward and recomputed in the backward, trading the forward kernels'
second launch for memory.  The body returns the batch statistics and the
running statistics are updated outside it, so the recompute does not
move them a second time.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.nn.conv import conv2d_nhwc, resolve_padding
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.init import MsraFiller, Zeros
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.norm import SpatialBatchNormalization
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution)
from bigdl_tpu_torch.ops import fused_matmul as fm

__all__ = ["FusedBottleneck", "use_plain_ops"]


class FusedBottleneck(Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with BatchNorm folded into the
    kernels: zero-gamma closing BN, type-B shortcut, eps/momentum as in
    the JAX block.

    ``plain=True`` runs the kernels' plain PyTorch versions on any device
    (the reference ``chip_smoke.py`` holds the kernels to), differentiated
    by autograd; the default launches the kernels on CUDA tensors.
    """

    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 expansion: int = 4, eps: float = 1e-5,
                 momentum: float = 0.1, name: Optional[str] = None,
                 remat: bool = True):
        super().__init__(name)
        self.n_in, self.planes, self.stride = n_in, planes, stride
        self.n_out = planes * expansion
        self.eps, self.momentum = eps, momentum
        self.project = stride != 1 or n_in != self.n_out
        self.plain = False
        self.remat = remat

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

    def _names(self):
        """``(slot, leaf)`` of every parameter, in a fixed order."""
        slots = (["conv1", "conv2", "conv3", "bn1", "bn2", "bn3"]
                 + (["conv_sc", "bn_sc"] if self.project else []))
        return [(k, leaf) for k in slots
                for leaf in (("weight",) if k.startswith("conv")
                             else ("weight", "bias"))]

    def _leaves(self):
        """The block's parameters in :meth:`_names` order, read at call
        time (so a ``functional_call`` or a remat recompute sees the
        tensors this forward saw)."""
        return tuple(getattr(getattr(self, k), leaf)
                     for k, leaf in self._names())

    def _bn_consts(self, key, p, ssum, ssq, count, training):
        """``(scale, bias, batch_stats)`` with ``y * scale + bias`` equal
        to BN(y) (fused_block.py:79-101): from the batch statistics in
        training, from the running statistics in eval."""
        gamma, beta = p[f"{key}.weight"], p[f"{key}.bias"]
        if training:
            scale, bias, mean, var = fm.bn_constants(ssum, ssq, count, gamma,
                                                     beta, self.eps)
            return scale, bias, (mean, var, count)
        bn = getattr(self, key)
        scale = torch.rsqrt(bn.running_var + self.eps) * gamma.float()
        return scale, beta.float() - bn.running_mean * scale, None

    def _body(self, x, *leaves, training: bool):
        """The block (fused_block.py:187-247); returns the output and,
        in training, ``{bn key: (mean, var, count)}``."""
        p = {f"{k}.{leaf}": t for (k, leaf), t in zip(self._names(), leaves)}
        matmul = fm.fused_matmul_bn_plain if self.plain else fm.fused_matmul_bn
        conv3x3 = (fm.fused_conv3x3_bn_plain if self.plain
                   else fm.fused_conv3x3_bn)
        n, h, w, c = x.shape
        dtype = x.dtype
        planes, n_out, s = self.planes, self.n_out, self.stride
        stats = {}

        def consts(key, ssum, ssq, count):
            scale, bias, stats[key] = self._bn_consts(key, p, ssum, ssq,
                                                      count, training)
            return scale, bias

        x2d = x.reshape(-1, c)
        y1, s1, q1 = matmul(x2d, p["conv1.weight"].reshape(c, planes).to(dtype),
                            relu=False)
        a1, b1 = consts("bn1", s1, q1, y1.shape[0])

        w2 = p["conv2.weight"].to(dtype)
        if s == 1:
            raw2, s2, q2 = conv3x3(y1.reshape(n, h, w, planes), w2, a1, b1,
                                   relu=True)
        else:
            # strided conv2 stays a library conv; u1 in x's type, stats
            # from the rounded output (fused_block.py:209-220)
            u1 = torch.relu(y1 * a1.to(dtype) + b1.to(dtype))
            pads = resolve_padding("SAME", (h, w), (3, 3), (s, s))
            raw2 = conv2d_nhwc(u1.reshape(n, h, w, planes), w2, (s, s),
                               pads)
            r2f = raw2.float().reshape(-1, planes)
            s2, q2 = r2f.sum(0), (r2f * r2f).sum(0)
        ho, wo = raw2.shape[1], raw2.shape[2]
        a2, b2 = consts("bn2", s2, q2, n * ho * wo)

        y3, s3, q3 = matmul(raw2.reshape(-1, planes),
                            p["conv3.weight"].reshape(planes, n_out).to(dtype),
                            a2, b2, relu=True)
        a3, b3 = consts("bn3", s3, q3, y3.shape[0])

        if self.project:
            xs = x if s == 1 else x[:, ::s, ::s, :].contiguous()
            ysc, ssc, qsc = matmul(
                xs.reshape(-1, c),
                p["conv_sc.weight"].reshape(c, n_out).to(dtype), relu=False)
            asc, bsc = consts("bn_sc", ssc, qsc, ysc.shape[0])
            sc = ysc * asc.to(dtype) + bsc.to(dtype)
        else:
            sc = x2d
        out = torch.relu(y3 * a3.to(dtype) + b3.to(dtype) + sc)
        return out.reshape(n, ho, wo, n_out), stats

    def forward(self, x):
        if x.shape[-1] != self.n_in:
            raise ValueError(f"{self.name}: expected {self.n_in} channels, "
                             f"got {tuple(x.shape)}")
        if not self.training:
            return self._body(x, *self._leaves(), training=False)[0]
        body = functools.partial(self._body, training=True)
        if self.remat:
            out, stats = checkpoint(body, x, *self._leaves(),
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            out, stats = body(x, *self._leaves())
        for key, (mean, var, count) in stats.items():
            getattr(self, key).update_running_stats(mean, var, count)
        return out


def use_plain_ops(model: torch.nn.Module, plain: bool = True):
    """Switch every fused block and quantized layer of ``model`` to (or
    back from) the kernels' plain PyTorch versions."""
    for m in model.modules():
        if isinstance(m, (FusedBottleneck, QuantizedLinear,
                          QuantizedSpatialConvolution)):
            m.plain = plain
    return model
