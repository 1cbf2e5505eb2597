"""Fused ResNet blocks (counterpart of bigdl_tpu/nn/fused_block.py):
the bottleneck (``FusedBottleneck``) and the basic block
(``FusedBasicBlock``).

Each block holds the same layers as its unfused graph, under the JAX
block's slot names (``conv1``, ``bn1``, ..., ``conv_sc``, ``bn_sc``) and
leaf shapes, but schedules them around the kernels.  The bottleneck:

- conv1 (1x1) is :func:`fused_matmul_bn` on the raw input;
- conv2 (3x3) at stride 1 is :func:`fused_conv3x3_bn`, with BN1's
  normalize + ReLU in its prologue; at stride 2 it is a library conv
  over ``relu(y1 * a1 + b1)`` computed in x's type, with its statistics
  taken from the rounded output;
- conv3 (1x1) is :func:`fused_matmul_bn` with BN2 in its prologue.

The basic block:

- conv1 (3x3) at stride 1 is :func:`fused_conv3x3_bn` on the raw input,
  without a prologue; at stride 2 it is a library conv that sums exact
  products in f32 (JAX's ``preferred_element_type=f32``), its statistics
  taken from that f32 output before it is rounded to x's type;
- conv2 (3x3, stride 1) is :func:`fused_conv3x3_bn` with BN1's
  normalize + ReLU in its prologue.

In both, a projection shortcut is :func:`fused_matmul_bn` over the
strided input, and the closing BatchNorm + residual + ReLU is one
elementwise pass in x's type.

In eval the BatchNorm constants come from the running statistics.  In
training they come from the kernels' ``ssum``/``ssq`` through
:func:`bn_constants`, which autograd differentiates, so the backward runs
the kernels' backward (dgrad, wgrad).  The running statistics move once
per forward, with the unbiased variance.

``remat=True`` (the JAX blocks' default) wraps the training body in
``torch.utils.checkpoint``: the block's activations are dropped after
the forward and recomputed in the backward, trading the forward kernels'
second launch for memory.  The body returns the batch statistics and the
running statistics are updated outside it, so the recompute does not
move them a second time.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.nn.conv import conv2d_nhwc, resolve_padding
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.init import MsraFiller, Zeros
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.norm import SpatialBatchNormalization
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution)
from bigdl_tpu_torch.ops import fused_matmul as fm
from bigdl_tpu_torch.ops.partition import current_kernel_mesh, reduce_stats

__all__ = ["FusedBasicBlock", "FusedBottleneck", "use_plain_ops"]


class _FusedResBlock(Module):
    """What the fused blocks share (bigdl_tpu/nn/fused_block.py:62-110):
    the slot layers, the BatchNorm constants, the remat wrapper and the
    running-statistics update outside it.  A subclass sets ``n_in``,
    ``n_out``, ``eps``, ``momentum``, ``stride`` and ``remat``, registers
    its slots and implements :meth:`_slots` and :meth:`_body`.

    ``plain=True`` runs the kernels' plain PyTorch versions on any device
    (the reference ``chip_smoke.py`` holds the kernels to), differentiated
    by autograd; the default launches the kernels on CUDA tensors.
    """

    plain = False

    @staticmethod
    def _conv(ci, co, k):
        return SpatialConvolution(ci, co, k, with_bias=False,
                                  weight_init=MsraFiller())

    def _bn(self, n, zero_gamma=False):
        return SpatialBatchNormalization(
            n, self.eps, self.momentum,
            weight_init=Zeros() if zero_gamma else None)

    def _slots(self) -> List[str]:
        """The slot keys in a fixed order (conv slots start ``conv``)."""
        raise NotImplementedError

    def _names(self):
        """``(slot, leaf)`` of every parameter, in a fixed order."""
        return [(k, leaf) for k in self._slots()
                for leaf in (("weight",) if k.startswith("conv")
                             else ("weight", "bias"))]

    def _leaves(self):
        """The block's parameters in :meth:`_names` order, read at call
        time (so a ``functional_call`` or a remat recompute sees the
        tensors this forward saw)."""
        return tuple(getattr(getattr(self, k), leaf)
                     for k, leaf in self._names())

    def _kernels(self):
        """``(matmul, conv3x3)``: the kernels' wrappers or, with
        ``plain``, their plain versions."""
        if self.plain:
            return fm.fused_matmul_bn_plain, fm.fused_conv3x3_bn_plain
        return fm.fused_matmul_bn, fm.fused_conv3x3_bn

    def _bn_consts(self, key, p, ssum, ssq, count, training, mesh=None):
        """``(scale, bias, batch_stats)`` with ``y * scale + bias`` equal
        to BN(y) (fused_block.py:79-101): from the batch statistics in
        training (summed over ``mesh``'s data axis when there is one),
        from the running statistics in eval."""
        gamma, beta = p[f"{key}.weight"], p[f"{key}.bias"]
        if training:
            ssum, ssq, count = reduce_stats(ssum, ssq, count, mesh)
            scale, bias, mean, var = fm.bn_constants(ssum, ssq, count, gamma,
                                                     beta, self.eps)
            return scale, bias, (mean, var, count)
        bn = getattr(self, key)
        scale = torch.rsqrt(bn.running_var + self.eps) * gamma.float()
        return scale, beta.float() - bn.running_mean * scale, None

    def _body(self, x, *leaves, training: bool, mesh=None):
        """The block; returns the output and, in training,
        ``{bn key: (mean, var, count)}``, the statistics reduced over
        ``mesh``'s data axis when there is one."""
        raise NotImplementedError

    def forward(self, x):
        if x.shape[-1] != self.n_in:
            raise ValueError(f"{self.name}: expected {self.n_in} channels, "
                             f"got {tuple(x.shape)}")
        if not self.training:
            return self._body(x, *self._leaves(), training=False)[0]
        body = functools.partial(self._body, training=True,
                                 mesh=current_kernel_mesh())
        if self.remat:
            out, stats = checkpoint(body, x, *self._leaves(),
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            out, stats = body(x, *self._leaves())
        for key, (mean, var, count) in stats.items():
            getattr(self, key).update_running_stats(mean, var, count)
        return out


class FusedBottleneck(_FusedResBlock):
    """1x1 -> 3x3 -> 1x1 bottleneck with BatchNorm folded into the
    kernels (fused_block.py:113-247): zero-gamma closing BN, type-B
    shortcut, eps/momentum as in the JAX block."""

    def __init__(self, n_in: int, planes: int, stride: int = 1,
                 expansion: int = 4, eps: float = 1e-5,
                 momentum: float = 0.1, name: Optional[str] = None,
                 remat: bool = True):
        super().__init__(name)
        self.n_in, self.planes, self.stride = n_in, planes, stride
        self.n_out = planes * expansion
        self.eps, self.momentum = eps, momentum
        self.project = stride != 1 or n_in != self.n_out
        self.remat = remat

        self.conv1 = self._conv(n_in, planes, 1)
        self.conv2 = self._conv(planes, planes, 3)
        self.conv3 = self._conv(planes, self.n_out, 1)
        self.bn1 = self._bn(planes)
        self.bn2 = self._bn(planes)
        self.bn3 = self._bn(self.n_out, zero_gamma=True)
        if self.project:
            self.conv_sc = self._conv(n_in, self.n_out, 1)
            self.bn_sc = self._bn(self.n_out)

    def _slots(self):
        return (["conv1", "conv2", "conv3", "bn1", "bn2", "bn3"]
                + (["conv_sc", "bn_sc"] if self.project else []))

    def _body(self, x, *leaves, training: bool, mesh=None):
        """The block (fused_block.py:187-247)."""
        p = {f"{k}.{leaf}": t for (k, leaf), t in zip(self._names(), leaves)}
        matmul, conv3x3 = self._kernels()
        n, h, w, c = x.shape
        dtype = x.dtype
        planes, n_out, s = self.planes, self.n_out, self.stride
        stats = {}

        def consts(key, ssum, ssq, count):
            scale, bias, stats[key] = self._bn_consts(key, p, ssum, ssq,
                                                      count, training, mesh)
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


@contextlib.contextmanager
def _cudnn_tf32(allow: bool):
    """cuDNN's TF32 switch set to ``allow`` for the block's duration."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _StridedConvF32(torch.autograd.Function):
    """A SAME-padded NHWC/HWIO conv of x and w upcast to f32, with an f32
    result: exact products of the bf16 or f32 operands summed in f32, as
    ``conv_general_dilated(..., preferred_element_type=f32)`` sums them
    (fused_block.py:311-318), whatever cuDNN's TF32 switch says outside.
    TF32 is on only where it is exact or below the result's rounding: in
    the forward of bf16 operands (bf16 values are TF32 values) and in the
    backward of a bf16 block, whose gradients round to bf16; an f32
    block runs both directions in full f32.  The backward is JAX's
    transpose: dx and dW in f32, rounded to x's and w's types."""

    @staticmethod
    def forward(ctx, x, w, stride, pads):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads = stride, pads
        with _cudnn_tf32(x.dtype == torch.bfloat16):
            return conv2d_nhwc(x.float(), w.float(), stride, pads)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        (t, b), (l, r) = ctx.pads
        xp = F.pad(x.float().permute(0, 3, 1, 2), (l, r, t, b))
        with _cudnn_tf32(x.dtype == torch.bfloat16):
            dxp, dw, _ = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), xp, w.float().permute(3, 2, 0, 1),
                None, list(ctx.stride), [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        h, wd = x.shape[1], x.shape[2]
        dx = (None if dxp is None else
              dxp[:, :, t:t + h, l:l + wd].permute(0, 2, 3, 1).to(x.dtype))
        dw = None if dw is None else dw.permute(2, 3, 1, 0).to(w.dtype)
        return dx, dw, None, None


class FusedBasicBlock(_FusedResBlock):
    """Two 3x3 convs with BatchNorm folded into the kernels, the
    ResNet-18/34 and CIFAR family's block (fused_block.py:250-345):
    zero-gamma closing BN, type-B shortcut, eps/momentum as in the JAX
    block."""

    def __init__(self, n_in: int, n_out: int, stride: int = 1,
                 eps: float = 1e-5, momentum: float = 0.1,
                 name: Optional[str] = None, remat: bool = True):
        super().__init__(name)
        self.n_in, self.n_out, self.stride = n_in, n_out, stride
        self.eps, self.momentum = eps, momentum
        self.project = stride != 1 or n_in != n_out
        self.remat = remat

        self.conv1 = self._conv(n_in, n_out, 3)
        self.conv2 = self._conv(n_out, n_out, 3)
        self.bn1 = self._bn(n_out)
        self.bn2 = self._bn(n_out, zero_gamma=True)
        if self.project:
            self.conv_sc = self._conv(n_in, n_out, 1)
            self.bn_sc = self._bn(n_out)

    def _slots(self):
        return (["conv1", "conv2", "bn1", "bn2"]
                + (["conv_sc", "bn_sc"] if self.project else []))

    def _body(self, x, *leaves, training: bool, mesh=None):
        """The block (fused_block.py:299-345)."""
        p = {f"{k}.{leaf}": t for (k, leaf), t in zip(self._names(), leaves)}
        matmul, conv3x3 = self._kernels()
        n, h, w, c = x.shape
        dtype = x.dtype
        n_out, s = self.n_out, self.stride
        stats = {}

        def consts(key, ssum, ssq, count):
            scale, bias, stats[key] = self._bn_consts(key, p, ssum, ssq,
                                                      count, training, mesh)
            return scale, bias

        w1 = p["conv1.weight"].to(dtype)
        if s == 1:
            raw1, s1, q1 = conv3x3(x, w1, relu=False)
        else:
            pads = resolve_padding("SAME", (h, w), (3, 3), (s, s))
            yf = _StridedConvF32.apply(x, w1, (s, s), pads)
            raw1 = yf.to(dtype)
            y2 = yf.reshape(-1, n_out)
            s1, q1 = y2.sum(0), (y2 * y2).sum(0)
        ho, wo = raw1.shape[1], raw1.shape[2]
        count = n * ho * wo
        a1, b1 = consts("bn1", s1, q1, count)

        raw2, s2, q2 = conv3x3(raw1, p["conv2.weight"].to(dtype), a1, b1,
                               relu=True)
        a2, b2 = consts("bn2", s2, q2, count)

        if self.project:
            xs = x if s == 1 else x[:, ::s, ::s, :].contiguous()
            ysc, ssc, qsc = matmul(
                xs.reshape(-1, c),
                p["conv_sc.weight"].reshape(c, n_out).to(dtype), relu=False)
            asc, bsc = consts("bn_sc", ssc, qsc, ysc.shape[0])
            sc = (ysc * asc.to(dtype) + bsc.to(dtype)).reshape(n, ho, wo,
                                                               n_out)
        else:
            sc = x
        out = torch.relu(raw2 * a2.to(dtype) + b2.to(dtype) + sc)
        return out, stats


def use_plain_ops(model: torch.nn.Module, plain: bool = True):
    """Switch every fused block and quantized layer of ``model`` to (or
    back from) the kernels' plain PyTorch versions."""
    for m in model.modules():
        if isinstance(m, (_FusedResBlock, QuantizedLinear,
                          QuantizedSpatialConvolution)):
            m.plain = plain
    return model
