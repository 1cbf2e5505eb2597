"""Normalisation layers (counterpart of bigdl_tpu/nn/norm.py).

The running statistics are buffers named as the JAX state leaves
(``running_mean``, ``running_var``) and stay f32 whatever the compute
type.  Both paths round exactly as bigdl_tpu/nn/norm.py:66-101: the f32
constants are cast to x's type and applied in x's type.

Training takes one-pass f32 batch statistics (``E[x^2] - E[x]^2``,
clamped at 0) and moves the running statistics once per forward with
``momentum`` and the unbiased variance.  The JAX layer returns them as
new state; here they are updated in place, outside autograd.  Inside a
data-parallel step (``ops/partition.py``'s ``kernel_mesh_scope``) the
per-rank ``[E[x], E[x^2]]`` are averaged over the data axis in one
differentiable collective and the count is the global batch's:
``jnp.mean`` over the data-sharded batch under GSPMD (norm.py:76-77).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.conv import conv2d_nhwc, same_pads
from bigdl_tpu_torch.nn.module import Module, constant_on
from bigdl_tpu_torch.ops.partition import current_kernel_mesh, global_means


class BatchNormalization(Module):
    """BatchNorm over the last axis (N, C), (N, T, C) or NHWC.

    With ``affine=False`` the layer holds no ``weight``/``bias`` (both
    ``None``, so its JAX params subtree is ``{}``) and normalises only:
    ``scale = rsqrt(var + eps)``, ``offset = -mean * scale``."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 weight_init=None, name: Optional[str] = None):
        super().__init__(name)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        # Zeros() gives the zero-gamma residual trick
        self.weight_init = weight_init
        if affine:
            self.weight = torch.nn.Parameter(torch.empty(n_output))
            self.bias = torch.nn.Parameter(torch.empty(n_output))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if not self.affine:
            return
        with torch.no_grad():
            if self.weight_init is not None:
                self.weight.copy_(self.weight_init(generator,
                                                   (self.n_output,)))
            else:
                self.weight.fill_(1.0)
            self.bias.zero_()

    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor,
                             count: int):
        """``running = (1 - m) * running + m * batch`` with the unbiased
        variance ``var * count / (count - 1)`` (norm.py:82-88)."""
        m = self.momentum
        with torch.no_grad():
            unbiased = var.detach() * (count / max(count - 1, 1))
            self.running_mean.copy_((1 - m) * self.running_mean
                                    + m * mean.detach())
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            mean, msq = xf.mean(axes), (xf * xf).mean(axes)
            count = x.numel() // x.shape[-1]
            mesh = current_kernel_mesh()
            if mesh is not None:
                mean, msq = global_means(torch.stack([mean, msq]), mesh)
                count *= mesh.shape["data"]
            var = torch.clamp_min(msq - mean * mean, 0.0)
            self.update_running_stats(mean, var, count)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        if not self.affine:
            return x * inv.to(x.dtype) + (-mean * inv).to(x.dtype)
        scale = inv * self.weight.float()
        offset = (-mean * inv) * self.weight.float() + self.bias.float()
        return x * scale.to(x.dtype) + offset.to(x.dtype)


class SpatialBatchNormalization(BatchNormalization):
    """BatchNorm over NHWC images (reduction over N, H, W)."""


class VolumetricBatchNormalization(BatchNormalization):
    """BatchNorm over NDHWC volumes (reference
    nn/VolumetricBatchNormalization)."""


class LayerNormalization(Module):
    """LayerNorm over the last axis (bigdl_tpu/nn/norm.py:115-138): mean,
    variance, normalisation and the affine in f32 whatever x's type, the
    result cast back to x's type."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 name: Optional[str] = None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(hidden_size))
        self.bias = torch.nn.Parameter(torch.zeros(hidden_size))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mean).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class RMSNorm(Module):
    """Root-mean-square norm over the last axis in f32, cast back to x's
    type, with a learned ``weight`` of ones."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 name: Optional[str] = None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(hidden_size))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        ms = torch.square(xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * self.weight.float()
        return y.to(x.dtype)


class GroupNorm(Module):
    """Group norm of channels-last input in x's type: each sample's
    channels split into ``n_groups`` groups normalised over every
    position and the group's channels, then a per-channel affine."""

    def __init__(self, n_groups: int, n_channels: int, eps: float = 1e-5,
                 name=None):
        super().__init__(name)
        if n_channels % n_groups:
            raise ValueError(f"{n_channels} channels do not split into "
                             f"{n_groups} groups")
        self.n_groups, self.n_channels, self.eps = n_groups, n_channels, eps
        self.weight = torch.nn.Parameter(torch.ones(n_channels))
        self.bias = torch.nn.Parameter(torch.zeros(n_channels))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        shape, g = x.shape, self.n_groups
        xg = x.reshape(shape[0], -1, g, shape[-1] // g)
        mean = xg.mean((1, 3), keepdim=True)
        var = torch.square(xg - mean).mean((1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(shape)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class SpatialCrossMapLRN(Module):
    """Local response normalisation across channels (reference
    nn/SpatialCrossMapLRN.scala): ``x / (k + alpha / size * S) ** beta``,
    ``S`` the sum of squares over a zero-padded window of ``size``
    channels centred on each (bigdl_tpu/nn/norm.py:189-197)."""

    def __init__(self, size=5, alpha=1.0, beta=0.75, k=1.0, name=None):
        super().__init__(name)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        half = self.size // 2
        padded = F.pad(torch.square(x), (half, half))
        c = x.shape[-1]
        windows = padded[..., 0:c]
        for i in range(1, self.size):
            windows = windows + padded[..., i:i + c]
        return x / torch.pow(self.k + (self.alpha / self.size) * windows,
                             self.beta)


class Normalize(Module):
    """Lp normalisation along the last axis, the norm clamped at
    ``eps`` (reference nn/Normalize)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10, name=None):
        super().__init__(name)
        self.p, self.eps = p, eps

    def forward(self, x):
        if self.p == 2.0:
            norm = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
        else:
            norm = torch.pow(torch.sum(torch.pow(torch.abs(x), self.p), -1,
                                       keepdim=True), 1.0 / self.p)
        return x / torch.clamp_min(norm, self.eps)


class NormalizeScale(Module):
    """L2 normalisation along the last axis times a learned per-channel
    ``weight`` initialised to ``scale`` (reference nn/NormalizeScale, the
    conv4_3 normalisation of SSD)."""

    def __init__(self, n_channels: int, scale: float = 20.0,
                 eps: float = 1e-10, name=None):
        super().__init__(name)
        self.n_channels, self.scale, self.eps = n_channels, scale, eps
        self.weight = torch.nn.Parameter(torch.full((n_channels,), scale))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(self.scale)

    def forward(self, x):
        norm = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
        return x / torch.clamp_min(norm, self.eps) * self.weight.to(x.dtype)


def _norm_kernel(kernel, n_input_plane: int) -> torch.Tensor:
    """The subtractive and divisive layers' kernel: 9 x 9 ones by
    default, a 1-D kernel made separable (its outer product over its
    sum), then divided by ``sum * n_input_plane`` (norm.py:216-223)."""
    k = (np.ones((9, 9), np.float32) if kernel is None
         else np.asarray(kernel, np.float32))
    if k.ndim == 1:
        k = k[:, None] * k[None, :] / np.sum(k)
    return torch.from_numpy(np.ascontiguousarray(
        k / (np.sum(k) * n_input_plane), dtype=np.float32))


def _local_window_sum(x, kernel: torch.Tensor):
    """The cross-channel weighted local sum of NHWC ``x``: one SAME conv
    of every channel with ``kernel`` into one output channel, (N, H, W,
    1)."""
    kh, kw = kernel.shape
    w = kernel[:, :, None, None].repeat(1, 1, x.shape[-1], 1)
    pads = [same_pads(x.shape[1], kh, 1), same_pads(x.shape[2], kw, 1)]
    return conv2d_nhwc(x, w, (1, 1), pads)


class SpatialSubtractiveNormalization(Module):
    """``x`` less its local cross-channel weighted mean (reference
    nn/SpatialSubtractiveNormalization.scala), the borders corrected by
    the same sum over ones.  The kernel is a fixed tensor, not a
    variable."""

    def __init__(self, n_input_plane: int = 1, kernel=None, name=None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.kernel = _norm_kernel(kernel, n_input_plane)
        self._kernel_on = {}

    def forward(self, x):
        k = constant_on(self.kernel, self._kernel_on, x)
        mean = _local_window_sum(x, k)
        coef = _local_window_sum(torch.ones_like(x), k)
        return x - mean / coef


class SpatialDivisiveNormalization(Module):
    """``x`` over its thresholded local cross-channel std (reference
    nn/SpatialDivisiveNormalization.scala): ``sqrt(max(sum(x^2), 0))``
    over the ones-sum, values not above ``threshold`` replaced by
    ``thresval``."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4,
                 name=None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.kernel = _norm_kernel(kernel, n_input_plane)
        self._kernel_on = {}
        self.threshold = threshold
        self.thresval = thresval

    def forward(self, x):
        k = constant_on(self.kernel, self._kernel_on, x)
        stds = torch.sqrt(torch.clamp_min(
            _local_window_sum(torch.square(x), k), 0.0))
        adjusted = stds / _local_window_sum(torch.ones_like(x), k)
        thresval = torch.tensor(self.thresval, dtype=x.dtype,
                                device=x.device)
        return x / torch.where(adjusted > self.threshold, adjusted, thresval)


class SpatialContrastiveNormalization(Module):
    """Subtractive then divisive normalisation with one kernel (reference
    nn/SpatialContrastiveNormalization.scala); no variables."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4,
                 name=None):
        super().__init__(name)
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval)

    def forward(self, x):
        return self.div(self.sub(x))


class SpatialWithinChannelLRN(Module):
    """Within-channel LRN (reference nn/SpatialWithinChannelLRN.scala,
    Caffe WITHIN_CHANNEL): ``x * (1 + alpha * avg(x^2)) ** -beta``, the
    average over a zero-padded ``size x size`` window divided by
    ``size * size``."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, name=None):
        super().__init__(name)
        if size % 2 != 1:
            raise ValueError(f"LRN size must be odd, got {size}")
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        s = self.size
        sq = torch.square(x).permute(0, 3, 1, 2)
        avg = F.avg_pool2d(F.pad(sq, (s // 2,) * 4), s, 1).permute(0, 2, 3, 1)
        return x * torch.pow(1.0 + self.alpha * avg, -self.beta)
