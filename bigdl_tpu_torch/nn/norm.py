"""BatchNorm and LayerNorm (counterpart of bigdl_tpu/nn/norm.py).

The running statistics are buffers named as the JAX state leaves
(``running_mean``, ``running_var``) and stay f32 whatever the compute
type.  Both paths round exactly as bigdl_tpu/nn/norm.py:66-101: the f32
constants are cast to x's type and applied in x's type.

Training takes one-pass f32 batch statistics (``E[x^2] - E[x]^2``,
clamped at 0) and moves the running statistics once per forward with
``momentum`` and the unbiased variance.  The JAX layer returns them as
new state; here they are updated in place, outside autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


class BatchNormalization(Module):
    """Affine BatchNorm over the last axis (N, C), (N, T, C) or NHWC."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, weight_init=None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        # Zeros() gives the zero-gamma residual trick
        self.weight_init = weight_init
        self.weight = torch.nn.Parameter(torch.empty(n_output))
        self.bias = torch.nn.Parameter(torch.empty(n_output))
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
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
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            self.update_running_stats(mean, var, x.numel() // x.shape[-1])
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        scale = inv * self.weight.float()
        offset = (-mean * inv) * self.weight.float() + self.bias.float()
        return x * scale.to(x.dtype) + offset.to(x.dtype)


class SpatialBatchNormalization(BatchNormalization):
    """BatchNorm over NHWC images (reduction over N, H, W)."""


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
