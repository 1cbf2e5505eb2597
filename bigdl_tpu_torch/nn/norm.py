"""BatchNorm, eval path (counterpart of bigdl_tpu/nn/norm.py).

The running statistics are buffers named as the JAX state leaves
(``running_mean``, ``running_var``) and stay f32 whatever the compute
type.  The eval forward rounds exactly as bigdl_tpu/nn/norm.py:92-100:
the f32 constants are cast to x's type and applied in x's type.
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

    def eval_constants(self):
        """f32 ``(scale, offset)`` with ``y = x * scale + offset``, in the
        JAX layer's order of operations."""
        inv = torch.rsqrt(self.running_var + self.eps)
        w, b = self.weight.float(), self.bias.float()
        return inv * w, (-self.running_mean * inv) * w + b

    def forward(self, x):
        self._require_eval()
        scale, offset = self.eval_constants()
        return x * scale.to(x.dtype) + offset.to(x.dtype)


class SpatialBatchNormalization(BatchNormalization):
    """BatchNorm over NHWC images (reduction over N, H, W)."""
