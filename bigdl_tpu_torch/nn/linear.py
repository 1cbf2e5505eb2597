"""Linear (counterpart of bigdl_tpu/nn/linear.py)."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.init import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.module import Module


class Linear(Module):
    """``y = x @ weight + bias`` with an ``(in, out)`` weight, as the
    JAX layer stores it (bigdl_tpu/nn/linear.py:17)."""

    def __init__(self, input_size: int, output_size: int,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        self.weight = torch.nn.Parameter(torch.empty(input_size,
                                                     output_size))
        self.bias = torch.nn.Parameter(torch.empty(output_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(self.weight_init(
                generator, (self.input_size, self.output_size),
                fan_in=self.input_size, fan_out=self.output_size))
            self.bias.copy_(self.bias_init(
                generator, (self.output_size,), fan_in=self.input_size))

    def forward(self, x):
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)
