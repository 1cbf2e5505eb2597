"""Embedding (counterpart of bigdl_tpu/nn/embedding.py:19-62).

Indices are 0-based.  ``max_norm`` renormalises the rows functionally at
lookup time, as the JAX layer does, instead of writing the weight in
place; ``padding_value`` rows are initialised to 0 and looked up as 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.init import InitializationMethod, RandomNormal
from bigdl_tpu_torch.nn.module import Module


class LookupTable(Module):
    """``weight[indices]`` with an ``(n_index, n_output)`` weight."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: Optional[int] = None,
                 max_norm: Optional[float] = None, norm_type: float = 2.0,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.weight_init = weight_init or RandomNormal(0.0, 1.0)
        self.weight = torch.nn.Parameter(torch.empty(n_index, n_output))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.copy_(self.weight_init(
                generator, (self.n_index, self.n_output),
                fan_in=self.n_index, fan_out=self.n_output))
            if self.padding_value is not None:
                self.weight[self.padding_value] = 0.0

    def forward(self, indices):
        w = self.weight
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=-1,
                                             keepdim=True)
            w = w * torch.clamp_max(
                self.max_norm / torch.clamp_min(norms, 1e-7), 1.0)
        y = w[indices.long()]
        if self.padding_value is not None:
            keep = (indices != self.padding_value)[..., None]
            y = torch.where(keep, y, torch.zeros_like(y))
        return y
