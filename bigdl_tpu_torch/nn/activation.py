"""Activations (counterpart of bigdl_tpu/nn/activation.py)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


class ReLU(Module):
    def forward(self, x):
        return torch.relu(x)
