"""The forward the serving engine runs per bucket (counterpart of
bigdl_tpu/serving/warmup.py:22-31)."""
from __future__ import annotations

from typing import Callable

import torch


def build_forward(model: torch.nn.Module) -> Callable:
    """Eval-mode forward under ``torch.inference_mode()``."""
    model.eval()

    def fwd(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return fwd
