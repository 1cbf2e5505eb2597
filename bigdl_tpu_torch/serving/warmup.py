"""The forward the serving engine runs per bucket, and its compile
(counterpart of bigdl_tpu/serving/warmup.py:22-44)."""
from __future__ import annotations

from typing import Callable

import torch

from bigdl_tpu_torch.serving.bucketing import Bucket
from bigdl_tpu_torch.utils import graphs


def build_forward(model: torch.nn.Module) -> Callable:
    """Eval-mode forward under ``torch.inference_mode()``: the eager body
    that :func:`compile_bucket` compiles."""
    model.eval()

    def fwd(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return fwd


def compile_bucket(forward: Callable, bucket: Bucket, dtype: torch.dtype,
                   device: torch.device, pool=None) -> Callable:
    """``forward`` compiled for one bucket's padded ``(batch,) + dims``
    batch of ``dtype`` (``utils/graphs.py``): on the card a CUDA graph
    whose static input is a zero batch of its own, captured into
    ``pool``; on the CPU the eager forward."""
    x = torch.zeros((bucket.batch,) + tuple(bucket.dims), dtype=dtype,
                    device=device)
    return graphs.compile(forward, (x,), pool)
