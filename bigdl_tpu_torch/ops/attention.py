"""Scaled dot-product attention (counterpart of bigdl_tpu/ops/attention.py).

The mask-free, bias-free case goes to the flash kernel
(:func:`bigdl_tpu_torch.ops.flash_attention.flash_attention`), with no
fallback: on a CUDA tensor the kernel runs or the call raises.  A mask or
a bias (or ``use_flash=False``) takes the plain path: f32 scores, masked
scores set to -1e30, an f32 softmax cast to q's type, then ``p @ v``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention over ``(B, H, Tq, D)`` queries and ``(B, H, Tk, D)``
    keys/values.  ``mask`` broadcasts to ``(B, H, Tq, Tk)`` (True keeps a
    score); ``use_flash=None`` takes the kernel exactly when there is no
    mask and no bias.  The plain path's causal mask is bottom-right
    aligned (``tril(k=Tk-Tq)``), as the JAX function's."""
    if use_flash is None:
        use_flash = mask is None and bias is None
    if use_flash and mask is None and bias is None:
        return flash_attention(q, k, v, causal=causal, sm_scale=scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        scores = torch.where(keep, scores, -1e30)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)
