"""Loss functions (counterpart of bigdl_tpu/nn/criterion.py:19-84,
293-309).

A :class:`Criterion` is a callable ``loss = crit(input, target)``
returning a scalar in the input's type; gradients come from autograd.
Class labels are 0-based integers.
"""
from __future__ import annotations

from typing import Optional

import torch


class Criterion:
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def per_sample(self, input, target) -> torch.Tensor:
        """Loss per batch element, shape (N,)."""
        raise NotImplementedError

    def forward(self, input, target) -> torch.Tensor:
        ls = self.per_sample(input, target)
        return ls.mean() if self.size_average else ls.sum()

    def __call__(self, input, target):
        return self.forward(input, target)

    def backward(self, input, target):
        """Gradient with respect to ``input`` (reference
        Criterion.backward), by autograd."""
        x = input.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(self.forward(x, target), x)[0]


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities, or over logits with ``logits=True``
    (reference nn/ClassNLLCriterion.scala).  ``weights`` are per-class;
    targets are integer labels (one-hot rows are not ported yet).  Rows
    whose label equals ``padding_value`` (by default, any label < 0) are
    masked out, and with ``size_average`` the mean is over the weight of
    the rows kept, as bigdl_tpu/nn/criterion.py:57-84 computes it."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True, logits: bool = False,
                 padding_value: Optional[int] = None):
        super().__init__(size_average)
        self.weights = weights
        self.logits = logits
        self.padding_value = padding_value

    def per_sample(self, input, target):
        logp = torch.log_softmax(input, -1) if self.logits else input
        logp = logp.reshape(-1, logp.shape[-1])
        tgt = target.reshape(-1).long()
        safe = tgt.clamp(0, logp.shape[-1] - 1)
        nll = -logp.gather(1, safe[:, None])[:, 0]
        w = (self.weights.to(nll.device)[safe] if self.weights is not None
             else torch.ones_like(nll))
        valid = (tgt != self.padding_value if self.padding_value is not None
                 else tgt >= 0)
        nll = torch.where(valid, nll * w, 0.0)
        if self.size_average:
            denom = torch.clamp_min(torch.where(valid, w, 0.0).sum(), 1e-8)
            return nll * (nll.shape[0] / denom)  # folded into mean()
        return nll


class TimeDistributedCriterion(Criterion):
    """``critrn`` applied at every timestep of ``(N, T, ...)`` inputs
    (reference nn/TimeDistributedCriterion.scala): input and target are
    folded to ``(N * T, ...)`` and the inner criterion's reduction (a
    mean over all N * T rows for ``ClassNLLCriterion``) is the loss."""

    def __init__(self, critrn: Criterion, size_average: bool = True,
                 dimension: int = 1):
        super().__init__(size_average)
        self.critrn = critrn

    def forward(self, input, target):
        n, t = input.shape[0], input.shape[1]
        flat_in = input.reshape((n * t,) + tuple(input.shape[2:]))
        flat_tgt = target.reshape((n * t,) + tuple(target.shape[2:]))
        return self.critrn.forward(flat_in, flat_tgt)
