"""Validation methods and results (counterpart of
bigdl_tpu/optim/validation.py:43-130; reference optim/ValidationMethod.scala).

A :class:`ValidationMethod` maps one batch's (model output, target) to a
:class:`ValidationResult`; results fold with ``+`` across batches on the
host.  Targets may be numpy arrays or tensors; they are moved to the
output's device.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch


def _target(target: Any, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(target) if not torch.is_tensor(target)
                           else target, device=device)


class ValidationResult:
    def result(self) -> Tuple[float, int]:
        """(metric value, record count)."""
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: float, count: int):
        self.correct = float(correct)
        self.count = int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        v, n = self.result()
        return f"Accuracy({v:.5f}, {n} records)"


class LossResult(ValidationResult):
    def __init__(self, loss_sum: float, count: int):
        self.loss_sum = float(loss_sum)
        self.count = int(count)

    def result(self):
        return (self.loss_sum / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss_sum + other.loss_sum,
                          self.count + other.count)

    def __repr__(self):
        v, n = self.result()
        return f"Loss({v:.5f}, {n} records)"


class ValidationMethod:
    name = "ValidationMethod"

    def __call__(self, output: Any, target: Any) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


class Top1Accuracy(ValidationMethod):
    """Argmax of class scores (or ``> 0.5`` of one binary output) against
    0-based labels; labels < 0 are not counted."""

    name = "Top1Accuracy"

    def __call__(self, output, target):
        target = _target(target, output.device)
        if output.dim() > 2:
            output = output.reshape(-1, output.shape[-1])
            target = target.reshape(-1)
        if output.dim() == 2 and output.shape[-1] > 1:
            pred = output.argmax(-1)
        else:
            pred = (output.reshape(-1) > 0.5).long()
        tgt = target.reshape(-1).long()
        valid = tgt >= 0
        return AccuracyResult(float(((pred == tgt) & valid).sum()),
                              int(valid.sum()))


class Loss(ValidationMethod):
    """Average criterion value, weighted by the batch's first dimension
    (reference ValidationMethod Loss)."""

    name = "Loss"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

        self.criterion = criterion or ClassNLLCriterion(logits=True)

    def __call__(self, output, target):
        loss = self.criterion.forward(output, _target(target, output.device))
        n = int(output.shape[0])
        return LossResult(float(loss) * n, n)
