"""Learning-rate schedules (counterpart of bigdl_tpu/optim/schedules.py:
14-29): host-side functions of the step and epoch giving a multiplier of
the base rate.  Only ``Default`` is ported so far; the additive
schedules' ``bind`` hook comes with them."""
from __future__ import annotations


class LearningRateSchedule:
    def rate(self, step: int, epoch: int = 0) -> float:
        """Multiplicative LR at ``step`` (0-based), given ``epoch``
        (0-based)."""
        raise NotImplementedError


class Default(LearningRateSchedule):
    """Constant base LR (reference SGD.Default)."""

    def rate(self, step, epoch=0):
        return 1.0
