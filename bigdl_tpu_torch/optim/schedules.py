"""Learning-rate schedules (counterpart of bigdl_tpu/optim/schedules.py:
14-241; reference optim/SGD.scala:233-671).

A schedule is a host-side function of the 0-based step and epoch that
gives a multiplier of the method's base rate.  The rate it gives goes
into the compiled train step's device scalar (``CompiledTrainStep``
fills it before each replay), so a new rate never needs a new capture.
``bind`` hands the additive schedules (``Warmup``) the method's base
rate; ``OptimMethod.current_rate`` calls it.  ``Plateau`` keeps host
state and moves when the loop's validation calls ``record``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence


class LearningRateSchedule:
    def rate(self, step: int, epoch: int = 0) -> float:
        """Multiplicative LR at ``step`` (0-based), given ``epoch`` (0-based)."""
        raise NotImplementedError

    def bind(self, base_lr: float) -> None:
        """Hook giving additive schedules (Warmup) the optimizer's base LR
        so ``delta`` is absolute, as in the reference.  Called by
        OptimMethod.current_rate; default no-op."""


class Default(LearningRateSchedule):
    """Constant base LR (reference SGD.Default)."""

    def rate(self, step, epoch=0):
        return 1.0


class Poly(LearningRateSchedule):
    """lr * (1 - step/max_iteration)^power (reference SGD.Poly) — the
    ResNet-50 ImageNet recipe's decay."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def rate(self, step, epoch=0):
        if step >= self.max_iteration:
            return 0.0
        return (1.0 - step / self.max_iteration) ** self.power


class Step(LearningRateSchedule):
    """lr * gamma^floor(step/step_size) (reference SGD.Step)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, step, epoch=0):
        return self.gamma ** (step // self.step_size)


class MultiStep(LearningRateSchedule):
    """Decay at given iteration milestones (reference SGD.MultiStep)."""

    def __init__(self, step_sizes: Sequence[int], gamma: float):
        self.step_sizes = sorted(step_sizes)
        self.gamma = gamma

    def rate(self, step, epoch=0):
        n = sum(1 for s in self.step_sizes if step >= s)
        return self.gamma**n


class EpochStep(LearningRateSchedule):
    """lr * gamma^floor(epoch/step_size) (reference SGD.EpochStep)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, step, epoch=0):
        return self.gamma ** (epoch // self.step_size)


class EpochDecay(LearningRateSchedule):
    """Arbitrary epoch -> decay-exponent function (reference SGD.EpochDecay)."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def rate(self, step, epoch=0):
        return 0.1 ** self.decay_fn(epoch)


class Exponential(LearningRateSchedule):
    """lr * decay_rate^(step/decay_step) (reference SGD.Exponential)."""

    def __init__(self, decay_step: int, decay_rate: float, stair_case: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def rate(self, step, epoch=0):
        exp = step / self.decay_step
        if self.stair_case:
            exp = math.floor(exp)
        return self.decay_rate**exp


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(step/decay_step)) (reference SGD.NaturalExp)."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step = decay_step
        self.gamma = gamma

    def rate(self, step, epoch=0):
        return math.exp(-self.gamma * (step // self.decay_step))


class Warmup(LearningRateSchedule):
    """Linear warmup adding ``delta`` per step (reference SGD.Warmup);
    combine inside SequentialSchedule.  rate here is relative: base LR is
    multiplied outside, so we return (1 + delta*step/base) shape via the
    composed form used by SequentialSchedule."""

    def __init__(self, delta: float):
        self.delta = delta
        self.base_lr: Optional[float] = None  # bound via bind()

    def bind(self, base_lr: float) -> None:
        if self.base_lr is None:
            self.base_lr = base_lr

    def rate(self, step, epoch=0):
        base = self.base_lr if self.base_lr else 1.0
        return (base + self.delta * step) / base


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for its ``max_iteration`` steps
    (reference SGD.SequentialSchedule) — e.g. Warmup then Poly."""

    def __init__(self, iterations_per_epoch: int = 1):
        self.iterations_per_epoch = iterations_per_epoch
        self.schedules: List[LearningRateSchedule] = []
        self.durations: List[int] = []

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.schedules.append(schedule)
        self.durations.append(max_iteration)
        return self

    def bind(self, base_lr: float) -> None:
        for s in self.schedules:
            s.bind(base_lr)

    def rate(self, step, epoch=0):
        offset = 0
        for sched, dur in zip(self.schedules, self.durations):
            if step < offset + dur or sched is self.schedules[-1]:
                local = step - offset
                return sched.rate(local, epoch)
            offset += dur
        return self.schedules[-1].rate(step - offset, epoch) if self.schedules else 1.0


class Plateau(LearningRateSchedule):
    """Reduce LR when a monitored metric stops improving (reference
    SGD.Plateau).  Call :meth:`record` after each validation."""

    def __init__(
        self,
        monitor: str = "score",
        factor: float = 0.1,
        patience: int = 10,
        mode: str = "min",
        epsilon: float = 1e-4,
        cooldown: int = 0,
        min_lr: float = 0.0,
    ):
        assert mode in ("min", "max")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._scale = 1.0
        self._best: Optional[float] = None
        self._wait = 0
        self._cooldown_counter = 0

    def record(self, value: float, base_lr: float = 1.0):
        if self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        improved = (
            self._best is None
            or (self.mode == "min" and value < self._best - self.epsilon)
            or (self.mode == "max" and value > self._best + self.epsilon)
        )
        if improved:
            self._best = value
            self._wait = 0
        elif self._cooldown_counter <= 0:
            self._wait += 1
            if self._wait >= self.patience:
                new_scale = max(self._scale * self.factor, self.min_lr / max(base_lr, 1e-12))
                self._scale = new_scale
                self._cooldown_counter = self.cooldown
                self._wait = 0

    def rate(self, step, epoch=0):
        return self._scale


class EpochDecayWithWarmUp(LearningRateSchedule):
    """Linear warmup for ``warmup_epochs`` then stepwise epoch decay
    (reference SGD.EpochDecayWithWarmUp — the Inception recipe)."""

    def __init__(self, warmup_epochs: int, delta: float, decay_fn):
        self.warmup_epochs = warmup_epochs
        self.delta = delta
        self.decay_fn = decay_fn
        self.base_lr = 1.0

    def rate(self, step, epoch=0):
        if epoch < self.warmup_epochs:
            return (self.base_lr + self.delta * step) / self.base_lr
        return 0.1 ** self.decay_fn(epoch)


class PolyEpochDecay(LearningRateSchedule):
    """Poly keyed on epochs — the maxEpoch variant used by the ResNet
    recipe's warmup+poly composition."""

    def __init__(self, power: float, max_epoch: int):
        self.power = power
        self.max_epoch = max_epoch

    def rate(self, step, epoch=0):
        if epoch >= self.max_epoch:
            return 0.0
        return (1.0 - epoch / self.max_epoch) ** self.power
