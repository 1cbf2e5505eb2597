"""Triggers (counterpart of bigdl_tpu/optim/triggers.py): predicates over
the host-side training state dict (keys ``epoch``, ``neval``,
``epoch_finished``, ...) deciding when to stop."""
from __future__ import annotations

from typing import Any, Callable, Dict


class Trigger:
    def __init__(self, fn: Callable[[Dict[str, Any]], bool],
                 desc: str = "trigger"):
        self._fn = fn
        self.desc = desc

    def __call__(self, state: Dict[str, Any]) -> bool:
        return bool(self._fn(state))

    def __repr__(self):
        return f"Trigger({self.desc})"

    @staticmethod
    def every_epoch() -> "Trigger":
        """Fires when an epoch boundary was just crossed."""
        return Trigger(lambda s: s.get("epoch_finished", False),
                       "everyEpoch")

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s.get("neval", 0) % n == 0
                       and s.get("neval", 0) > 0, f"severalIteration({n})")

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return Trigger(lambda s: s.get("epoch", 0) >= n, f"maxEpoch({n})")

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return Trigger(lambda s: s.get("neval", 0) >= n,
                       f"maxIteration({n})")
