"""Per-iteration phase timers of the training loop (counterpart of the
subset of bigdl_tpu/optim/metrics.py that the training log line reads):
named timers accumulated per phase (``data``, ``compute``), non-time
values (``throughput``), and ``summary()``, the reference
Metrics.summary line.  The synchronous loop is one thread, so there is
no lock."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class Metrics:
    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._values: Dict[str, float] = {}

    def add(self, name: str, seconds: float):
        self._sums[name] = self._sums.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + 1

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def get(self, name: str) -> float:
        """Average seconds per sample of phase ``name``."""
        c = self._counts.get(name, 0)
        return self._sums.get(name, 0.0) / c if c else 0.0

    def set_value(self, name: str, value: float):
        """Set a non-time scalar (throughput); ``summary()`` prints it
        without a unit."""
        self._values[name] = float(value)

    def summary(self, unit_scale: float = 1e3) -> str:
        """One line, average ms per phase, then the values."""
        parts = [f"{k}: {self.get(k) * unit_scale:.2f}ms"
                 for k in sorted(self._sums)]
        parts += [f"{k}: {v:.4g}" for k, v in sorted(self._values.items())]
        return " | ".join(parts)
