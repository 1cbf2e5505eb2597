"""Per-iteration phase timers of the training loop (counterpart of the
subset of bigdl_tpu/optim/metrics.py:50-151 that the training loop
reads): named timers accumulated per phase, non-time values
(``throughput``), and ``summary()``, the reference Metrics.summary line.

The phases: the synchronous loop (``BIGDL_TPU_SYNC_LOOP=1``) times
``data`` (the batch placed on the device) and ``compute`` (the step up to
its loss on the host).  The async loop, the default, times ``data`` on
the prefetch thread (a batch's production and copy to the device),
``data_stall`` (how long the loop waited for the prefetcher),
``dispatch`` (the step enqueued, not run) and ``sync`` (the deferred
loss reads, the loop's only waits on the device); its checkpoints add
``checkpoint_snapshot`` (the trees copied to the host on the loop
thread).  A gauge (:meth:`set_gauge`) is a phase time computed out of
band, such as ``DistriOptimizer``'s ``allreduce``: ``get`` and
``summary()`` read it as they read a phase.  The prefetch thread adds its times while the loop thread adds
its own, so every update takes a lock.

Every ``Metrics`` is a span sink (bigdl_tpu/optim/metrics.py:31-84):
each :meth:`add` of a phase emits a span into the global
:mod:`bigdl_tpu_torch.telemetry` tracer, ``[now - seconds, now]`` on the
calling thread in category ``train``, so the phase timers of
the loop, the prefetcher and the checkpoint writer land on one timeline.
A sample that is not an interval of the calling thread opts out with
:meth:`no_span`.  With the tracer off an add costs one attribute check
more.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Set

from bigdl_tpu_torch.telemetry.tracer import CAT_TRAIN, get_tracer


class Metrics:
    """``category`` is the tracer category of the spans it emits
    (``"train"`` for the loop, ``"serve"`` for an engine)."""

    def __init__(self, category: str = CAT_TRAIN):
        self.category = category
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._last: Dict[str, float] = {}
        self._values: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._no_span: Set[str] = set()
        self._lock = threading.Lock()
        self._tracer = get_tracer()

    def no_span(self, name: str) -> "Metrics":
        """Opt ``name`` out of spans: a sample that is not an interval of
        the calling thread (the loop's ``data`` under the async engine,
        timed by the prefetch thread, which records its own
        ``prefetch_item`` span)."""
        self._no_span.add(name)
        return self

    def add(self, name: str, seconds: float):
        with self._lock:
            self._sums[name] = self._sums.get(name, 0.0) + seconds
            self._counts[name] = self._counts.get(name, 0) + 1
            self._last[name] = seconds
        tr = self._tracer
        if tr.enabled and name not in self._no_span:
            # the phase just ended: [now - seconds, now]
            t1 = time.perf_counter()
            tr.add_span(name, self.category, t1 - seconds, t1)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def get(self, name: str) -> float:
        """Average seconds per sample of phase ``name`` (a gauge's
        value)."""
        with self._lock:
            if name in self._gauges:
                return self._gauges[name]
            c = self._counts.get(name, 0)
            return self._sums.get(name, 0.0) / c if c else 0.0

    def count(self, name: str) -> int:
        return self._counts.get(name, 0)

    def last(self, name: str) -> float:
        """The latest sample of ``name`` (free of the first call's
        capture time, unlike the average)."""
        return self._last.get(name, 0.0)

    def set_gauge(self, name: str, seconds: float):
        """Set a phase time computed out of band (seconds)."""
        with self._lock:
            self._gauges[name] = float(seconds)

    def set_value(self, name: str, value: float):
        """Set a non-time scalar (throughput); ``summary()`` prints it
        without a unit."""
        with self._lock:
            self._values[name] = float(value)

    def value(self, name: str, default: float = 0.0) -> float:
        return self._values.get(name, default)

    def values(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)

    def phases(self) -> list:
        """The names of the phases timed so far."""
        with self._lock:
            return list(self._sums)

    def summary(self, unit_scale: float = 1e3) -> str:
        """One line, average ms per phase, then the values."""
        with self._lock:
            names = sorted(set(self._sums) | set(self._gauges))
            values = sorted(self._values.items())
        parts = [f"{k}: {self.get(k) * unit_scale:.2f}ms" for k in names]
        parts += [f"{k}: {v:.4g}" for k, v in values]
        return " | ".join(parts)
