"""Serving metrics (the subset of bigdl_tpu/serving/metrics.py that the
engine records): request latency percentiles, throughput, batch
occupancy, queue depth, rejected and expired requests, the compile
counter ``recompiles`` (bigdl_tpu/serving/metrics.py:27) with its
seconds, and the canonical ``log_line()``.

The JAX engine's cost/MFU columns read XLA's ``cost_analysis`` and have
no counterpart here yet.
"""
from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["ServingMetrics"]


class ServingMetrics:
    """One engine's counters; safe to share across engine threads.

    Latency and occupancy keep the last ``window`` samples; percentiles
    are nearest-rank over that window, as in the JAX package."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._latency = deque(maxlen=window)
        self._occupancy = deque(maxlen=window)
        self._counts = {"completed": 0, "rejected": 0, "expired": 0,
                        "batches": 0, "recompiles": 0}
        self._recompile_s = 0.0
        self._queue_depth = 0

    # -- recording (engine-internal) -----------------------------------
    def _inc(self, key: str, n: int = 1):
        with self._lock:
            self._counts[key] += n

    def record_latency(self, seconds: float):
        with self._lock:
            self._latency.append(seconds)

    def record_batch(self, n_real: int, bucket_batch: int):
        with self._lock:
            self._occupancy.append(n_real / max(1, bucket_batch))
            self._counts["batches"] += 1

    def record_recompile(self, seconds: float):
        """A bucket's forward compiled: on the card a CUDA graph captured
        (its warm-up included), on the CPU the bucket's first sight."""
        with self._lock:
            self._counts["recompiles"] += 1
            self._recompile_s += seconds

    def inc_completed(self, n: int = 1):
        self._inc("completed", n)

    def inc_rejected(self, n: int = 1):
        self._inc("rejected", n)

    def inc_expired(self, n: int = 1):
        self._inc("expired", n)

    def set_queue_depth(self, depth: int):
        with self._lock:
            self._queue_depth = depth

    # -- reading -------------------------------------------------------
    @property
    def completed(self) -> int:
        return self._counts["completed"]

    @property
    def rejected(self) -> int:
        return self._counts["rejected"]

    @property
    def expired(self) -> int:
        return self._counts["expired"]

    @property
    def batches(self) -> int:
        """Bucket batches dispatched (each is one model forward)."""
        return self._counts["batches"]

    @property
    def recompiles(self) -> int:
        """Compiled forwards so far: the declared buckets right after
        warmup; any growth is a bucket the grid missed, compiled on the
        request path."""
        return self._counts["recompiles"]

    @property
    def recompile_seconds(self) -> float:
        return self._recompile_s

    @property
    def first_sights(self) -> int:
        """Buckets seen for the first time: each is compiled once, so
        this is :attr:`recompiles`."""
        return self.recompiles

    @property
    def queue_depth(self) -> int:
        return self._queue_depth

    def latency_ms(self, q: float) -> float:
        """q-th percentile (0-100, nearest rank) of request latency."""
        with self._lock:
            xs = sorted(self._latency)
        if not xs:
            return 0.0
        i = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
        return 1e3 * xs[i]

    def occupancy(self) -> float:
        """Mean real rows / bucket batch over the sample window."""
        with self._lock:
            xs = list(self._occupancy)
        return sum(xs) / len(xs) if xs else 0.0

    def throughput(self) -> float:
        """Completed requests per second since the metrics started."""
        dt = time.perf_counter() - self._t0
        return self.completed / dt if dt > 0 else 0.0

    def snapshot(self) -> dict:
        return {
            "completed": self.completed,
            "rejected": self.rejected,
            "expired": self.expired,
            "batches": self.batches,
            "p50_ms": self.latency_ms(50),
            "p95_ms": self.latency_ms(95),
            "p99_ms": self.latency_ms(99),
            "occupancy": self.occupancy(),
            "queue_depth": self.queue_depth,
            "recompiles": self.recompiles,
            "recompile_seconds": self.recompile_seconds,
            "req_per_sec": self.throughput(),
        }

    def log_line(self) -> str:
        s = self.snapshot()
        return (f"serving: ok={s['completed']} rej={s['rejected']} "
                f"exp={s['expired']} | p50={s['p50_ms']:.2f}ms "
                f"p95={s['p95_ms']:.2f}ms p99={s['p99_ms']:.2f}ms | "
                f"occ={100 * s['occupancy']:.0f}% | "
                f"qdepth={s['queue_depth']} | "
                f"recompiles={s['recompiles']} | "
                f"{s['req_per_sec']:.1f} req/s")
