"""Serving metrics (counterpart of bigdl_tpu/serving/metrics.py):
request latency percentiles and its Prometheus-style histogram
(:data:`LATENCY_BUCKETS`), throughput, batch occupancy, queue depth,
rejected and expired requests, the compile counter ``recompiles`` with
its seconds; the decode engine's counters (prefill and tick times,
decoded tokens, slot occupancy, retirements by reason, pages in use,
page evictions, prefill chunks, speculative draft tokens proposed and
accepted); cost and MFU (each stamped program's operations and bytes,
``telemetry/costmodel.py``, summed per dispatch: GF/s, bytes/s and MFU
over the wall clock since the start, idle time counted); the canonical
``log_line()``; ``write_summary`` to TensorBoard through
``visualization``'s ``ServingSummary``; and
:class:`PeriodicMetricsLogger`, which logs an engine's line on a cadence
and samples the HBM ledger with it.

The timed phases (``recompile``, ``serve_dispatch``, ``serve_fetch``,
``decode_prefill``, ``decode_tick``) are also spans of the shared
tracer, on the thread that records them; latencies and occupancies are
samples, not spans.
"""
from __future__ import annotations

import bisect
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from bigdl_tpu_torch.telemetry import costmodel
from bigdl_tpu_torch.telemetry.tracer import CAT_SERVE, get_tracer

__all__ = ["LATENCY_BUCKETS", "PeriodicMetricsLogger", "ServingMetrics",
           "metrics_log_every_s"]

logger = logging.getLogger("bigdl_tpu_torch.serving")

#: ``le`` bounds (seconds) of the request-latency histogram: cumulative
#: buckets a scraper can add up across hosts, unlike percentiles
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class ServingMetrics:
    """One engine's counters; safe to share across engine threads.

    Latency and occupancy keep the last ``window`` samples; percentiles
    are nearest-rank over that window, as in the JAX package.  JAX's
    leading ``base`` (an ``optim.Metrics`` it records into) has no
    counterpart: these counters keep their own windows.  So ``window``
    is keyword-only, and ``ServingMetrics(m)`` raises instead of taking
    ``m`` for the window."""

    def __init__(self, *, window: int = 4096):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._latency = deque(maxlen=window)
        self._occupancy = deque(maxlen=window)
        self._ticks = deque(maxlen=window)
        self._counts = {"completed": 0, "rejected": 0, "expired": 0,
                        "batches": 0, "recompiles": 0, "decoded_tokens": 0,
                        "page_evictions": 0, "prefill_chunks": 0,
                        "spec_proposed": 0, "spec_accepted": 0}
        # decode phases: (sum, count) since the start, for their means
        self._means = {"prefill": [0.0, 0], "tick": [0.0, 0],
                       "slot_occupancy": [0.0, 0]}
        self._recompile_s = 0.0
        self._queue_depth = 0
        self._pages_in_use = 0
        # raw latency histogram counts; the last cell is +Inf
        self._lat_buckets = [0] * (len(LATENCY_BUCKETS) + 1)
        self._lat_sum = 0.0
        # stamped program costs, and the flops and bytes dispatched
        self._program_costs: dict = {}
        self._flops_done = 0.0
        self._bytes_done = 0.0
        self._compute_devices = 1
        self._tracer = get_tracer()

    # -- recording (engine-internal) -----------------------------------
    def _inc(self, key: str, n: int = 1):
        with self._lock:
            self._counts[key] += n

    def _span(self, name: str, seconds: float):
        """The phase that just ended on this thread as a span."""
        tr = self._tracer
        if tr.enabled:
            t1 = time.perf_counter()
            tr.add_span(name, CAT_SERVE, t1 - seconds, t1)

    def record_latency(self, seconds: float):
        i = bisect.bisect_left(LATENCY_BUCKETS, seconds)  # len: +Inf
        with self._lock:
            self._latency.append(seconds)
            self._lat_sum += seconds
            self._lat_buckets[i] += 1

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
        self._span("recompile", seconds)

    def record_dispatch(self, seconds: float):
        """One batch padded and its forward enqueued (dispatcher)."""
        self._span("serve_dispatch", seconds)

    def record_fetch(self, seconds: float):
        """One batch's wait for its result on the host (drain)."""
        self._span("serve_fetch", seconds)

    def _mean_add(self, key: str, value: float):
        with self._lock:
            m = self._means[key]
            m[0] += value
            m[1] += 1

    def _mean(self, key: str) -> float:
        with self._lock:
            total, n = self._means[key]
        return total / n if n else 0.0

    # -- the decode engine (serving/decode.py) --------------------------
    def record_prefill(self, seconds: float):
        """One prefill batch or prefill chunk, host seconds."""
        self._mean_add("prefill", seconds)
        self._span("decode_prefill", seconds)

    def record_tick(self, seconds: float):
        """One grid tick (one token per active slot), host seconds."""
        with self._lock:
            self._ticks.append(seconds)
        self._mean_add("tick", seconds)
        self._span("decode_tick", seconds)

    def record_decode_tokens(self, n: int):
        self._inc("decoded_tokens", n)

    def record_slot_occupancy(self, frac: float):
        """Active slots / grid slots of one tick."""
        self._mean_add("slot_occupancy", frac)

    def inc_finished(self, reason: str, n: int = 1):
        """Count a sequence retirement by reason: eos, length or
        deadline."""
        with self._lock:
            key = f"finished_{reason}"
            self._counts[key] = self._counts.get(key, 0) + n

    def record_pages(self, in_use: int):
        """Physical KV pages allocated now (a gauge; paged engines set
        it on every allocation and release)."""
        with self._lock:
            self._pages_in_use = int(in_use)

    def inc_page_evictions(self, n: int = 1):
        self._inc("page_evictions", n)

    def inc_prefill_chunks(self, n: int = 1):
        self._inc("prefill_chunks", n)

    def record_spec(self, proposed: int, accepted: int):
        """Speculative rounds: ``proposed`` draft tokens scored by the
        verify pass, ``accepted`` of them taken."""
        with self._lock:
            self._counts["spec_proposed"] += proposed
            self._counts["spec_accepted"] += accepted

    def inc_completed(self, n: int = 1):
        self._inc("completed", n)

    def inc_rejected(self, n: int = 1):
        self._inc("rejected", n)

    def inc_expired(self, n: int = 1):
        self._inc("expired", n)

    def set_queue_depth(self, depth: int):
        with self._lock:
            self._queue_depth = depth

    # -- cost and MFU (telemetry/costmodel.py) --------------------------
    def record_program_cost(self, cost) -> None:
        """Keep the :class:`~bigdl_tpu_torch.telemetry.costmodel.
        ProgramCost` stamp of a program this engine dispatches."""
        with self._lock:
            self._program_costs[cost.name] = cost
            self._compute_devices = max(self._compute_devices,
                                        cost.n_devices)

    def record_compute(self, flops: float, bytes_accessed: float):
        """Account one dispatch of a stamped program."""
        with self._lock:
            self._flops_done += flops
            self._bytes_done += bytes_accessed

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

    def latency_histogram(self) -> dict:
        """The request-latency histogram in Prometheus form: ``buckets``
        is the cumulative (le, count) series ending at +Inf, with the
        ``sum`` and ``count`` pair."""
        with self._lock:
            raw = list(self._lat_buckets)
            total_s = self._lat_sum
        cum, total = [], 0
        for i, le in enumerate(LATENCY_BUCKETS):
            total += raw[i]
            cum.append((le, total))
        n = total + raw[-1]
        cum.append((float("inf"), n))
        return {"buckets": cum, "sum": total_s, "count": n}

    def occupancy(self) -> float:
        """Mean real rows / bucket batch over the sample window."""
        with self._lock:
            xs = list(self._occupancy)
        return sum(xs) / len(xs) if xs else 0.0

    def throughput(self) -> float:
        """Completed requests per second since the metrics started."""
        dt = time.perf_counter() - self._t0
        return self.completed / dt if dt > 0 else 0.0

    @property
    def decoded_tokens(self) -> int:
        return self._counts["decoded_tokens"]

    def finished(self, reason: str) -> int:
        """Sequences retired for ``reason`` (eos, length, deadline)."""
        return self._counts.get(f"finished_{reason}", 0)

    def tokens_per_sec(self) -> float:
        """Decoded tokens per second since the metrics started."""
        dt = time.perf_counter() - self._t0
        return self.decoded_tokens / dt if dt > 0 else 0.0

    def tick_ms(self, q: float) -> float:
        """q-th percentile (0-100, nearest rank) of the tick time over
        the sample window."""
        with self._lock:
            xs = sorted(self._ticks)
        if not xs:
            return 0.0
        i = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
        return 1e3 * xs[i]

    def slot_occupancy(self) -> float:
        """Mean active slots / grid slots over the ticks so far."""
        return self._mean("slot_occupancy")

    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return self._pages_in_use

    @property
    def page_evictions(self) -> int:
        return self._counts["page_evictions"]

    @property
    def prefill_chunks(self) -> int:
        return self._counts["prefill_chunks"]

    @property
    def spec_proposed(self) -> int:
        """Draft tokens the verify passes scored."""
        return self._counts["spec_proposed"]

    @property
    def spec_accepted(self) -> int:
        return self._counts["spec_accepted"]

    def spec_acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens over every speculative round
        (0 when the engine ran none)."""
        with self._lock:
            p = self._counts["spec_proposed"]
            return self._counts["spec_accepted"] / p if p else 0.0

    def program_costs(self) -> dict:
        with self._lock:
            return dict(self._program_costs)

    def gflops_per_sec(self) -> float:
        """Dispatched model GFLOP/s since the start (the cost model's
        operations, not hardware counters)."""
        dt = time.perf_counter() - self._t0
        with self._lock:
            f = self._flops_done
        return f / dt / 1e9 if dt > 0 else 0.0

    def bytes_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        with self._lock:
            b = self._bytes_done
        return b / dt if dt > 0 else 0.0

    def mfu(self) -> float:
        """Model-flops-utilization over the wall clock since the start:
        idle time counts against it."""
        dt = time.perf_counter() - self._t0
        with self._lock:
            f, n = self._flops_done, self._compute_devices
        if dt <= 0 or not f:
            return 0.0
        return costmodel.mfu(f, dt, n_devices=n)

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
            "tokens_per_sec": self.tokens_per_sec(),
            "decoded_tokens": self.decoded_tokens,
            "slot_occupancy": self.slot_occupancy(),
            "p50_tick_ms": self.tick_ms(50),
            "p95_tick_ms": self.tick_ms(95),
            "prefill_ms": 1e3 * self._mean("prefill"),
            "decode_ms": 1e3 * self._mean("tick"),
            "pages_in_use": self.pages_in_use,
            "page_evictions": self.page_evictions,
            "spec_acceptance_rate": self.spec_acceptance_rate(),
            "prefill_chunks": self.prefill_chunks,
            "mfu": self.mfu(),
            "gflops_per_sec": self.gflops_per_sec(),
            "bytes_per_sec": self.bytes_per_sec(),
        }

    #: TensorBoard tag of each snapshot key that :meth:`write_summary`
    #: exports (the JAX package's tags)
    SUMMARY_TAGS = {
        "req_per_sec": "Serving/ThroughputReqPerSec",
        "tokens_per_sec": "Serving/TokensPerSec",
        "p50_ms": "Serving/LatencyP50Ms",
        "p95_ms": "Serving/LatencyP95Ms",
        "p99_ms": "Serving/LatencyP99Ms",
        "occupancy": "Serving/BatchOccupancy",
        "slot_occupancy": "Serving/SlotOccupancy",
        "queue_depth": "Serving/QueueDepth",
        "recompiles": "Serving/Recompiles",
        "completed": "Serving/Completed",
        "rejected": "Serving/Rejected",
        "expired": "Serving/Expired",
        "p50_tick_ms": "Serving/TickP50Ms",
        "p95_tick_ms": "Serving/TickP95Ms",
        "mfu": "Serving/MFU",
        "gflops_per_sec": "Serving/GFlopsPerSec",
        "pages_in_use": "Serving/PagesInUse",
        "page_evictions": "Serving/PageEvictions",
        "spec_acceptance_rate": "Serving/SpecAcceptanceRate",
        "prefill_chunks": "Serving/PrefillChunks",
    }

    def write_summary(self, summary, step: int) -> dict:
        """Write the snapshot's :attr:`SUMMARY_TAGS` through a
        ``visualization`` summary writer (``ServingSummary``); returns
        the snapshot written."""
        snap = self.snapshot()
        for key, tag in self.SUMMARY_TAGS.items():
            summary.add_scalar(tag, float(snap[key]), step)
        return snap

    def log_line(self) -> str:
        s = self.snapshot()
        line = (f"serving: ok={s['completed']} rej={s['rejected']} "
                f"exp={s['expired']} | p50={s['p50_ms']:.2f}ms "
                f"p95={s['p95_ms']:.2f}ms p99={s['p99_ms']:.2f}ms | "
                f"occ={100 * s['occupancy']:.0f}% | "
                f"qdepth={s['queue_depth']} | "
                f"recompiles={s['recompiles']} | "
                f"{s['req_per_sec']:.1f} req/s")
        if s["decoded_tokens"]:
            line += (f" | {s['tokens_per_sec']:.1f} tok/s | "
                     f"slots={100 * s['slot_occupancy']:.0f}% | "
                     f"tick p50={s['p50_tick_ms']:.2f}ms "
                     f"p95={s['p95_tick_ms']:.2f}ms")
        if s["pages_in_use"] or s["page_evictions"]:
            line += (f" | pages={s['pages_in_use']} "
                     f"evict={s['page_evictions']}")
        if s["prefill_chunks"]:
            line += f" | chunks={s['prefill_chunks']}"
        if s["spec_acceptance_rate"]:
            line += f" | spec acc={100 * s['spec_acceptance_rate']:.0f}%"
        if s["gflops_per_sec"]:
            line += (f" | {s['gflops_per_sec']:.1f} GF/s | "
                     f"mfu={100 * s['mfu']:.2f}%")
        return line


def metrics_log_every_s(default: float = 0.0) -> float:
    """The periodic log cadence in seconds from
    ``BIGDL_TPU_METRICS_EVERY_S`` (0, the default, is off)."""
    try:
        return max(0.0, float(os.environ.get("BIGDL_TPU_METRICS_EVERY_S",
                                             default)))
    except ValueError:
        return default


class PeriodicMetricsLogger:
    """A thread that logs an engine's ``log_line()`` every ``every_s``
    seconds (``None``: :func:`metrics_log_every_s`; 0 is off) to
    ``sink`` (default: this module's logger at INFO), and samples the
    HBM ledger on the same cadence (rate-limited by its own
    ``BIGDL_TPU_HBM_EVERY_S``).  ``thread`` is the thread once started
    (``None`` while off).  ``close()`` stops it and is idempotent; both
    serving engines call it from their own ``close()``."""

    def __init__(self, emit: Callable[[], str],
                 every_s: Optional[float] = None,
                 sink: Optional[Callable[[str], None]] = None):
        self.every_s = metrics_log_every_s() if every_s is None \
            else max(0.0, float(every_s))
        self._emit = emit
        self._sink = sink if sink is not None else logger.info
        self._stop = threading.Event()
        self.thread: Optional[threading.Thread] = None

    def start(self) -> "PeriodicMetricsLogger":
        if self.every_s > 0 and self.thread is None \
                and not self._stop.is_set():
            self.thread = threading.Thread(
                target=self._run, daemon=True, name="bigdl-metrics-log")
            self.thread.start()
        return self

    def _run(self):
        from bigdl_tpu_torch.telemetry.programs import get_hbm_ledger

        while not self._stop.wait(self.every_s):
            get_hbm_ledger().maybe_sample()  # never raises
            try:
                self._sink(self._emit())
            except Exception:  # a log line must never stop an engine
                logger.debug("periodic metrics emit failed",
                             exc_info=True)

    @property
    def running(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def close(self, timeout: float = 5.0):
        self._stop.set()
        if self.thread is not None:
            self.thread.join(timeout)
