"""Anomaly watchdog over the span stream (counterpart of
bigdl_tpu/telemetry/watchdog.py).

The :class:`Watchdog` subscribes to the tracer and turns the span
stream into counters and log lines the moment an anomaly happens, while
the trace that explains it is still in the ring:

* **step-time spikes**: a step phase (``dispatch``/``compute``/
  ``decode_tick``) above ``spike_factor`` x its rolling p99;
* **steady-state recompiles**: a ``recompile`` span while armed (the
  engines capture their declared programs at construction, so a
  watchdog attached after counts only misses); when the program registry
  (telemetry/programs.py) emitted a ``recompile_forensics`` instant for
  the same compile, the anomaly names the program and the changed axis;
* **HBM headroom**: the ledger's ``hbm_headroom`` instant, naming the
  program with the largest footprint;
* **prefetch starvation**: the loop's ``data_stall`` above
  ``stall_ratio`` of step time over a rolling window;
* **queue saturation and deadline rejections**: the engines'
  ``queue_full`` and ``deadline_reject`` instants;
* **deferred-NaN drains**: the loop's ``loss_divergence`` instant, with
  the iteration that produced the NaN and the one that read it;
* **numerics warnings**: ``numerics_anomaly`` instants, counted by kind.

Counters export to TensorBoard through :meth:`Watchdog.write_summary`
and to the JSONL dump through :meth:`Watchdog.report`.
``BIGDL_TPU_WATCHDOG_MAX_WINDOW`` caps every rolling window.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from bigdl_tpu_torch.telemetry.programs import (
    FORENSIC_EVENT,
    HBM_HEADROOM_EVENT,
)
from bigdl_tpu_torch.telemetry.tracer import Span, Tracer, get_tracer

logger = logging.getLogger("bigdl_tpu_torch.telemetry")

DEFAULT_MAX_WINDOW = 4096


def _env_max_window() -> int:
    """Hard ceiling on any rolling-percentile window
    (``BIGDL_TPU_WATCHDOG_MAX_WINDOW``): under a multi-day run every
    sample store must stay bounded, whatever a caller passes."""
    try:
        return max(8, int(os.environ.get("BIGDL_TPU_WATCHDOG_MAX_WINDOW",
                                         DEFAULT_MAX_WINDOW)))
    except ValueError:
        return DEFAULT_MAX_WINDOW

# span/instant names the shipped instrumentation emits
STEP_SPANS = ("dispatch", "compute", "decode_tick")
STALL_SPAN = "data_stall"
RECOMPILE_SPAN = "recompile"
QUEUE_FULL_EVENT = "queue_full"
DEADLINE_EVENT = "deadline_reject"
DIVERGENCE_EVENT = "loss_divergence"
NUMERICS_EVENT = "numerics_anomaly"

# numerics_anomaly kind -> watchdog counter
_NUMERICS_COUNTERS = {
    "nonfinite": "nonfinite_grads",
    "grad_spike": "grad_norm_spikes",
    "grad_vanish": "grad_norm_vanishes",
    "update_ratio": "update_ratio_bands",
}


class Watchdog:
    """Span-stream consumer raising counters/log lines on anomalies.

    Attach with :meth:`attach` (subscribes to the tracer); every
    recorded span flows through :meth:`observe` on the recording
    thread, so the work per span is O(1) appends — percentile scans
    only run on the spans that look anomalous.
    """

    COUNTERS = ("step_time_spikes", "steady_state_recompiles",
                "prefetch_starvation_windows", "queue_full",
                "deadline_rejects", "nan_windows", "peer_failures",
                "hbm_headroom", "nonfinite_grads", "grad_norm_spikes",
                "grad_norm_vanishes", "update_ratio_bands")

    # counter -> TensorBoard tag (visualization round-trip tested)
    SUMMARY_TAGS = {
        "step_time_spikes": "Watchdog/StepTimeSpikes",
        "steady_state_recompiles": "Watchdog/SteadyStateRecompiles",
        "prefetch_starvation_windows": "Watchdog/PrefetchStarvationWindows",
        "queue_full": "Watchdog/QueueFull",
        "deadline_rejects": "Watchdog/DeadlineRejects",
        "nan_windows": "Watchdog/NanWindows",
        "peer_failures": "Watchdog/PeerFailures",
        "hbm_headroom": "Watchdog/HbmHeadroom",
        "nonfinite_grads": "Watchdog/NonfiniteGrads",
        "grad_norm_spikes": "Watchdog/GradNormSpikes",
        "grad_norm_vanishes": "Watchdog/GradNormVanishes",
        "update_ratio_bands": "Watchdog/UpdateRatioBands",
    }

    def __init__(self, *,
                 step_spans=STEP_SPANS,
                 window: int = 256,
                 min_samples: int = 20,
                 spike_factor: float = 3.0,
                 stall_ratio: float = 0.5,
                 stall_window: int = 32,
                 armed: bool = True,
                 log=logger.warning,
                 max_anomalies: int = 256):
        self.counters: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        self.anomalies: List[Dict] = []
        self._step_spans = tuple(step_spans)
        # every rolling sample store is clamped to the max-window knob
        # so no configuration can grow memory without bound over a
        # multi-day run (anomalies are likewise capped below)
        max_window = _env_max_window()
        self._window = min(int(window), max_window)
        self._min_samples = int(min_samples)
        self._spike_factor = float(spike_factor)
        self._stall_ratio = float(stall_ratio)
        self._stall_window = min(int(stall_window), max_window)
        self._armed = bool(armed)
        self._log = log
        self._max_anomalies = int(max_anomalies)
        self._lock = threading.Lock()
        self._durations: Dict[str, Deque[float]] = {
            n: deque(maxlen=self._window) for n in self._step_spans}
        # cached rolling p99 per step span, refreshed every
        # ``_refresh`` observations: a full window sort per span would
        # put O(window log window) on the hot loop thread
        self._p99: Dict[str, Optional[float]] = {
            n: None for n in self._step_spans}
        self._since_refresh: Dict[str, int] = {
            n: 0 for n in self._step_spans}
        self._refresh = 16
        self._stall_s = 0.0
        self._busy_s = 0.0
        self._stall_n = 0
        # last forensic instant from the program registry, consumed by
        # the next recompile span so the anomaly names the cause
        self._last_forensic: Optional[Dict] = None
        self._tracer: Optional[Tracer] = None

    # -- lifecycle -----------------------------------------------------
    def attach(self, tracer: Optional[Tracer] = None) -> "Watchdog":
        self._tracer = tracer if tracer is not None else get_tracer()
        self._tracer.subscribe(self.observe)
        return self

    def close(self):
        if self._tracer is not None:
            self._tracer.unsubscribe(self.observe)
            self._tracer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def arm(self):
        """Start counting recompiles as steady-state misses (call once
        warmup is done)."""
        self._armed = True

    def disarm(self):
        self._armed = False

    # -- the span feed -------------------------------------------------
    def observe(self, span: Span):
        name = span.name
        if name in self._durations:
            self._observe_step(name, span)
            with self._lock:
                self._busy_s += span.duration
        elif name == STALL_SPAN:
            self._observe_stall(span)
        elif name == FORENSIC_EVENT:
            with self._lock:
                self._last_forensic = dict(span.args or {})
        elif name == RECOMPILE_SPAN:
            if self._armed:
                with self._lock:
                    forensic, self._last_forensic = \
                        self._last_forensic, None
                if forensic and forensic.get("program"):
                    self._raise(
                        "steady_state_recompiles", span,
                        f"steady-state recompile "
                        f"({1e3 * span.duration:.1f}ms) — "
                        f"{forensic['program']}: "
                        f"{forensic.get('cause', 'signature changed')}")
                else:
                    self._raise(
                        "steady_state_recompiles", span,
                        f"steady-state recompile "
                        f"({1e3 * span.duration:.1f}ms) — a request/"
                        f"shape missed the declared grid")
        elif name == HBM_HEADROOM_EVENT:
            a = span.args or {}
            top = a.get("top_program") or ""
            self._raise(
                "hbm_headroom", span,
                f"HBM headroom low: {100 * a.get('frac_free', 0.0):.1f}% "
                f"free ({a.get('bytes_in_use', '?')} of "
                f"{a.get('bytes_limit', '?')} bytes in use"
                + (f"; top program {top}" if top else "") + ")")
        elif name == QUEUE_FULL_EVENT:
            self._raise("queue_full", span,
                        f"request queue saturated (corr={span.corr})")
        elif name == DEADLINE_EVENT:
            self._raise("deadline_rejects", span,
                        f"deadline expired before dispatch "
                        f"(corr={span.corr})")
        elif name == DIVERGENCE_EVENT:
            a = span.args or {}
            self._raise(
                "nan_windows", span,
                f"loss diverged at iteration {a.get('iteration', '?')}, "
                f"detected at iteration {a.get('detected_at', '?')} "
                f"({a.get('lag_steps', '?')} steps late; sync window "
                f"{a.get('sync_window', '?')})")
        elif name == NUMERICS_EVENT:
            a = span.args or {}
            counter = _NUMERICS_COUNTERS.get(a.get("kind"))
            if counter is not None:
                self._raise(counter, span,
                            a.get("message")
                            or f"numerics anomaly {a.get('kind')!r} at "
                               f"iteration {a.get('iteration', '?')}")

    def _observe_step(self, name: str, span: Span):
        dur = span.duration
        with self._lock:
            win = self._durations[name]
            n = len(win)
            self._since_refresh[name] += 1
            if n >= self._min_samples and (
                    self._p99[name] is None
                    or self._since_refresh[name] >= self._refresh):
                xs = sorted(win)
                self._p99[name] = xs[min(n - 1,
                                         int(round(0.99 * (n - 1))))]
                self._since_refresh[name] = 0
            p99 = self._p99[name] if n >= self._min_samples else None
            win.append(dur)
        if p99 is not None and p99 > 0 and dur > self._spike_factor * p99:
            self._raise("step_time_spikes", span,
                        f"{name} spike: {1e3 * dur:.1f}ms vs rolling "
                        f"p99 {1e3 * p99:.1f}ms "
                        f"(x{dur / p99:.1f}, corr={span.corr})")

    def _observe_stall(self, span: Span):
        fire = None
        with self._lock:
            self._stall_s += span.duration
            self._stall_n += 1
            if self._stall_n >= self._stall_window:
                total = self._stall_s + self._busy_s
                ratio = self._stall_s / total if total > 0 else 0.0
                if ratio > self._stall_ratio:
                    fire = ratio
                self._stall_s = self._busy_s = 0.0
                self._stall_n = 0
        if fire is not None:
            self._raise("prefetch_starvation_windows", span,
                        f"prefetch starvation: data_stall is "
                        f"{100 * fire:.0f}% of the last "
                        f"{self._stall_window}-step window — the input "
                        f"pipeline cannot keep up (raise "
                        f"BIGDL_TPU_PREFETCH_DEPTH or speed up host "
                        f"transforms)")

    def _raise(self, counter: str, span: Span, message: str):
        with self._lock:
            self.counters[counter] += 1
            if len(self.anomalies) < self._max_anomalies:
                self.anomalies.append({
                    "kind": counter, "message": message,
                    "thread": span.thread, "corr": span.corr,
                    "t": span.t1, "unix_time": round(time.time(), 3),
                })
        if self._log is not None:
            try:
                self._log("watchdog: %s", message)
            except Exception:
                pass

    # -- reading / export ---------------------------------------------
    def total(self) -> int:
        return sum(self.counters.values())

    def report(self) -> Dict:
        """JSON-able snapshot (counters + recent anomalies) for the
        canonical metrics dump."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "anomalies": list(self.anomalies)}

    def write_summary(self, summary, step: int) -> Dict[str, int]:
        """Export the counters through a ``bigdl_tpu_torch.visualization``
        summary writer; returns what was written."""
        snap = dict(self.counters)
        for key, tag in self.SUMMARY_TAGS.items():
            summary.add_scalar(tag, float(snap[key]), step)
        return snap

    def log_line(self) -> str:
        parts = [f"{k}={v}" for k, v in sorted(self.counters.items())
                 if v]
        return "watchdog: " + (" ".join(parts) if parts else "clean")
