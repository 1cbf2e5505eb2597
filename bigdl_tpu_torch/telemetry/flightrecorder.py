"""Crash flight recorder (counterpart of
bigdl_tpu/telemetry/flightrecorder.py).

The black box: while armed (telemetry on, or ``BIGDL_TPU_FLIGHT=1``) it
dumps, on trouble, a ``blackbox-<host>-<ts>-<pid>-<seq>/`` bundle of
what a post-mortem needs, in the JAX package's files and fields:

* ``trace.json``: the tail of the span ring as a Chrome trace;
* ``metrics.jsonl``: the last records of each registered metrics
  source (sampled off the span stream) and a fresh one per source;
* ``xray.json``: the program registry, its recompile forensics and the
  HBM ledger's report and last samples (what the ledger holds: a dump
  never reads the device, so none waits on a capture);
* ``watchdog.json``: the watchdog's counters and anomalies, when set;
* ``numerics.json``: the latest drained numerics stats (the loop's
  ``add_blob``), and any other registered blob;
* ``threads.txt``: every live thread's Python stack;
* ``manifest.json``: what fired (trigger and note), when, where, and
  every ``BIGDL_TPU_*`` knob set.

Triggers: the watchdog's severe anomalies (:meth:`FlightRecorder.
on_anomaly`, chained into a ``Watchdog``'s ``on_anomaly``), the
``loss_divergence``, ``numerics_anomaly`` and ``hbm_headroom`` instants,
the loop's divergence retry, the debug server's ``/flightz``, and hard
death: ``atexit`` while armed, an unhandled exception on any thread, a
fatal signal (``faulthandler``, into a side log).  Dumps are rate
limited (``BIGDL_TPU_FLIGHT_MIN_INTERVAL_S``), bounded on disk
(``BIGDL_TPU_FLIGHT_KEEP``), go to ``BIGDL_TPU_FLIGHT_DIR`` (else the
cluster run directory, else the working directory), never raise and
never record a span.  ``python -m bigdl_tpu_torch.tools.blackbox``
renders a bundle.
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import logging
import os
import shutil
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from bigdl_tpu_torch.telemetry.export import chrome_trace, metrics_record
from bigdl_tpu_torch.telemetry.programs import (
    get_hbm_ledger,
    get_program_registry,
)
from bigdl_tpu_torch.telemetry.tracer import get_tracer

logger = logging.getLogger("bigdl_tpu_torch.telemetry.flight")

#: Tracer instants that auto-trigger a dump while armed.
TRIGGER_EVENTS = frozenset(
    {"loss_divergence", "numerics_anomaly", "hbm_headroom"})

#: Watchdog counters severe enough to auto-trigger via on_anomaly.
ANOMALY_TRIGGERS = frozenset(
    {"nan_windows", "nonfinite_grads", "peer_failures", "hbm_headroom"})

DEFAULT_MIN_INTERVAL_S = 30.0
DEFAULT_KEEP = 4
BUNDLE_PREFIX = "blackbox-"


def flight_enabled() -> bool:
    """``BIGDL_TPU_FLIGHT``: "0" forces off, "1" forces on; unset
    means armed exactly when span telemetry is on (always-on black
    box, zero presence otherwise)."""
    raw = os.environ.get("BIGDL_TPU_FLIGHT", "").strip().lower()
    if raw in ("0", "off", "false", "no"):
        return False
    if raw in ("1", "on", "true", "yes"):
        return True
    return get_tracer().enabled


def flight_min_interval_s(default: float = DEFAULT_MIN_INTERVAL_S) -> float:
    raw = os.environ.get("BIGDL_TPU_FLIGHT_MIN_INTERVAL_S", "").strip()
    try:
        return max(0.0, float(raw)) if raw else default
    except ValueError:
        return default


def flight_keep(default: int = DEFAULT_KEEP) -> int:
    raw = os.environ.get("BIGDL_TPU_FLIGHT_KEEP", "").strip()
    try:
        return max(1, int(raw)) if raw else default
    except ValueError:
        return default


def flight_dir() -> str:
    """Where bundles land: ``BIGDL_TPU_FLIGHT_DIR``, else the shared
    telemetry run dir, else the working directory."""
    d = os.environ.get("BIGDL_TPU_FLIGHT_DIR", "").strip()
    if d:
        return d
    from bigdl_tpu_torch.telemetry.cluster import telemetry_dir
    return telemetry_dir() or "."


class FlightRecorder:
    """The per-process black box.  Construct, register sources, then
    :meth:`arm`; every write path is wrapped, so a recorder never takes
    down the process it records."""

    def __init__(self, out_dir: Optional[str] = None,
                 host: Optional[str] = None, *,
                 min_interval_s: Optional[float] = None,
                 keep: Optional[int] = None,
                 trigger_events: frozenset = TRIGGER_EVENTS,
                 anomaly_kinds: frozenset = ANOMALY_TRIGGERS,
                 tail_spans: int = 2048, history: int = 32,
                 history_every_s: float = 2.0):
        self.out_dir = out_dir or flight_dir()
        self.host = host or socket.gethostname()
        self.min_interval_s = (flight_min_interval_s()
                               if min_interval_s is None
                               else max(0.0, float(min_interval_s)))
        self.keep = flight_keep() if keep is None else max(1, int(keep))
        self.trigger_events = frozenset(trigger_events)
        self.anomaly_kinds = frozenset(anomaly_kinds)
        self.tail_spans = int(tail_spans)
        self.history_every_s = float(history_every_s)
        self._history: deque = deque(maxlen=max(1, int(history)))
        self._metrics_sources: Dict[str, Any] = {}
        self._blobs: Dict[str, Callable[[], Any]] = {}
        self._watchdog: Any = None
        self._lock = threading.Lock()
        self._last_dump = float("-inf")
        self._last_hist = 0.0
        self._start_unix = time.time()
        self.dumps = 0
        self.last_bundle: Optional[str] = None
        self.last_trigger: Optional[str] = None
        self._armed = False
        self._tracer = get_tracer()
        self._prev_excepthook = None
        self._prev_thread_hook = None
        self._installed_excepthook = None
        self._installed_thread_hook = None
        self._fault_fh = None

    # -- registration ---------------------------------------------------
    def add_metrics(self, name: str, source: Any) -> "FlightRecorder":
        """Register a metrics source (a ``Metrics``, anything with
        ``snapshot()`` such as ``ServingMetrics``, a dict, or a zero-arg
        callable returning one) for the bundle's ``metrics.jsonl``: the
        TelemetryShipper's contract."""
        with self._lock:
            self._metrics_sources[name] = source
        return self

    def add_blob(self, name: str, fn: Callable[[], Any]
                 ) -> "FlightRecorder":
        """Register an extra JSON blob: ``<name>.json`` = ``fn()`` at
        dump time (e.g. the numerics monitor tail)."""
        with self._lock:
            self._blobs[name] = fn
        return self

    def set_watchdog(self, wd: Any) -> "FlightRecorder":
        with self._lock:
            self._watchdog = wd
        return self

    # -- triggers -------------------------------------------------------
    def on_anomaly(self, counter: str, message: str = ""):
        """Watchdog ``on_anomaly`` hook (chain it — never replace an
        existing hook): severe kinds trigger a rate-limited dump."""
        if counter in self.anomaly_kinds:
            self.dump(trigger=f"watchdog:{counter}", note=message)

    def _observe(self, span) -> None:
        # called by the tracer for EVERY recorded span — keep it tiny
        if span.name in self.trigger_events:
            self.dump(trigger=span.name,
                      note=json.dumps(span.args or {}, default=str)[:400])
            return
        now = time.monotonic()
        if now - self._last_hist >= self.history_every_s:
            self._last_hist = now
            self._snapshot_metrics()

    def _excepthook(self, exc_type, exc, tb):
        self.dump(trigger="unhandled_exception",
                  note=f"{exc_type.__name__}: {exc}"[:400], force=True)
        if self._prev_excepthook is not None:
            self._prev_excepthook(exc_type, exc, tb)

    def _thread_excepthook(self, hook_args):
        name = getattr(hook_args.thread, "name", "?")
        self.dump(trigger="unhandled_exception",
                  note=f"thread {name}: "
                       f"{hook_args.exc_type.__name__}: "
                       f"{hook_args.exc_value}"[:400])
        if self._prev_thread_hook is not None:
            self._prev_thread_hook(hook_args)

    def _atexit(self):
        # hard-death catch-all: the process is exiting while the box is
        # still armed.  Not forced — a just-written trouble bundle
        # within the rate window makes this one redundant.  Disarm
        # afterwards so a second pass (manual + interpreter atexit)
        # cannot dump twice.
        if self._armed:
            self.dump(trigger="atexit")
            self.close()

    def arm(self) -> "FlightRecorder":
        """Subscribe to the span stream and install the hard-death
        hooks (atexit, sys/threading excepthooks, faulthandler into a
        sidecar log for fatal signals).  Idempotent."""
        with self._lock:
            if self._armed:
                return self
            self._armed = True
        self._tracer.subscribe(self._observe)
        atexit.register(self._atexit)
        self._prev_excepthook = sys.excepthook
        self._installed_excepthook = self._excepthook
        sys.excepthook = self._installed_excepthook
        if hasattr(threading, "excepthook"):
            self._prev_thread_hook = threading.excepthook
            self._installed_thread_hook = self._thread_excepthook
            threading.excepthook = self._installed_thread_hook
        try:
            if not faulthandler.is_enabled():
                os.makedirs(self.out_dir, exist_ok=True)
                self._fault_fh = open(os.path.join(
                    self.out_dir,
                    f"faulthandler-{self.host}-{os.getpid()}.log"), "a")
                faulthandler.enable(file=self._fault_fh)
        except Exception:
            self._fault_fh = None
        logger.info("flight recorder armed -> %s (min interval %.1fs, "
                    "keep %d)", self.out_dir, self.min_interval_s,
                    self.keep)
        return self

    def close(self):
        """Disarm: drop the span subscription and restore every hook we
        installed (only if still ours).  Idempotent."""
        with self._lock:
            if not self._armed:
                return
            self._armed = False
        self._tracer.unsubscribe(self._observe)
        try:
            atexit.unregister(self._atexit)
        except Exception:
            pass
        if sys.excepthook is self._installed_excepthook:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if hasattr(threading, "excepthook") \
                and threading.excepthook is self._installed_thread_hook:
            threading.excepthook = self._prev_thread_hook \
                or threading.__excepthook__
        if self._fault_fh is not None:
            try:
                faulthandler.disable()
                self._fault_fh.close()
                if os.path.getsize(self._fault_fh.name) == 0:
                    os.unlink(self._fault_fh.name)
            except Exception:
                pass
            self._fault_fh = None

    @property
    def armed(self) -> bool:
        return self._armed

    def __enter__(self) -> "FlightRecorder":
        return self.arm()

    def __exit__(self, *exc):
        self.close()

    # -- the dump itself ------------------------------------------------
    def dump(self, trigger: str, note: str = "",
             force: bool = False) -> Optional[str]:
        """Write one bundle; returns its directory path, or None when
        rate-limited or on failure.  Called from death paths — never
        raises, never emits spans."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_dump < self.min_interval_s:
                return None
            self._last_dump = now
        try:
            return self._dump(trigger, note)
        except Exception:
            logger.exception("flight recorder: dump failed (trigger=%s)",
                             trigger)
            return None

    def _dump(self, trigger: str, note: str) -> str:
        ts = time.strftime("%Y%m%d-%H%M%S")
        with self._lock:
            seq = self.dumps
        name = (f"{BUNDLE_PREFIX}{self.host}-{ts}-"
                f"{os.getpid()}-{seq:03d}")
        final = os.path.join(self.out_dir, name)
        part = final + ".part"
        os.makedirs(part, exist_ok=True)
        files: List[str] = []

        def write_json(fname: str, obj: Any):
            with open(os.path.join(part, fname), "w") as f:
                json.dump(obj, f, sort_keys=True, default=str)
            files.append(fname)

        # span-ring tail as a Perfetto trace
        spans = self._tracer.spans()[-self.tail_spans:]
        write_json("trace.json", chrome_trace(self._tracer, spans=spans))

        # last-K metrics history + a fresh record per source
        with self._lock:
            history = list(self._history)
            sources = dict(self._metrics_sources)
            blobs = dict(self._blobs)
            wd = self._watchdog
        records = history + self._fresh_records(sources)
        with open(os.path.join(part, "metrics.jsonl"), "w") as f:
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True, default=str)
                        + "\n")
        files.append("metrics.jsonl")

        reg = get_program_registry()
        ledger = get_hbm_ledger()
        write_json("xray.json", {
            "programs": reg.records(),
            "forensics": reg.forensic_records(),
            "hbm": ledger.report(),
            "hbm_samples": ledger.samples()[-32:],
        })
        if wd is not None:
            try:
                write_json("watchdog.json", wd.report())
            except Exception:
                pass
        for bname, fn in sorted(blobs.items()):
            try:
                write_json(f"{bname}.json", fn())
            except Exception:
                pass

        with open(os.path.join(part, "threads.txt"), "w") as f:
            f.write(self._thread_dump())
        files.append("threads.txt")

        from bigdl_tpu_torch.telemetry.debug_server import resolved_knobs
        write_json("manifest.json", {
            "record": "blackbox_manifest",
            "trigger": trigger,
            "note": note,
            "host": self.host,
            "pid": os.getpid(),
            "unix_time": round(time.time(), 3),
            "uptime_s": round(time.time() - self._start_unix, 3),
            "n_spans": len(spans),
            "n_metrics_records": len(records),
            "knobs": resolved_knobs(),
            "files": sorted(files),
        })

        if os.path.isdir(final):  # same second + seq reuse after close
            shutil.rmtree(final, ignore_errors=True)
        os.replace(part, final)
        with self._lock:
            self.dumps += 1
            self.last_bundle = final
            self.last_trigger = trigger
        self._prune()
        logger.warning("flight recorder: %s -> %s", trigger, final)
        return final

    def _fresh_records(self, sources: Dict[str, Any]) -> List[dict]:
        out = []
        for sname, source in sorted(sources.items()):
            rec = self._record_one(sname, source)
            if rec is not None:
                out.append(rec)
        return out

    @staticmethod
    def _record_one(sname: str, source: Any) -> Optional[dict]:
        try:
            if callable(source):
                source = source()
            if source is None:
                return None
            base = getattr(source, "base", source)
            snap = getattr(source, "snapshot", None)
            if hasattr(base, "_sums"):
                rec = metrics_record(sname, base)
            elif isinstance(source, dict):
                rec = {"record": sname,
                       "unix_time": round(time.time(), 3), **source}
            elif callable(snap):
                # the port's ServingMetrics: no phase timers, a snapshot
                rec = {"record": sname, "unix_time": round(time.time(), 3)}
            else:
                return None
            if callable(snap):
                rec["snapshot"] = snap()
            return rec
        except Exception:
            return None

    def _snapshot_metrics(self):
        with self._lock:
            sources = dict(self._metrics_sources)
        for rec in self._fresh_records(sources):
            self._history.append(rec)

    @staticmethod
    def _thread_dump() -> str:
        names = {t.ident: t.name for t in threading.enumerate()}
        chunks = []
        for tid, frame in sorted(sys._current_frames().items()):
            chunks.append(f"Thread {names.get(tid, '?')} (ident {tid}):")
            chunks.extend(ln.rstrip("\n")
                          for ln in traceback.format_stack(frame))
            chunks.append("")
        return "\n".join(chunks)

    # -- housekeeping ---------------------------------------------------
    def bundles(self) -> List[str]:
        """This host's bundles in ``out_dir``, oldest first."""
        try:
            entries = sorted(
                e for e in os.listdir(self.out_dir)
                if e.startswith(f"{BUNDLE_PREFIX}{self.host}-")
                and not e.endswith(".part")
                and os.path.isdir(os.path.join(self.out_dir, e)))
        except OSError:
            return []
        return [os.path.join(self.out_dir, e) for e in entries]

    def _prune(self):
        keep = self.keep
        for stale in self.bundles()[:-keep] if keep else []:
            shutil.rmtree(stale, ignore_errors=True)


# ---------------------------------------------------------------------------
# process-wide singleton
# ---------------------------------------------------------------------------
_GLOBAL: Optional[FlightRecorder] = None
_GLOBAL_LOCK = threading.Lock()


def get_flight_recorder(create: bool = True,
                        out_dir: Optional[str] = None
                        ) -> Optional[FlightRecorder]:
    """The process's armed black box, created on first use when
    :func:`flight_enabled` resolves true; ``None`` otherwise.  Entry
    points call this at start-up and register their metrics sources on
    the result."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None and _GLOBAL.armed:
            return _GLOBAL
        if not create or not flight_enabled():
            return None
        _GLOBAL = FlightRecorder(out_dir=out_dir).arm()
        return _GLOBAL


def set_global(fr: Optional[FlightRecorder]):
    """Install (or clear, with None) the process-global recorder —
    tests and entry points that manage their own lifecycle."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        old, _GLOBAL = _GLOBAL, fr
    if old is not None and old is not fr:
        old.close()
