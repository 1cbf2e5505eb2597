"""Per-process live debug endpoints (counterpart of
bigdl_tpu/telemetry/debug_server.py).

The pull half of the telemetry plane: one stdlib ``http.server`` thread
per process that an operator (or ``python -m
bigdl_tpu_torch.tools.cluster_top --live``) asks what it is doing now:

* ``/statusz``: uptime, role, the attached engines, every
  ``BIGDL_TPU_*`` knob set (JSON);
* ``/metricsz``: Prometheus text (0.0.4) of the registered metrics
  sources (the loop's ``Metrics`` phases and values, a serving engine's
  latency histogram and ``snapshot()``), the watchdog's counters, the HBM
  ledger's gauges and the numerics norms, under the JAX package's metric
  names;
* ``/tracez?secs=N``: the spans that end within the next N seconds (0:
  the whole ring) and the engines' tail exemplars, as a Chrome trace;
* ``/xrayz``: the program registry and its recompile forensics;
* ``/flightz``: a flight-recorder dump (telemetry/flightrecorder.py),
  answered with the bundle's path.

Every endpoint reads host-side state only: none touches a CUDA graph,
waits on the device or samples its memory (the HBM gauges are the
ledger's last sample), so a live server leaves the captures and their
replays as they were.  ``BIGDL_TPU_DEBUG_PORT`` turns it on (0: an
ephemeral port); the bound address is logged and stamped into the
cluster shipper's segment headers.
"""
from __future__ import annotations

import atexit
import json
import logging
import math
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from bigdl_tpu_torch.telemetry.export import chrome_trace
from bigdl_tpu_torch.telemetry.programs import (
    get_hbm_ledger,
    get_program_registry,
)
from bigdl_tpu_torch.telemetry.tracer import get_tracer

logger = logging.getLogger("bigdl_tpu_torch.telemetry.debug")

#: Content type mandated by the Prometheus text exposition format.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Longest /tracez capture window we will hold a handler thread for.
TRACEZ_MAX_SECS = 60.0


def debug_port(default: Optional[int] = None) -> Optional[int]:
    """Resolved ``BIGDL_TPU_DEBUG_PORT`` — ``None`` when unset/empty
    (debug server off), an int port otherwise (0 = ephemeral)."""
    raw = os.environ.get("BIGDL_TPU_DEBUG_PORT", "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring malformed BIGDL_TPU_DEBUG_PORT=%r", raw)
        return default


def resolved_knobs() -> Dict[str, str]:
    """Every ``BIGDL_TPU_*`` env knob currently set, for /statusz and
    the flight-recorder manifest."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("BIGDL_TPU_")}


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _escape_label(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Family:
    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help: str):
        self.name, self.kind, self.help = name, kind, help
        # (labels, value, name-suffix) — the suffix carries histogram
        # sample names (_bucket/_sum/_count) under the base-name TYPE
        self.samples: List[Tuple[Dict[str, Any], float, str]] = []

    def add(self, labels: Dict[str, Any], value: float,
            suffix: str = ""):
        self.samples.append((labels, value, suffix))

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for labels, value, suffix in self.samples:
            name = self.name + suffix
            if labels:
                body = ",".join(f'{k}="{_escape_label(v)}"'
                                for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{body}}} {_fmt_value(value)}")
            else:
                lines.append(f"{name} {_fmt_value(value)}")
        return "\n".join(lines)


def _resolve_metrics(source: Any):
    """Shipper-contract source resolution: a source may be a zero-arg
    callable returning the real thing, a ``Metrics``, anything with
    ``.base`` (ServingMetrics), anything with ``.snapshot()``, a plain
    dict of scalars, or None.  Returns (base Metrics or None, snapshot
    dict or None, the resolved source itself)."""
    try:
        if callable(source):
            source = source()
    except Exception:
        return None, None, None
    if source is None:
        return None, None, None
    snapshot = None
    snap = getattr(source, "snapshot", None)
    if callable(snap):
        try:
            snapshot = snap()
        except Exception:
            snapshot = None
    base = getattr(source, "base", source)
    if not hasattr(base, "_sums"):
        base = None
    if base is None and snapshot is None and isinstance(source, dict):
        snapshot = source
    return base, snapshot, source


def prometheus_text(metrics_sources: Dict[str, Any],
                    watchdog: Any = None,
                    numerics: Any = None,
                    start_time: Optional[float] = None) -> str:
    """The process's host-side telemetry as Prometheus text (format
    0.0.4), the JAX package's metric names letter for letter; reading
    them never touches the device or a CUDA graph."""
    fams: Dict[str, _Family] = {}

    def fam(name: str, kind: str, help: str) -> _Family:
        f = fams.get(name)
        if f is None:
            f = fams[name] = _Family(name, kind, help)
        return f

    now = time.time()
    if start_time is not None:
        fam("bigdl_tpu_process_start_time_seconds", "gauge",
            "unix time the debug server came up").add({}, start_time)
        fam("bigdl_tpu_uptime_seconds", "gauge",
            "seconds since the debug server came up").add(
                {}, max(0.0, now - start_time))

    tr = get_tracer()
    fam("bigdl_tpu_tracer_enabled", "gauge",
        "1 when span tracing is on").add({}, 1.0 if tr.enabled else 0.0)
    try:
        fam("bigdl_tpu_tracer_spans", "gauge",
            "spans currently held in the ring buffer").add(
                {}, float(len(tr.spans())))
    except Exception:
        pass

    for src_name, source in sorted(metrics_sources.items()):
        base, snapshot, resolved = _resolve_metrics(source)
        hist_fn = getattr(resolved, "latency_histogram", None)
        if callable(hist_fn):
            try:
                hist = hist_fn()
            except Exception:
                hist = None
            if hist and hist.get("count", 0) >= 0:
                f = fam("bigdl_tpu_request_latency_seconds", "histogram",
                        "end-to-end request latency (cumulative "
                        "Prometheus histogram; aggregable across "
                        "hosts, unlike the percentile gauges)")
                for le, n in hist["buckets"]:
                    f.add({"source": src_name,
                           "le": _fmt_value(le)}, float(n),
                          suffix="_bucket")
                f.add({"source": src_name}, float(hist["sum"]),
                      suffix="_sum")
                f.add({"source": src_name}, float(hist["count"]),
                      suffix="_count")
        if base is not None:
            # the port's Metrics keeps no gauges, event counters or
            # percentile windows: those families stay empty for it
            with base._lock:
                sums = dict(base._sums)
                counts = dict(base._counts)
                gauges = dict(getattr(base, "_gauges", {}))
                lasts = dict(base._last)
                counters = dict(getattr(base, "_counters", {}))
                values = dict(base._values)
                tracked = list(getattr(base, "_samples", ()))
            for phase, total in sorted(sums.items()):
                lbl = {"source": src_name, "phase": phase}
                fam("bigdl_tpu_phase_seconds_total", "counter",
                    "accumulated seconds per instrumented phase").add(
                        lbl, total)
                fam("bigdl_tpu_phase_count_total", "counter",
                    "samples accumulated per instrumented phase").add(
                        lbl, float(counts.get(phase, 0)))
                fam("bigdl_tpu_phase_last_seconds", "gauge",
                    "most recent sample per instrumented phase").add(
                        lbl, lasts.get(phase, 0.0))
            for phase, v in sorted(gauges.items()):
                fam("bigdl_tpu_phase_gauge_seconds", "gauge",
                    "out-of-band phase seconds (computed elsewhere)").add(
                        {"source": src_name, "phase": phase}, v)
            for event, n in sorted(counters.items()):
                fam("bigdl_tpu_events_total", "counter",
                    "plain event counters (completed/rejected/...)").add(
                        {"source": src_name, "event": event}, float(n))
            for vname, v in sorted(values.items()):
                fam("bigdl_tpu_value", "gauge",
                    "unitless scalars (mfu, throughput, grad_norm...)").add(
                        {"source": src_name, "name": vname}, v)
            for phase in sorted(tracked):
                for q in (50.0, 95.0, 99.0):
                    fam("bigdl_tpu_phase_quantile_seconds", "gauge",
                        "nearest-rank percentile over the tracked "
                        "sample window").add(
                            {"source": src_name, "phase": phase,
                             "quantile": f"{q / 100.0:g}"},
                            base.percentile(phase, q))
        if snapshot:
            for key, v in sorted(snapshot.items()):
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                fam("bigdl_tpu_snapshot", "gauge",
                    "engine snapshot() scalars").add(
                        {"source": src_name, "key": key}, float(v))

    if watchdog is not None:
        try:
            rep = watchdog.report()
        except Exception:
            rep = None
        if rep:
            for kind, n in sorted(rep.get("counters", {}).items()):
                fam("bigdl_tpu_watchdog_anomalies_total", "counter",
                    "watchdog anomalies raised, by kind").add(
                        {"kind": kind}, float(n))

    try:
        hbm = get_hbm_ledger().report()
    except Exception:
        hbm = None
    if hbm:
        fam("bigdl_tpu_hbm_warnings_total", "counter",
            "HBM headroom warnings raised").add(
                {}, float(hbm.get("warnings", 0)))
        fam("bigdl_tpu_hbm_bytes", "gauge",
            "HBM ledger byte gauges").add(
                {"kind": "peak"}, float(hbm.get("peak_bytes", 0)))
        last = hbm.get("last") or {}
        if last:
            fam("bigdl_tpu_hbm_bytes", "gauge",
                "HBM ledger byte gauges").add(
                    {"kind": "in_use"}, float(last.get("bytes_in_use", 0)))
            if last.get("bytes_limit"):
                fam("bigdl_tpu_hbm_bytes", "gauge",
                    "HBM ledger byte gauges").add(
                        {"kind": "limit"}, float(last["bytes_limit"]))
            if last.get("frac_free") is not None:
                fam("bigdl_tpu_hbm_frac_free", "gauge",
                    "fraction of HBM free at last ledger sample").add(
                        {}, float(last["frac_free"]))

    try:
        fam("bigdl_tpu_programs", "gauge",
            "compiled programs in the X-ray registry").add(
                {}, float(len(get_program_registry())))
    except Exception:
        pass

    if numerics is not None:
        try:
            last = dict(getattr(numerics, "last", None) or {})
        except Exception:
            last = {}
        for stat, v in sorted(last.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            fam("bigdl_tpu_numerics", "gauge",
                "latest drained in-graph numerics stats "
                "(grad/update norms)").add({"stat": stat}, float(v))

    return "\n".join(f.render() for f in fams.values()) + "\n"


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    server_version = "bigdl-tpu-debug"
    protocol_version = "HTTP/1.1"

    # stdlib default logs every request to stderr; route to our logger
    def log_message(self, fmt, *args):  # pragma: no cover - cosmetic
        logger.debug("debug server: " + fmt, *args)

    def _send(self, code: int, body: str, content_type: str):
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, obj: Any, code: int = 200):
        self._send(code, json.dumps(obj, sort_keys=True, default=str),
                   "application/json")

    def do_GET(self):  # noqa: N802 - stdlib casing
        srv: "DebugServer" = self.server.debug  # type: ignore[attr-defined]
        parts = urlsplit(self.path)
        query = parse_qs(parts.query)
        try:
            route = srv._routes.get(parts.path)
            if route is None:
                self._send_json(
                    {"error": f"no such endpoint: {parts.path}",
                     "endpoints": sorted(srv._routes)}, code=404)
                return
            route(self, query)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # never kill the handler thread
            try:
                self._send_json({"error": repr(e)}, code=500)
            except Exception:
                pass


class DebugServer:
    """One stdlib HTTP thread serving the live ops endpoints.

    Read-only over host-side state.  :meth:`start` binds and starts a
    daemon thread named ``bigdl-debug-server``; :meth:`close` is
    idempotent, joins the thread, and is registered with ``atexit`` so
    a server left open never outlives the process.
    """

    def __init__(self, port: Optional[int] = None,
                 bind_host: str = "0.0.0.0", *,
                 host: Optional[str] = None, role: str = ""):
        self.port = debug_port(0) if port is None else int(port)
        self.bind_host = bind_host
        self.host = host or socket.gethostname()
        self.role = role
        self.start_time = time.time()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._engines: Dict[str, Dict[str, Any]] = {}
        self._metrics_sources: Dict[str, Any] = {}
        self._exemplar_sources: Dict[str, Any] = {}
        self._status: Dict[str, Any] = {}
        self._watchdog: Any = None
        self._numerics: Any = None
        self._flight: Any = None
        self.closed = False
        self._routes: Dict[str, Callable] = {
            "/": self._h_index,
            "/statusz": self._h_statusz,
            "/metricsz": self._h_metricsz,
            "/tracez": self._h_tracez,
            "/xrayz": self._h_xrayz,
            "/flightz": self._h_flightz,
        }

    # -- registration ---------------------------------------------------
    def add_metrics(self, name: str, source: Any) -> "DebugServer":
        """Register a metrics source for /metricsz (same contract as
        ``TelemetryShipper.add_metrics``: a Metrics/ServingMetrics, a
        dict, or a zero-arg callable returning one)."""
        with self._lock:
            self._metrics_sources[name] = source
        return self

    def set_status(self, key: str, value: Any) -> "DebugServer":
        """Expose an extra field (value or zero-arg callable) on
        /statusz — e.g. the elastic generation."""
        with self._lock:
            self._status[key] = value
        return self

    def set_watchdog(self, wd: Any) -> "DebugServer":
        with self._lock:
            self._watchdog = wd
        return self

    def set_numerics(self, monitor: Any) -> "DebugServer":
        with self._lock:
            self._numerics = monitor
        return self

    def set_flight_recorder(self, fr: Any) -> "DebugServer":
        with self._lock:
            self._flight = fr
        return self

    def attach(self, name: str, *, role: str = "",
               metrics: Any = None, status: Any = None,
               exemplars: Any = None) -> Callable[[], None]:
        """Register a live engine (shows under /statusz ``engines``);
        returns a zero-arg detach callable for the engine's close().
        ``exemplars`` is a zero-arg callable returning the engine's
        :class:`~bigdl_tpu_torch.telemetry.requests.ExemplarReservoir` —
        its retained p99+ span trees are merged into /tracez."""
        with self._lock:
            self._engines[name] = {
                "name": name, "role": role or name,
                "since_unix": round(time.time(), 3), "status": status,
            }
            if metrics is not None:
                self._metrics_sources[name] = metrics
            if exemplars is not None:
                self._exemplar_sources[name] = exemplars
            if role and not self.role:
                self.role = role

        def detach():
            with self._lock:
                self._engines.pop(name, None)
                self._metrics_sources.pop(name, None)
                self._exemplar_sources.pop(name, None)
        return detach

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "DebugServer":
        with self._lock:
            if self._httpd is not None:
                return self
            self._httpd = ThreadingHTTPServer(
                (self.bind_host, self.port), _Handler)
            self._httpd.debug = self  # type: ignore[attr-defined]
            self._httpd.daemon_threads = True
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="bigdl-debug-server", daemon=True)
            self._thread.start()
            self.closed = False
        atexit.register(self.close)
        logger.info("debug server listening on %s (role=%s) — "
                    "/statusz /metricsz /tracez /xrayz /flightz",
                    self.address, self.role or "?")
        return self

    @property
    def address(self) -> str:
        """``host:port`` peers can reach (hostname, not the bind
        wildcard) — stamped into shipped segment headers."""
        return f"{self.host}:{self.port}"

    def local_url(self, path: str = "") -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def close(self):
        with self._lock:
            httpd, thread = self._httpd, self._thread
            self._httpd = self._thread = None
            self.closed = True
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        global _GLOBAL
        with _GLOBAL_LOCK:
            if _GLOBAL is self:
                _GLOBAL = None

    def __enter__(self) -> "DebugServer":
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- endpoint handlers ----------------------------------------------
    def _h_index(self, h: _Handler, query):
        h._send(200, "bigdl_tpu debug server — endpoints: "
                + " ".join(sorted(p for p in self._routes if p != "/"))
                + "\n", "text/plain; charset=utf-8")

    def _h_statusz(self, h: _Handler, query):
        with self._lock:
            engines = [dict(e) for e in self._engines.values()]
            status = dict(self._status)
        for e in engines:
            fn = e.pop("status", None)
            if callable(fn):
                try:
                    e["detail"] = fn()
                except Exception:
                    pass
            e["uptime_s"] = round(time.time() - e["since_unix"], 3)
        extra = {}
        for k, v in status.items():
            try:
                extra[k] = v() if callable(v) else v
            except Exception:
                extra[k] = None
        tr = get_tracer()
        obj = {
            "record": "statusz",
            "host": self.host,
            "pid": os.getpid(),
            "role": self.role,
            "debug_addr": self.address,
            "start_unix": round(self.start_time, 3),
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "engines": engines,
            "tracer": {"enabled": tr.enabled, "spans": len(tr.spans())},
            "knobs": resolved_knobs(),
        }
        obj.update(extra)
        h._send_json(obj)

    def _h_metricsz(self, h: _Handler, query):
        with self._lock:
            sources = dict(self._metrics_sources)
            wd, num = self._watchdog, self._numerics
        body = prometheus_text(sources, watchdog=wd, numerics=num,
                               start_time=self.start_time)
        h._send(200, body, PROMETHEUS_CONTENT_TYPE)

    def _h_tracez(self, h: _Handler, query):
        try:
            secs = float(query.get("secs", ["1"])[0])
        except ValueError:
            secs = 1.0
        secs = max(0.0, min(TRACEZ_MAX_SECS, secs))
        tr = get_tracer()
        t_start = time.perf_counter()
        if secs > 0:
            time.sleep(secs)  # handler thread only; nothing else blocks
            spans = [s for s in tr.spans() if s.t1 >= t_start]
        else:
            spans = tr.spans()  # secs=0: whole-ring snapshot
        if query.get("exemplars", ["1"])[0] != "0":
            # merge retained p99+ request trees (already evicted from
            # the live ring, typically) so the tail stays inspectable
            with self._lock:
                sources = list(self._exemplar_sources.values())
            seen = {id(s) for s in spans}
            for src in sources:
                try:
                    res = src() if callable(src) else src
                    extra = res.spans() if res is not None else []
                except Exception:
                    continue
                spans.extend(s for s in extra if id(s) not in seen)
        blob = chrome_trace(tr, spans=spans,
                            process_name=f"bigdl_tpu:{self.role or '?'}")
        h._send(200, json.dumps(blob), "application/json")

    def _h_xrayz(self, h: _Handler, query):
        reg = get_program_registry()
        h._send_json({
            "record": "xrayz",
            "host": self.host,
            "programs": reg.records(),
            "forensics": reg.forensic_records(),
            "hbm": get_hbm_ledger().report(),
        })

    def _h_flightz(self, h: _Handler, query):
        fr = self._flight
        if fr is None:
            from bigdl_tpu_torch.telemetry.flightrecorder import (
                get_flight_recorder,
            )
            fr = get_flight_recorder(create=False)
        if fr is None:
            h._send_json({"error": "flight recorder not armed"}, code=503)
            return
        note = query.get("note", [""])[0]
        path = fr.dump(trigger="flightz", note=note, force=True)
        if path is None:
            h._send_json({"error": "dump failed (see logs)"}, code=500)
        else:
            h._send_json({"record": "flightz", "bundle": path})


# ---------------------------------------------------------------------------
# process-wide singleton + engine attach points
# ---------------------------------------------------------------------------
_GLOBAL: Optional[DebugServer] = None
_GLOBAL_LOCK = threading.Lock()


def get_debug_server(create: bool = True) -> Optional[DebugServer]:
    """The process's debug server, created and started on first use
    when ``BIGDL_TPU_DEBUG_PORT`` is set; ``None`` when the knob is
    unset (the plane stays completely dark)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None and not _GLOBAL.closed:
            return _GLOBAL
        if not create:
            return None
        port = debug_port()
        if port is None:
            return None
        _GLOBAL = DebugServer(port=port).start()
        return _GLOBAL


def set_global(server: Optional[DebugServer]):
    """Install an explicitly constructed server as the process global
    (tests; entry points that manage their own lifecycle)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = server


def bound_address() -> Optional[str]:
    """``host:port`` of the live global server, or None — what the
    TelemetryShipper stamps into segment headers for peer discovery."""
    with _GLOBAL_LOCK:
        srv = _GLOBAL
    if srv is not None and not srv.closed:
        return srv.address
    return None


def attach_engine(name: str, *, role: str = "", metrics: Any = None,
                  status: Any = None, exemplars: Any = None
                  ) -> Callable[[], None]:
    """Engine-side hook: register with the global server when one is
    (or should be) running; a cheap no-op detach otherwise.  Engines
    call this at start() and call the returned detach at close()."""
    srv = get_debug_server()
    if srv is None:
        return lambda: None
    return srv.attach(name, role=role, metrics=metrics, status=status,
                      exemplars=exemplars)
