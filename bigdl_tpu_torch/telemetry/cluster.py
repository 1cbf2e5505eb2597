"""Cluster telemetry: shipping, merge and a federated watchdog
(counterpart of bigdl_tpu/telemetry/cluster.py).

* :class:`TelemetryShipper`: each process flushes its spans, metrics
  snapshots, cost table, program table and lifecycle events, every
  ``BIGDL_TPU_SHIP_EVERY_S``, as one newline-JSON segment written to a
  temporary file and renamed into the shared run directory
  (``BIGDL_TPU_TELEMETRY_DIR``), its header tagged with the host, the
  generation, a clock offset (from the injectable ``clock_offset_fn``;
  ``BIGDL_TPU_CLOCK_SYNC=0`` turns it off) and the debug server's
  address.  It subscribes to the tracer and writes on its own thread,
  never inside a step.
* :class:`ClusterAggregator`: merges a run directory's segments into one
  Chrome trace (a process lane per host, clocks corrected, HBM and
  grad-norm counter lanes, lifecycle events as instants), cross-host
  request trees, and a summary: step percentiles, world throughput,
  straggler skew and the grad-norm skew.
* :class:`FederatedWatchdog`: flags stalled, straggling and saturated
  hosts through :meth:`Watchdog.peer_event`, once per transition.

The segments are the JAX package's JSONL, so either package's
aggregator merges the other's.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from bigdl_tpu_torch.telemetry import export as _export
from bigdl_tpu_torch.telemetry.costmodel import CostTable, get_cost_table
from bigdl_tpu_torch.telemetry.programs import (
    get_program_registry,
    xray_enabled,
)
from bigdl_tpu_torch.telemetry.tracer import Span, Tracer, get_tracer
from bigdl_tpu_torch.telemetry.watchdog import STEP_SPANS, Watchdog, logger

SEGMENT_GLOB = "seg-*.jsonl"

# lifecycle event names (the JAX package's elastic layer ships them; the
# aggregator renders them as instants on the host's lane)
EVENT_PEER_DEAD = "peer_dead"
EVENT_PEER_JOIN = "peer_join"
EVENT_DRAIN = "drain"
EVENT_GEN_BUMP = "gen_bump"
EVENT_RESTORE = "resharding_restore"
EVENT_REJOIN = "rejoin"
EVENT_WORKER_START = "worker_start"


def telemetry_dir(default: Optional[str] = None) -> Optional[str]:
    """The shared run directory (``BIGDL_TPU_TELEMETRY_DIR``)."""
    return os.environ.get("BIGDL_TPU_TELEMETRY_DIR") or default


def ship_every_s(default: float = 2.0) -> float:
    try:
        return float(os.environ.get("BIGDL_TPU_SHIP_EVERY_S", default))
    except ValueError:
        return default


def clock_sync_enabled() -> bool:
    return os.environ.get("BIGDL_TPU_CLOCK_SYNC", "1") != "0"


def _atomic_write_text(path: str, text: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.part"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)  # atomic: readers never see a torn segment
    return path


def _jsonable(obj: Any) -> Any:
    """Best-effort JSON round-trip (span args may hold numpy scalars)."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        try:
            return json.loads(json.dumps(obj, default=str))
        except (TypeError, ValueError):
            return str(obj)


_USE_GLOBAL = object()  # sentinel: default tracer vs. "no tracer"


class TelemetryShipper:
    """Per-process background shipper of telemetry segments.

    Subscribes to the tracer (a bounded deque append per span — the
    same O(1) contract as the Watchdog feed) and flushes everything
    pending every ``interval_s`` as one atomically-renamed
    ``seg-<host>-<pid>-<seq>.jsonl``.  Pass ``tracer=None`` for an
    events/metrics-only shipper (a process that shares its tracer with
    another shipper).
    """

    def __init__(self, run_dir: str, host: str, *, gen: int = 0,
                 tracer=_USE_GLOBAL, interval_s: Optional[float] = None,
                 clock_offset_fn: Optional[Callable[[], float]] = None,
                 cost_table: Optional[CostTable] = None,
                 capacity: int = 65536):
        self._dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._host = str(host)
        self._gen = int(gen)
        self._tracer: Optional[Tracer] = \
            get_tracer() if tracer is _USE_GLOBAL else tracer
        self._interval = ship_every_s() if interval_s is None \
            else float(interval_s)
        self._pending: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._events: collections.deque = collections.deque(maxlen=4096)
        self._metrics: List = []  # (name, source) pairs
        self._offsets: collections.deque = collections.deque(maxlen=64)
        self._offset_fn = clock_offset_fn if clock_sync_enabled() \
            else None
        self._cost_table = cost_table
        # maps the tracer's perf_counter timestamps onto this host's
        # wall clock; the header's clock_offset_s then maps wall clocks
        # onto the shared (filesystem) clock across hosts
        self._perf_skew = time.time() - time.perf_counter()
        self._seq = 0
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self._tracer is not None:
            self._tracer.subscribe(self._pending.append)

    # -- feeding -------------------------------------------------------
    def add_metrics(self, name: str, source) -> "TelemetryShipper":
        """Register a metrics source shipped with every segment:
        a ``Metrics``, anything with ``snapshot()``, a dict, or a
        zero-arg callable returning one of those (or None to skip) —
        callables let the source appear after the shipper starts."""
        self._metrics.append((str(name), source))
        return self

    def event(self, kind: str, **args) -> None:
        """Record an elastic lifecycle event (shipped next flush)."""
        self._events.append({
            "record": "event", "kind": str(kind), "host": self._host,
            "gen": self._gen, "t": time.time(),
            "args": _jsonable(args) if args else {},
        })

    def set_generation(self, gen: int) -> None:
        self._gen = int(gen)

    # -- clock alignment -----------------------------------------------
    def clock_offset(self) -> float:
        """Median of the sampled host-clock-minus-shared-clock offsets
        (0.0 until a sample lands or when sampling is disabled)."""
        if not self._offsets:
            return 0.0
        xs = sorted(self._offsets)
        return xs[len(xs) // 2]

    def _sample_offset(self) -> None:
        if self._offset_fn is None:
            return
        try:
            self._offsets.append(float(self._offset_fn()))
        except Exception:
            pass  # clock sync is advisory; never fail a flush over it

    # -- shipping ------------------------------------------------------
    def _span_record(self, s: Span) -> Dict[str, Any]:
        return {
            "record": "span", "name": s.name, "cat": s.cat,
            "t0": s.t0 + self._perf_skew, "t1": s.t1 + self._perf_skew,
            "tid": s.tid, "thread": s.thread, "corr": s.corr,
            "args": _jsonable(s.args) if s.args else None,
            "gen": self._gen,
        }

    def _metrics_record(self, name: str, source) -> Optional[Dict]:
        try:
            obj = source() if callable(source) else source
            if obj is None:
                return None
            if hasattr(obj, "snapshot"):
                snap = obj.snapshot()
            elif hasattr(obj, "_sums"):  # optim.metrics.Metrics
                rec = _export.metrics_record(name, obj)
                snap = {k: v for k, v in rec.items()
                        if k not in ("record", "unix_time")}
            elif isinstance(obj, dict):
                snap = obj
            else:
                return None
        except Exception:
            return None  # a broken source must never stop shipping
        return {"record": "metrics", "name": name, "host": self._host,
                "gen": self._gen, "t": time.time(),
                "snapshot": _jsonable(snap)}

    def ship_now(self) -> str:
        """Flush everything pending as one atomic segment; returns the
        segment path.  A payload-free segment is still written — its
        header doubles as the host's liveness beacon for the
        FederatedWatchdog."""
        with self._flush_lock:
            self._sample_offset()
            spans: List[Span] = []
            while True:
                try:
                    spans.append(self._pending.popleft())
                except IndexError:
                    break
            events: List[Dict] = []
            while True:
                try:
                    events.append(self._events.popleft())
                except IndexError:
                    break
            lines = []
            header = {
                "record": "segment_header", "host": self._host,
                "gen": self._gen, "pid": os.getpid(), "seq": self._seq,
                "t": time.time(), "clock_offset_s": self.clock_offset(),
                "n_spans": len(spans), "n_events": len(events),
            }
            # every segment header carries this host's debug endpoint
            # (when one is up), so cluster_top --live can poll it
            from bigdl_tpu_torch.telemetry import debug_server as _dbg
            addr = _dbg.bound_address()
            if addr is not None:
                header["debug_addr"] = addr
            lines.append(json.dumps(header, sort_keys=True))
            for s in spans:
                lines.append(json.dumps(self._span_record(s),
                                        sort_keys=True, default=str))
            for e in events:
                lines.append(json.dumps(e, sort_keys=True, default=str))
            for name, source in self._metrics:
                rec = self._metrics_record(name, source)
                if rec is not None:
                    lines.append(json.dumps(rec, sort_keys=True,
                                            default=str))
            table = self._cost_table if self._cost_table is not None \
                else get_cost_table()
            programs = table.records()
            if programs:
                lines.append(json.dumps(
                    {"record": "cost", "host": self._host,
                     "programs": programs},
                    sort_keys=True, default=str))
                try:
                    # the host's cost table on its own
                    table.persist(os.path.join(
                        self._dir, f"cost-{self._host}.json"))
                except OSError:
                    pass
            if xray_enabled():
                registry = get_program_registry()
                xray = registry.records()
                if xray:
                    lines.append(json.dumps(
                        {"record": "xray", "host": self._host,
                         "programs": xray,
                         "forensics": registry.forensic_records()[-32:]},
                        sort_keys=True, default=str))
                    try:
                        # the host's program table on its own
                        registry.persist(os.path.join(
                            self._dir, f"xray-{self._host}.json"))
                    except OSError:
                        pass
            path = os.path.join(
                self._dir,
                f"seg-{self._host}-{os.getpid()}-{self._seq:06d}.jsonl")
            _atomic_write_text(path, "\n".join(lines) + "\n")
            self._seq += 1
            return path

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "TelemetryShipper":
        if self._thread is not None or self._interval <= 0:
            return self
        def loop():
            while not self._stop.wait(self._interval):
                try:
                    self.ship_now()
                except Exception:
                    logger.warning("telemetry shipping flush failed",
                                   exc_info=True)
        self._thread = threading.Thread(
            target=loop, name=f"telemetry-shipper-{self._host}",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the writer thread, unsubscribe, final flush."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._tracer is not None:
            self._tracer.unsubscribe(self._pending.append)
            self._tracer = None
        try:
            self.ship_now()
        except Exception:
            logger.warning("telemetry shipping final flush failed",
                           exc_info=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# offline merge
# --------------------------------------------------------------------------

def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (the Metrics.percentile convention)."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(round(q * (len(ys) - 1))))]


def _new_host() -> Dict[str, Any]:
    return {"spans": [], "events": [], "metrics": [], "offsets": [],
            "gens": set(), "last_flush": 0.0, "costs": [],
            "xray": [], "forensics": [], "debug_addr": None}


class ClusterAggregator:
    """Merge a run directory's segments into one timeline + summary."""

    def __init__(self, run_dir: str):
        self._dir = run_dir
        self.hosts: Dict[str, Dict[str, Any]] = {}

    # -- loading -------------------------------------------------------
    def load(self) -> "ClusterAggregator":
        self.hosts = {}
        for path in sorted(glob.glob(os.path.join(self._dir,
                                                  SEGMENT_GLOB))):
            try:
                with open(path) as f:
                    raw = f.read()
            except OSError:
                continue
            seg_host = None
            for line in raw.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # lenient: skip anything unparseable
                kind = rec.get("record")
                if kind == "segment_header":
                    seg_host = str(rec.get("host", "?"))
                    h = self.hosts.setdefault(seg_host, _new_host())
                    h["gens"].add(int(rec.get("gen", 0)))
                    h["offsets"].append(
                        float(rec.get("clock_offset_s", 0.0)))
                    h["last_flush"] = max(h["last_flush"],
                                          float(rec.get("t", 0.0)))
                    if rec.get("debug_addr"):
                        h["debug_addr"] = str(rec["debug_addr"])
                elif kind in ("span", "event", "metrics", "cost",
                              "xray"):
                    host = str(rec.get("host") or seg_host or "?")
                    h = self.hosts.setdefault(host, _new_host())
                    if kind == "span":
                        h["spans"].append(rec)
                    elif kind == "event":
                        h["events"].append(rec)
                    elif kind == "metrics":
                        h["metrics"].append(rec)
                    elif kind == "xray":
                        h["xray"] = rec.get("programs", [])
                        h["forensics"] = rec.get("forensics", [])
                    else:
                        h["costs"] = rec.get("programs", [])
        return self

    def clock_offset(self, host: str) -> float:
        offs = self.hosts.get(host, {}).get("offsets") or []
        if not offs:
            return 0.0
        xs = sorted(offs)
        return xs[len(xs) // 2]

    # -- merged Perfetto trace ----------------------------------------
    def merge_trace(self) -> Dict[str, Any]:
        """One Chrome ``trace_event`` object: a process lane per host
        (clock-offset-corrected onto the shared timeline), spans as
        ``X``, elastic events as instants."""
        hosts = sorted(self.hosts)
        t_base = None
        for host in hosts:
            off = self.clock_offset(host)
            h = self.hosts[host]
            ts = [s["t0"] - off for s in h["spans"]] + \
                 [e["t"] - off for e in h["events"]]
            if ts:
                lo = min(ts)
                t_base = lo if t_base is None else min(t_base, lo)
        t_base = t_base or 0.0

        events: List[Dict[str, Any]] = []
        for i, host in enumerate(hosts):
            h = self.hosts[host]
            pid = i + 1
            off = self.clock_offset(host)
            gens = sorted(h["gens"]) or [0]
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"{host} (gen {gens[-1]})"},
            })
            events.append({
                "ph": "M", "name": "process_sort_index", "pid": pid,
                "tid": 0, "args": {"sort_index": i},
            })
            threads_seen: Dict[int, str] = {}
            for s in h["spans"]:
                tid = int(s.get("tid", 0))
                if tid not in threads_seen:
                    threads_seen[tid] = str(s.get("thread", tid))
                    events.append({
                        "ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": threads_seen[tid]},
                    })
                args = dict(s.get("args") or {})
                if s.get("corr") is not None:
                    args["corr"] = s["corr"]
                args["gen"] = s.get("gen", 0)
                ev: Dict[str, Any] = {
                    "name": s["name"], "cat": s.get("cat", "host"),
                    "pid": pid, "tid": tid,
                    "ts": round(max(
                        0.0, (s["t0"] - off - t_base) * 1e6), 3),
                    "args": args,
                }
                if s["t1"] <= s["t0"]:
                    ev["ph"] = "i"
                    ev["s"] = "t"
                else:
                    ev["ph"] = "X"
                    ev["dur"] = round((s["t1"] - s["t0"]) * 1e6, 3)
                events.append(ev)
                if ev["ph"] == "i" and s["name"] == "hbm" and args:
                    # per-host HBM counter lane on the merged timeline
                    events.append({
                        "ph": "C", "name": "HBM bytes", "cat": "host",
                        "pid": pid, "tid": 0, "ts": ev["ts"],
                        "args": {
                            "in_use": args.get("bytes_in_use", 0),
                            "peak": args.get("peak_bytes_in_use", 0),
                        },
                    })
                if ev["ph"] == "i" and s["name"] == "numerics" and args:
                    # per-host grad-norm counter lane: lanes diverging
                    # across hosts IS the corrupt-data-host signature
                    events.append({
                        "ph": "C", "name": "grad norm", "cat": "host",
                        "pid": pid, "tid": 0, "ts": ev["ts"],
                        "args": {
                            "grad_norm": args.get("grad_norm", 0.0),
                            "update_ratio": args.get(
                                "update_ratio", 0.0),
                        },
                    })
            for e in h["events"]:
                args = dict(e.get("args") or {})
                args["gen"] = e.get("gen", 0)
                events.append({
                    "name": e["kind"], "cat": "elastic", "ph": "i",
                    "s": "t", "pid": pid, "tid": 0,
                    "ts": round(max(
                        0.0, (e["t"] - off - t_base) * 1e6), 3),
                    "args": args,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_trace(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self._dir, "cluster_trace.json")
        return _atomic_write_text(
            path, json.dumps(self.merge_trace()))

    # -- cross-host request X-ray --------------------------------------
    def request_trees(self) -> Dict[int, Dict[str, Any]]:
        """Per-request span trees assembled across hosts: every
        shipped span dict (clock-offset-corrected onto the shared
        timeline, thread names host-qualified) is joined by the
        ``req:``/``rids``/``tick:`` conventions — a request whose life
        crossed hosts (router -> replica) assembles into ONE tree.
        See telemetry/requests.py."""
        from bigdl_tpu_torch.telemetry.requests import assemble_request_trees
        spans: List[Dict[str, Any]] = []
        for host in sorted(self.hosts):
            off = self.clock_offset(host)
            for s in self.hosts[host]["spans"]:
                rec = dict(s)
                rec["t0"] = s["t0"] - off
                rec["t1"] = s["t1"] - off
                rec["host"] = host
                rec["thread"] = f"{host}:{s.get('thread', '')}"
                spans.append(rec)
        return assemble_request_trees(spans)

    # -- cluster rollup ------------------------------------------------
    def _latest_snapshot(self, host: str) -> Dict[str, Any]:
        """Flattened view of the host's newest metrics records: the
        most recent value per field across all registered sources."""
        out: Dict[str, Any] = {}
        for rec in self.hosts[host]["metrics"]:
            snap = rec.get("snapshot") or {}
            values = snap.get("values") if isinstance(snap, dict) \
                else None
            if isinstance(values, dict):
                out.update(values)
            if isinstance(snap, dict):
                for key in ("queue_depth", "occupancy", "req_per_sec",
                            "tokens_per_sec", "p50_ms", "p99_ms",
                            "mfu", "gflops_per_sec", "bytes_per_sec",
                            "throughput", "grad_norm", "update_ratio"):
                    if key in snap:
                        out[key] = snap[key]
        return out

    def cluster_summary(self, now: Optional[float] = None) -> Dict:
        """Per-host + cluster step percentiles, world throughput, and
        straggler skew (per-step host time spread, joined on the
        ``step:N`` correlation IDs)."""
        now = time.time() if now is None else now
        per_host: Dict[str, Dict[str, Any]] = {}
        all_durs: List[float] = []
        step_groups: Dict[str, Dict[str, float]] = {}
        world_throughput = 0.0
        for host in sorted(self.hosts):
            h = self.hosts[host]
            durs = []
            for s in h["spans"]:
                if s["name"] not in STEP_SPANS:
                    continue
                dur = max(0.0, s["t1"] - s["t0"])
                durs.append(dur)
                corr = s.get("corr")
                if corr:
                    step_groups.setdefault(corr, {})[host] = dur
            all_durs.extend(durs)
            snap = self._latest_snapshot(host)
            throughput = float(snap.get("throughput")
                               or snap.get("req_per_sec") or 0.0)
            world_throughput += throughput
            per_host[host] = {
                "gen": max(h["gens"]) if h["gens"] else 0,
                "n_steps": len(durs),
                "step_p50_ms": round(1e3 * _pct(durs, 0.50), 3),
                "step_p95_ms": round(1e3 * _pct(durs, 0.95), 3),
                "step_p99_ms": round(1e3 * _pct(durs, 0.99), 3),
                "throughput": throughput,
                "grad_norm": float(snap.get("grad_norm") or 0.0),
                "update_ratio": float(snap.get("update_ratio") or 0.0),
                "mfu": float(snap.get("mfu") or 0.0),
                "bytes_per_sec": float(snap.get("bytes_per_sec")
                                       or 0.0),
                "queue_depth": int(snap.get("queue_depth") or 0),
                "occupancy": float(snap.get("occupancy") or 0.0),
                "clock_offset_s": round(self.clock_offset(host), 6),
                "last_flush_age_s": round(
                    max(0.0, now - h["last_flush"]), 3)
                    if h["last_flush"] else None,
                "events": sorted({e["kind"] for e in h["events"]}),
                "debug_addr": h.get("debug_addr"),
            }
        skews = [max(g.values()) - min(g.values())
                 for g in step_groups.values() if len(g) >= 2]
        # per-host grad-norm skew: under dp every host sees the SAME
        # post-allreduce gradients, so hosts disagreeing here means a
        # corrupt input shard or desynced parameters — a failure class
        # the elastic layer cannot see from step times alone
        gnorms = [s["grad_norm"] for s in per_host.values()
                  if s["grad_norm"] > 0.0]
        gmean = (sum(gnorms) / len(gnorms)) if gnorms else 0.0
        grad_skew = {
            "hosts": len(gnorms),
            "mean": round(gmean, 6),
            "max": round(max(gnorms), 6) if gnorms else 0.0,
            "min": round(min(gnorms), 6) if gnorms else 0.0,
            "rel_spread": round((max(gnorms) - min(gnorms)) / gmean, 6)
            if gnorms and gmean > 0 else 0.0,
        }
        cluster = {
            "hosts": len(per_host),
            "step_p50_ms": round(1e3 * _pct(all_durs, 0.50), 3),
            "step_p95_ms": round(1e3 * _pct(all_durs, 0.95), 3),
            "step_p99_ms": round(1e3 * _pct(all_durs, 0.99), 3),
            "world_throughput": round(world_throughput, 3),
            "straggler_skew_ms": {
                "mean": round(1e3 * (sum(skews) / len(skews)), 3)
                if skews else 0.0,
                "max": round(1e3 * max(skews), 3) if skews else 0.0,
                "n_steps": len(skews),
            },
            "grad_norm_skew": grad_skew,
        }
        return {"per_host": per_host, "cluster": cluster}

    def write_summary(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self._dir, "cluster_summary.json")
        return _atomic_write_text(
            path, json.dumps(self.cluster_summary(), indent=2,
                             sort_keys=True))


# --------------------------------------------------------------------------
# federated watchdog
# --------------------------------------------------------------------------

class FederatedWatchdog:
    """Cluster-level health over the aggregated telemetry.

    Each :meth:`check` reloads the run directory and flags hosts that
    are **stalled** (no segment flushed for ``stale_s``), **straggling**
    (step p50 beyond ``straggler_factor`` x the cluster p50), or
    **saturated** (serving queue depth / occupancy beyond the high
    -water marks).  Flags are raised through
    :meth:`Watchdog.peer_event` on the *transition* into the flagged
    state, so a persistent straggler is one anomaly, not one per poll.
    """

    def __init__(self, run_dir: str, *,
                 watchdog: Optional[Watchdog] = None,
                 stale_s: float = 10.0,
                 straggler_factor: float = 2.0,
                 min_steps: int = 8,
                 queue_depth_high: int = 32,
                 occupancy_high: float = 0.95,
                 log=logger.warning,
                 on_anomaly=None):
        self._dir = run_dir
        self.watchdog = watchdog if watchdog is not None else \
            Watchdog(log=log, on_anomaly=on_anomaly)
        self._stale_s = float(stale_s)
        self._straggler_factor = float(straggler_factor)
        self._min_steps = int(min_steps)
        self._queue_depth_high = int(queue_depth_high)
        self._occupancy_high = float(occupancy_high)
        self._flagged: Dict[str, set] = {}
        self._last_summary: Optional[Dict] = None

    def check(self, aggregator: Optional[ClusterAggregator] = None,
              now: Optional[float] = None) -> Dict[str, List[str]]:
        """One federated poll; returns ``{host: [flags...]}``."""
        agg = aggregator if aggregator is not None \
            else ClusterAggregator(self._dir).load()
        summary = agg.cluster_summary(now=now)
        self._last_summary = summary
        cluster_p50 = summary["cluster"]["step_p50_ms"]
        flags: Dict[str, List[str]] = {}
        for host, s in summary["per_host"].items():
            kinds = set()
            age = s["last_flush_age_s"]
            if age is not None and age > self._stale_s:
                kinds.add("stalled")
            elif (s["n_steps"] >= self._min_steps and cluster_p50 > 0
                  and s["step_p50_ms"]
                  > self._straggler_factor * cluster_p50):
                kinds.add("straggler")
            if (s["queue_depth"] >= self._queue_depth_high
                    or s["occupancy"] >= self._occupancy_high):
                kinds.add("saturated")
            for kind in sorted(kinds - self._flagged.get(host, set())):
                self.watchdog.peer_event(
                    host, kind, age_s=age if kind == "stalled" else 0.0)
            if kinds:
                flags[host] = sorted(kinds)
        self._flagged = {h: set(v) for h, v in flags.items()}
        return flags

    def flags(self) -> Dict[str, List[str]]:
        return {h: sorted(v) for h, v in self._flagged.items()}

    def report(self) -> Dict:
        """JSON-able snapshot: current flags + the underlying watchdog
        counters/anomalies + the summary the flags came from."""
        return {"flags": self.flags(),
                "watchdog": self.watchdog.report(),
                "summary": self._last_summary}
