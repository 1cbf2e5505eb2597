"""Trace and metrics exporters (counterpart of
bigdl_tpu/telemetry/export.py).

* :func:`chrome_trace` / :func:`write_chrome_trace`: Chrome
  ``trace_event`` JSON, which ``ui.perfetto.dev`` loads: an ``"X"`` event
  per span, ``"i"`` per instant and ``"M"`` events naming every thread,
  so the loop, prefetch, checkpoint writer, dispatcher and drain threads
  each get a labelled track, with the correlation ID in each slice's
  args; the HBM ledger's samples add a counter lane, and each request's
  slices are joined by flow arrows across threads.
* :func:`write_scalars`: TensorBoard scalars through the port's
  ``visualization`` writer.
* :func:`metrics_record` / :func:`write_metrics_jsonl` /
  :func:`read_metrics_jsonl`: the newline-JSON metrics dump, one
  self-describing object per line, safe to append across runs.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from bigdl_tpu_torch.telemetry.tracer import Span, Tracer, get_tracer


def _us(t: float, epoch: float) -> float:
    """Microseconds since the tracer's epoch; a phase that straddled
    enable() starts at the origin."""
    return max(0.0, (t - epoch) * 1e6)


def chrome_trace(tracer: Optional[Tracer] = None,
                 spans: Optional[Iterable[Span]] = None,
                 process_name: str = "bigdl_tpu") -> Dict[str, Any]:
    """Spans as a Chrome ``trace_event`` object; ``spans`` replaces the
    tracer's ring when given (a filtered slice, say)."""
    tracer = tracer if tracer is not None else get_tracer()
    if spans is None:
        spans = tracer.spans()
    pid = os.getpid()
    epoch = tracer.epoch
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    threads_seen: Dict[int, str] = {}
    for s in spans:
        if s.tid not in threads_seen:
            threads_seen[s.tid] = s.thread
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": s.tid, "args": {"name": s.thread},
            })
        args: Dict[str, Any] = dict(s.args or {})
        if s.corr is not None:
            args["corr"] = s.corr
        ev: Dict[str, Any] = {
            "name": s.name, "cat": s.cat, "pid": pid, "tid": s.tid,
            "ts": round(_us(s.t0, epoch), 3),
        }
        if args:
            ev["args"] = args
        if s.instant:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = round(max(0.0, (s.t1 - s.t0) * 1e6), 3)
        events.append(ev)
        if s.instant and s.name == "hbm" and s.args:
            # the HBM ledger's samples as a counter lane
            events.append({
                "ph": "C", "name": "HBM bytes", "cat": s.cat,
                "pid": pid, "tid": 0, "ts": ev["ts"],
                "args": {
                    "in_use": s.args.get("bytes_in_use", 0),
                    "peak": s.args.get("peak_bytes_in_use", 0),
                },
            })
    # flow arrows join each request's slices across threads (dispatcher
    # -> drain, or the decode loop's ticks): Perfetto binds a flow event
    # to the slice enclosing (pid, tid, ts)
    flows: Dict[str, List[Span]] = {}
    for s in spans:
        if isinstance(s.corr, str) and s.corr.startswith("req:"):
            flows.setdefault(s.corr, []).append(s)
    fallback_id = 1 << 20
    for corr in sorted(flows):
        group = sorted(flows[corr], key=lambda s: (s.t0, s.t1))
        if len(group) < 2:
            continue
        try:
            flow_id = int(corr[4:])
        except ValueError:
            flow_id, fallback_id = fallback_id, fallback_id + 1
        last = len(group) - 1
        for i, s in enumerate(group):
            ev = {
                "ph": "s" if i == 0 else ("f" if i == last else "t"),
                "id": flow_id, "name": corr, "cat": "request_flow",
                "pid": pid, "tid": s.tid,
                "ts": round(_us(s.t0, epoch), 3),
            }
            if i == last:
                ev["bp"] = "e"  # the arrow's head binds to its slice
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None,
                       spans: Optional[Iterable[Span]] = None) -> str:
    """Write the trace file (a temporary file renamed into place, so a
    kill mid-dump leaves no torn file); returns ``path``."""
    blob = chrome_trace(tracer, spans)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)
    return path


def write_scalars(summary, scalars: Dict[str, float], step: int,
                  prefix: str = "") -> None:
    """A flat ``{tag: value}`` dict through a ``visualization`` summary
    writer (``TelemetrySummary``, say)."""
    for tag, value in sorted(scalars.items()):
        summary.add_scalar(f"{prefix}{tag}", float(value), step)


def metrics_record(name: str, metrics,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """One JSON-able record of a :class:`~bigdl_tpu_torch.optim.metrics.
    Metrics`: each phase's mean and count and the values (throughput,
    mfu, bytes_per_sec), the machine-readable twin of ``summary()``.
    The port's ``Metrics`` keeps no event counters, so ``counters`` is
    empty."""
    phases = {k: {"mean_ms": round(1e3 * metrics.get(k), 4),
                  "count": metrics.count(k)}
              for k in sorted(metrics.phases())}
    rec: Dict[str, Any] = {
        "record": name,
        "unix_time": round(time.time(), 3),
        "phases": phases,
        "counters": {},
    }
    values = metrics.values()
    if values:
        rec["values"] = dict(sorted(values.items()))
    if extra:
        rec.update(extra)
    return rec


_JSONL_LOCK = threading.Lock()


def write_metrics_jsonl(path: str, records: Iterable[Dict[str, Any]],
                        append: bool = True) -> str:
    """Append (by default) newline-delimited JSON records to ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    lines = "".join(json.dumps(r, sort_keys=True) + "\n"
                    for r in records)
    with _JSONL_LOCK:
        with open(path, "a" if append else "w") as f:
            f.write(lines)
    return path


def read_metrics_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]
