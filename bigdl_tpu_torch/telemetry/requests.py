"""Request X-ray: per-request latency attribution, span-tree assembly
and tail exemplars (counterpart of bigdl_tpu/telemetry/requests.py).

* :class:`RequestLedger`: a per-engine state machine that partitions
  each request's wall-clock life into named phases (queue wait,
  bucket and padding, device, prefill chunks, ticks while resident,
  page stalls, speculative rounds, sampling, delivery).  Each transition
  charges ``now - t_last`` to the phase the request was in, so the
  phases sum to the request's latency to float precision.  The
  :class:`Attribution` goes into ``log_line()`` and into every
  :class:`~bigdl_tpu_torch.serving.engine.DeadlineExceededError`, so a
  deadline miss names its dominant phase.
* :func:`assemble_request_trees`: joins spans (live ``Span`` objects or
  their dict form) into one tree per request through the correlation
  conventions: ``req:<rid>`` spans, ``dispatch_batch`` instants whose
  ``args["rids"]`` hold the rid, and ``tick:<n>``/``step:<n>`` spans
  that overlap the request's life.
* :class:`ExemplarReservoir`: keeps the span trees of the requests at
  or above the rolling p99, the slowest ``capacity`` of them.

``BIGDL_TPU_REQ_TRACE`` (``1``/``0`` force attribution on or off; unset
follows the tracer), ``BIGDL_TPU_EXEMPLARS`` (the reservoir's capacity;
``0`` disables; default 8).  All of it is host-side bookkeeping between
launches.
"""
from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from bigdl_tpu_torch.telemetry.tracer import (Span, Tracer, get_tracer,
                                              window_spans)

# -- the budget phases ------------------------------------------------
PHASE_QUEUE = "queue"            # submitted, waiting for dispatch/admit
PHASE_PAD = "pad"                # bucket selection + host-side padding
PHASE_DEVICE = "device"          # serving forward in flight + fetch wait
PHASE_PREFILL = "prefill"        # decode prefill chunks for this prompt
PHASE_RESIDENT = "resident"      # holding a slot across decode ticks
PHASE_PAGE_STALL = "page_stall"  # paused/evicted waiting for KV pages
PHASE_SPEC = "spec_verify"       # speculative draft+verify rounds
PHASE_SAMPLE = "sample"          # host-side token sampling
PHASE_DELIVER = "deliver"        # result conversion + future delivery

PHASES: Tuple[str, ...] = (
    PHASE_QUEUE, PHASE_PAD, PHASE_DEVICE, PHASE_PREFILL, PHASE_RESIDENT,
    PHASE_PAGE_STALL, PHASE_SPEC, PHASE_SAMPLE, PHASE_DELIVER)

_MAX_OPEN = 8192      # ledger safety bound on concurrently open requests
_WINDOW = 512         # closed-attribution rolling window for summaries
_P99_REFRESH = 16     # offers between reservoir p99 recomputations
# spans reach the ring in the order they end to within this many
# seconds (a thread reads the clock before it takes the ring's lock, and
# may wait for the interpreter's lock, 5 ms a switch, in between); a
# capture takes the ring's spans from this long before the request opened
_CAPTURE_SLACK_S = 0.05


def request_trace_enabled(tracer: Optional[Tracer] = None) -> bool:
    """``BIGDL_TPU_REQ_TRACE=1`` forces attribution on, ``=0`` off;
    unset follows the global tracer (on whenever tracing is)."""
    v = os.environ.get("BIGDL_TPU_REQ_TRACE", "")
    if v == "0":
        return False
    if v not in ("", "0"):
        return True
    return (tracer or get_tracer()).enabled


def exemplar_capacity() -> int:
    """Reservoir capacity from ``BIGDL_TPU_EXEMPLARS`` (0 disables)."""
    try:
        return max(0, int(os.environ.get("BIGDL_TPU_EXEMPLARS", 8)))
    except ValueError:
        return 8


class Attribution:
    """One closed request's exact latency budget."""

    __slots__ = ("rid", "t_open", "t_close", "phases", "counters")

    def __init__(self, rid: int, t_open: float, t_close: float,
                 phases: Dict[str, float], counters: Dict[str, int]):
        self.rid = rid
        self.t_open = t_open
        self.t_close = t_close
        self.phases = phases
        self.counters = counters

    @property
    def latency(self) -> float:
        return self.t_close - self.t_open

    def dominant(self) -> Tuple[str, float]:
        """The phase that ate the most of this request's life."""
        if not self.phases:
            return ("", 0.0)
        name = max(self.phases, key=lambda k: self.phases[k])
        return (name, self.phases[name])

    def as_dict(self) -> Dict[str, Any]:
        dom, dom_s = self.dominant()
        return {
            "rid": self.rid,
            "latency_ms": round(1e3 * self.latency, 4),
            "phases_ms": {k: round(1e3 * v, 4)
                          for k, v in sorted(self.phases.items())},
            "dominant": dom,
            "dominant_ms": round(1e3 * dom_s, 4),
            "counters": dict(sorted(self.counters.items())),
        }

    def summary(self) -> str:
        dom, dom_s = self.dominant()
        parts = [f"{k}={1e3 * v:.1f}ms"
                 for k, v in sorted(self.phases.items(),
                                    key=lambda kv: -kv[1]) if v > 0]
        return (f"req:{self.rid} {1e3 * self.latency:.1f}ms "
                f"dominant={dom}({1e3 * dom_s:.1f}ms) "
                + " ".join(parts))

    def __repr__(self):
        return f"Attribution({self.summary()})"


class _Open:
    __slots__ = ("t_open", "t_last", "phase", "phases", "counters")

    def __init__(self, now: float):
        self.t_open = now
        self.t_last = now
        self.phase = PHASE_QUEUE
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}


class RequestLedger:
    """Thread-safe per-engine budget accountant.

    Engines call :meth:`open` at submit, :meth:`to` on every lifecycle
    transition, and :meth:`close` at delivery/rejection.  Every call is
    one ``enabled`` check when the plane is off — the same discipline
    as the tracer.  The same wall interval may be charged to several
    concurrently resident requests (each lived through it); *within*
    one request the partition is exact.
    """

    def __init__(self, tracer: Optional[Tracer] = None):
        self._tracer = tracer if tracer is not None else get_tracer()
        v = os.environ.get("BIGDL_TPU_REQ_TRACE", "")
        self._force = None if v in ("",) else v != "0"
        self._lock = threading.Lock()
        self._open: Dict[int, _Open] = {}
        self._window: deque = deque(maxlen=_WINDOW)
        self._dominant: Dict[str, int] = {}
        self._n_closed = 0

    @property
    def enabled(self) -> bool:
        if self._force is not None:
            return self._force
        return self._tracer.enabled

    # -- lifecycle ----------------------------------------------------
    def open(self, rid: int, now: Optional[float] = None):
        if not self.enabled:
            return
        now = time.perf_counter() if now is None else now
        with self._lock:
            if len(self._open) < _MAX_OPEN:
                self._open[rid] = _Open(now)

    def open_many(self, opened: Iterable[Tuple[int, float]]):
        """:meth:`open` of many ``(rid, now)`` under one lock (a serving
        batch's requests, opened at their submit times)."""
        if not self.enabled:
            return
        with self._lock:
            for rid, now in opened:
                if len(self._open) < _MAX_OPEN:
                    self._open[rid] = _Open(now)

    def to(self, rid: int, phase: str, now: Optional[float] = None):
        """Charge the time since the last transition to the phase the
        request was in, then enter ``phase``."""
        if not self.enabled:
            return
        now = time.perf_counter() if now is None else now
        with self._lock:
            st = self._open.get(rid)
            if st is None:
                return
            st.phases[st.phase] = (st.phases.get(st.phase, 0.0)
                                   + (now - st.t_last))
            st.t_last = now
            st.phase = phase

    def to_many(self, rids: Iterable[int], phase: str,
                now: Optional[float] = None):
        """One transition for every concurrently resident request —
        the decode tick's sampling/spec-verify portions apply to every
        slot at once."""
        if not self.enabled:
            return
        now = time.perf_counter() if now is None else now
        with self._lock:  # one acquisition for the whole batch
            for rid in rids:
                st = self._open.get(rid)
                if st is None:
                    continue
                st.phases[st.phase] = (st.phases.get(st.phase, 0.0)
                                       + (now - st.t_last))
                st.t_last = now
                st.phase = phase

    def note(self, rid: int, counter: str, n: int = 1):
        """Bump a per-request event counter (prefill chunks, ticks,
        spec rounds, evictions) riding the attribution."""
        if not self.enabled:
            return
        with self._lock:
            st = self._open.get(rid)
            if st is not None:
                st.counters[counter] = st.counters.get(counter, 0) + n

    def close(self, rid: int,
              now: Optional[float] = None) -> Optional[Attribution]:
        """Finish the request: charge the residual to its current
        phase and return the exact budget (None when untracked)."""
        if not self.enabled:
            return None
        now = time.perf_counter() if now is None else now
        with self._lock:
            st = self._open.pop(rid, None)
            if st is None:
                return None
            st.phases[st.phase] = (st.phases.get(st.phase, 0.0)
                                   + (now - st.t_last))
            att = Attribution(rid, st.t_open, now, st.phases,
                              st.counters)
            self._window.append(att)
            dom = att.dominant()[0]
            self._dominant[dom] = self._dominant.get(dom, 0) + 1
            self._n_closed += 1
        return att

    def close_many(self, rids: Iterable[int], enter: str, at: float,
                   now: Optional[float] = None
                   ) -> List[Optional[Attribution]]:
        """For each of ``rids``: enter phase ``enter`` at ``at`` (as
        :meth:`to`), then :meth:`close` at ``now``, under one lock (a
        serving batch, closed after its results are out).  A request
        opened while the ledger was on is closed even if it is off by
        now, so a flip of the tracer leaves nothing open."""
        now = time.perf_counter() if now is None else now
        out: List[Optional[Attribution]] = []
        with self._lock:
            for rid in rids:
                st = self._open.pop(rid, None)
                if st is None:
                    out.append(None)
                    continue
                phases = st.phases
                phases[st.phase] = phases.get(st.phase, 0.0) + (at
                                                                - st.t_last)
                phases[enter] = phases.get(enter, 0.0) + (now - at)
                att = Attribution(rid, st.t_open, now, phases, st.counters)
                self._window.append(att)
                dom = att.dominant()[0]
                self._dominant[dom] = self._dominant.get(dom, 0) + 1
                self._n_closed += 1
                out.append(att)
        return out

    def drop(self, rid: int):
        """Forget a request without accounting (e.g. queue_full)."""
        with self._lock:
            self._open.pop(rid, None)

    # -- reading ------------------------------------------------------
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def recent(self, n: int = 16) -> List[Attribution]:
        with self._lock:
            return list(self._window)[-n:]

    def summary(self) -> Dict[str, Any]:
        """Rolling per-phase means over the closed window + the
        dominant-phase histogram (``log_line()``'s rollup)."""
        with self._lock:
            window = list(self._window)
            dominant = dict(self._dominant)
            n_closed = self._n_closed
            n_open = len(self._open)
        sums: Dict[str, float] = {}
        for att in window:
            for k, v in att.phases.items():
                sums[k] = sums.get(k, 0.0) + v
        n = max(1, len(window))
        return {
            "n_closed": n_closed,
            "n_open": n_open,
            "window": len(window),
            "phases_ms": {k: round(1e3 * v / n, 4)
                          for k, v in sorted(sums.items())},
            "dominant": dict(sorted(dominant.items(),
                                    key=lambda kv: -kv[1])),
        }

    def log_line(self) -> str:
        s = self.summary()
        if not s["window"]:
            return "xray: n=0"
        dom = next(iter(s["dominant"]), "")
        parts = [f"{k}={v:.1f}ms" for k, v in s["phases_ms"].items()
                 if v > 0]
        return (f"xray: n={s['n_closed']} dom={dom} "
                + " ".join(parts))

    def reset(self):
        with self._lock:
            self._open.clear()
            self._window.clear()
            self._dominant.clear()
            self._n_closed = 0


# --------------------------------------------------------------------------
# span-tree assembly (live Span objects or their dict form)
# --------------------------------------------------------------------------

def _f(s, key, default=None):
    """Field access across live ``Span`` objects and their dicts."""
    if isinstance(s, dict):
        return s.get(key, default)
    return getattr(s, key, default)


def _rid_of(corr) -> Optional[int]:
    if isinstance(corr, str) and corr.startswith("req:"):
        try:
            return int(corr[4:])
        except ValueError:
            return None
    return None


def assemble_request_trees(spans: Iterable[Any]) -> Dict[int, Dict]:
    """Join spans into one connected tree per request.

    Membership, in order: (1) ``corr == req:<rid>`` spans define each
    request and its window; (2) ``dispatch_batch`` instants whose
    ``args["rids"]`` contain the rid; (3) ``tick:<n>``/``step:<n>``
    correlated spans overlapping the request's window (the ticks the
    request lived through while resident).  Works on live ``Span``
    objects and on their dict form alike.
    """
    spans = [s for s in spans if s is not None]
    trees: Dict[int, Dict] = {}
    for s in spans:
        rid = _rid_of(_f(s, "corr"))
        if rid is None:
            continue
        t = trees.setdefault(rid, {
            "rid": rid, "spans": [], "t0": None, "t1": None,
            "threads": set()})
        t["spans"].append(s)
        t0, t1 = _f(s, "t0", 0.0), _f(s, "t1", 0.0)
        t["t0"] = t0 if t["t0"] is None else min(t["t0"], t0)
        t["t1"] = t1 if t["t1"] is None else max(t["t1"], t1)
        t["threads"].add(_f(s, "thread", ""))
    for s in spans:
        corr = _f(s, "corr")
        if _rid_of(corr) is not None:
            continue
        args = _f(s, "args") or {}
        rids = args.get("rids") if isinstance(args, dict) else None
        if rids:
            for rid in rids:
                t = trees.get(rid)
                if t is not None:
                    t["spans"].append(s)
                    t["threads"].add(_f(s, "thread", ""))
            continue
        if isinstance(corr, str) and corr.split(":", 1)[0] in (
                "tick", "step"):
            t0, t1 = _f(s, "t0", 0.0), _f(s, "t1", 0.0)
            for t in trees.values():
                if (t["t0"] is not None and t1 >= t["t0"]
                        and t0 <= t["t1"]):
                    t["spans"].append(s)
                    t["threads"].add(_f(s, "thread", ""))
    for t in trees.values():
        t["threads"] = sorted(t["threads"])
    return trees


def _span_dict(s) -> Dict[str, Any]:
    if isinstance(s, dict):
        return dict(s)
    return {"name": s.name, "cat": s.cat, "t0": s.t0, "t1": s.t1,
            "tid": s.tid, "thread": s.thread, "corr": s.corr,
            "args": s.args}


# --------------------------------------------------------------------------
# tail exemplars
# --------------------------------------------------------------------------

class ExemplarReservoir:
    """Bounded reservoir of the span trees of p99+ requests.

    :meth:`offer` is called with every closed :class:`Attribution`;
    once the rolling latency window holds ``min_samples``, a request at
    or above its p99 captures its full tree (its own ``req:`` spans,
    the batches that carried it, the ticks it lived through, plus one
    synthesized ``request:<rid>`` root slice carrying the budget) from
    the tracer ring.  The reservoir keeps the ``capacity`` slowest;
    a new exemplar evicts the fastest retained one.
    """

    def __init__(self, capacity: Optional[int] = None,
                 min_samples: int = 20, window: int = 512,
                 tracer: Optional[Tracer] = None):
        self.capacity = (exemplar_capacity() if capacity is None
                         else max(0, int(capacity)))
        self.min_samples = max(1, int(min_samples))
        self._tracer = tracer if tracer is not None else get_tracer()
        self._lock = threading.Lock()
        self._latencies: deque = deque(maxlen=max(8, int(window)))
        self._kept: List[Dict[str, Any]] = []  # sorted by latency asc
        self._offered = 0
        self._captured = 0
        # cached p99 threshold, refreshed every _P99_REFRESH offers —
        # sorting the whole window on every close is measurable on the
        # serve hot path, and a tail gate may lag a few requests
        self._thresh: Optional[float] = None
        self._stale = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def offer(self, att: Optional[Attribution]) -> bool:
        """Consider a closed request; capture + retain when it lands in
        the tail.  Returns True when captured."""
        if att is None or not self.enabled:
            return False
        with self._lock:
            self._offered += 1
            self._latencies.append(att.latency)
            if len(self._latencies) < self.min_samples:
                self._thresh = None
                return False
            self._stale += 1
            if self._thresh is None or self._stale >= _P99_REFRESH:
                # the nearest-rank p99: the (n - i)-th largest, i its
                # index in ascending order (a partial sort of a few)
                n = len(self._latencies)
                i = max(0, min(n - 1, int(round(0.99 * (n - 1)))))
                self._thresh = heapq.nlargest(n - i, self._latencies)[-1]
                self._stale = 0
            if att.latency < self._thresh:
                return False
            if (len(self._kept) >= self.capacity
                    and att.latency <= self._kept[0]["latency_s"]):
                return False
        ex = self._capture(att)
        with self._lock:
            self._kept.append(ex)
            self._kept.sort(key=lambda e: e["latency_s"])
            del self._kept[:max(0, len(self._kept) - self.capacity)]
            self._captured += 1
        return True

    def _capture(self, att: Attribution) -> Dict[str, Any]:
        """The request's root slice and a window on the ring's spans
        since it opened (references to the ring's chunks, which stay
        alive while the exemplar holds them); which of those spans
        belong to the request is settled when the exemplar is read, so a
        capture costs a bisection, and an exemplar evicted unread costs
        no scan."""
        th = threading.current_thread()
        root = Span(f"request:{att.rid}", "request", att.t_open,
                    att.t_close, th.ident or 0, th.name, f"req:{att.rid}",
                    args=att.as_dict())
        return {
            "rid": att.rid,
            "latency_s": att.latency,
            "attribution": att.as_dict(),
            "root": root,
            "_window": self._tracer.window_since(att.t_open
                                                 - _CAPTURE_SLACK_S),
            "_att": att,
        }

    @staticmethod
    def _resolve(ex: Dict[str, Any]) -> Dict[str, Any]:
        """Settle a captured exemplar's ``spans`` (its own, the batches
        that carried it, the ticks it lived through) and ``threads``;
        called with the reservoir's lock held."""
        window = ex.pop("_window", None)
        if window is not None:
            att = ex.pop("_att")
            corr, rid = f"req:{att.rid}", att.rid
            t0, t1 = att.t_open, att.t_close
            got: List[Any] = []
            for s in window_spans(window):
                if s.corr == corr:
                    got.append(s)
                    continue
                rids = (s.args or {}).get("rids")
                if rids and rid in rids:
                    got.append(s)
                    continue
                if (s.corr and s.corr.startswith("tick:")
                        and s.t1 >= t0 and s.t0 <= t1):
                    got.append(s)
            ex["spans"] = got
            ex["threads"] = sorted({_f(s, "thread", "") for s in got})
        return ex

    # -- reading ------------------------------------------------------
    def exemplars(self) -> List[Dict[str, Any]]:
        with self._lock:  # slowest first
            return [self._resolve(ex) for ex in reversed(self._kept)]

    def spans(self) -> List[Span]:
        """Every retained span, the synthesized roots included."""
        out: List[Span] = []
        with self._lock:
            kept = [self._resolve(ex) for ex in self._kept]
        for ex in kept:
            out.append(ex["root"])
            out.extend(ex["spans"])
        return out

    def as_blob(self) -> Dict[str, Any]:
        """The reservoir in JSON-able form."""
        with self._lock:
            kept = [self._resolve(ex) for ex in reversed(self._kept)]
            offered, captured = self._offered, self._captured
        return {
            "offered": offered,
            "captured": captured,
            "exemplars": [{
                "rid": ex["rid"],
                "latency_ms": round(1e3 * ex["latency_s"], 4),
                "attribution": ex["attribution"],
                "threads": ex["threads"],
                "spans": [_span_dict(s)
                          for s in [ex["root"], *ex["spans"]]],
            } for ex in kept],
        }

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "kept": len(self._kept),
                "capacity": self.capacity,
                "offered": self._offered,
                "captured": self._captured,
                "slowest_ms": (round(1e3 * self._kept[-1]["latency_s"],
                                     3) if self._kept else 0.0),
            }

    def clear(self):
        with self._lock:
            self._kept.clear()
            self._latencies.clear()
            self._offered = 0
            self._captured = 0
            self._thresh = None
            self._stale = 0
