"""Structured span/event tracer (counterpart of
bigdl_tpu/telemetry/tracer.py).

The training loop (loop thread, prefetch producer, checkpoint writer),
the ``ServingEngine`` (dispatcher and drain threads) and the
``DecodeEngine`` (its loop thread) each time their phases through a
metrics object; this module is the one timeline they share: a
process-global, thread-safe ring buffer of spans that every
:class:`~bigdl_tpu_torch.optim.metrics.Metrics` phase timer feeds (it is
a span sink), plus explicit spans and instants where averages cannot
explain (request lifecycle edges, checkpoint writes, divergence drains).

* A disabled tracer costs one attribute check per record site: nothing
  is allocated and no lock is taken.
* The ring keeps each span's fields in columns (lists of strings,
  numbers and the rare args dict), not as ``Span`` objects: Python's
  cyclic collector, whose full passes the allocation of surviving
  container objects triggers, sees no new object per span, so a traced
  server collects no more often than an untraced one.  ``Span`` objects
  are made when spans are read (and for subscribers, as recorded).
* Instrumentation is host-side only, between launches: a captured CUDA
  graph is the same with tracing on or off, and span times are the
  host's enqueue times, not the device's.
* Spans carry a free-form correlation string (``step:42``, ``req:17``,
  ``tick:1024``, ``item:7``) so one unit of work can be followed across
  the threads that touched it: the ambient per-thread correlation
  (:func:`set_correlation`) covers a phase that belongs to the current
  step or tick; lifecycle edges that outlive a thread pass ``corr``.

``BIGDL_TPU_TRACE=1`` enables the global tracer when it is first made,
``BIGDL_TPU_TRACE_BUFFER`` sizes the ring (default 65536 spans).
"""
from __future__ import annotations

import bisect
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import (Any, Callable, Deque, Dict, Iterator, List, Optional,
                    Tuple)

DEFAULT_CAPACITY = 65536

# span categories of the shipped instrumentation
CAT_TRAIN = "train"
CAT_DATA = "data"
CAT_SERVE = "serve"
CAT_DECODE = "decode"
CAT_HOST = "host"


class Span:
    """One completed host-side interval (an instant when t0 == t1)."""

    __slots__ = ("name", "cat", "t0", "t1", "tid", "thread", "corr",
                 "args")

    def __init__(self, name: str, cat: str, t0: float, t1: float,
                 tid: int, thread: str, corr: Optional[str],
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.thread = thread
        self.corr = corr
        self.args = args

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    @property
    def instant(self) -> bool:
        return self.t1 == self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={1e3 * self.duration:.3f}ms, corr={self.corr!r}, "
                f"thread={self.thread!r})")


_tls = threading.local()


def set_correlation(corr: Optional[str]):
    """Set this thread's ambient correlation ID (``step:42``); spans
    recorded without an explicit ``corr`` take it."""
    _tls.corr = corr


def get_correlation() -> Optional[str]:
    return getattr(_tls, "corr", None)


@contextmanager
def correlate(corr: str):
    """The ambient correlation ID of a block."""
    prev = get_correlation()
    set_correlation(corr)
    try:
        yield
    finally:
        set_correlation(prev)


_NFIELDS = len(Span.__slots__)
_REC = _NFIELDS  # a chunk's last column: when each span was recorded
_CHUNK = 1024  # spans per chunk of the ring


class Tracer:
    """Thread-safe bounded span sink.  The ring is a deque of chunks,
    each ``_CHUNK`` spans' fields in columns (one list per ``Span``
    field, and one of the times they were recorded), appended under a
    lock; a chunk whose spans all lie beyond the
    newest ``capacity`` is dropped whole, and readers see exactly the
    newest ``capacity`` spans.  A filled chunk never changes, so
    :meth:`window_since` hands out references to chunks, not copies.
    Subscribers (the :class:`~bigdl_tpu_torch.telemetry.watchdog.
    Watchdog`) see each span when it is recorded, outside the lock."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False):
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled)
        self._chunks: Deque[List[list]] = deque()
        self._size = 0  # spans in the chunks: len(self), and at most a
        # chunk more
        self._dropped = 0
        self._lock = threading.Lock()
        self._subs: List[Callable[[Span], None]] = []
        self.epoch = time.perf_counter()  # t=0 of the exported timeline

    def _trim(self):
        """Drop the chunks wholly beyond the newest ``capacity`` spans;
        called with the lock held."""
        chunks = self._chunks
        while chunks and self._size - len(chunks[0][0]) >= self.capacity:
            self._size -= len(chunks.popleft()[0])

    def _segments(self, start: int = 0) -> List[Tuple[List[list], int,
                                                        int]]:
        """``(columns, lo, hi)`` per chunk covering the readable spans
        from the ``start``-th oldest on; called with the lock held."""
        skip = max(0, self._size - self.capacity) + start
        out = []
        for cols in self._chunks:
            n = len(cols[0])
            if skip < n:
                out.append((cols, skip, n))
                skip = 0
            else:
                skip -= n
        return out

    # -- lifecycle -----------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                # only the readable spans survive a change of capacity
                segs = self._segments()
                self._chunks = deque([c[lo:hi] for c in cols]
                                     for cols, lo, hi in segs)
                self._size = sum(hi - lo for _, lo, hi in segs)
                self.capacity = max(1, int(capacity))
                self._trim()
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self):
        with self._lock:
            self._chunks = deque()
            self._size = 0
            self._dropped = 0
            self.epoch = time.perf_counter()

    @property
    def dropped(self) -> int:
        """Spans overwritten by the ring since the last clear()."""
        return self._dropped

    # -- subscription (the watchdog's feed) ----------------------------
    def subscribe(self, fn: Callable[[Span], None]):
        with self._lock:
            if fn not in self._subs:
                self._subs.append(fn)

    def unsubscribe(self, fn: Callable[[Span], None]):
        with self._lock:
            if fn in self._subs:
                self._subs.remove(fn)

    # -- recording -----------------------------------------------------
    def add_span(self, name: str, cat: str, t0: float, t1: float,
                 corr: Optional[str] = None,
                 args: Optional[Dict[str, Any]] = None):
        """Record an interval timed by the caller (``perf_counter``
        times).  Disabled, this is one attribute check."""
        if not self.enabled:
            return
        th = threading.current_thread()
        tid, thread = th.ident or 0, th.name
        if corr is None:
            corr = get_correlation()
        with self._lock:
            chunks = self._chunks
            if not chunks or len(chunks[-1][0]) >= min(_CHUNK,
                                                       self.capacity):
                chunks.append([[] for _ in range(_NFIELDS + 1)])
            c = chunks[-1]  # in Span.__slots__ order
            c[_REC].append(time.perf_counter())
            c[0].append(name)
            c[1].append(cat)
            c[2].append(t0)
            c[3].append(t1)
            c[4].append(tid)
            c[5].append(thread)
            c[6].append(corr)
            c[7].append(args)
            self._size += 1
            if self._size > self.capacity:
                self._dropped += 1
                self._trim()
            subs = self._subs
        if subs:
            span = Span(name, cat, t0, t1, tid, thread, corr, args)
            for fn in tuple(subs):  # outside the lock: a slow subscriber
                try:                # must not serialise the engines'
                    fn(span)        # threads on the ring
                except Exception:
                    pass  # an observer must never stop an engine thread

    def add_instants(self, name: str, cat: str, times: List[float],
                     corrs: List[Optional[str]]):
        """Record one instant per ``(time, corr)`` (a batch's request
        edges) under one lock, on the calling thread's track.  The
        caller checks :attr:`enabled` (when the edges happened: a batch
        recorded after the tracer was turned off is still recorded)."""
        if not times:
            return
        th = threading.current_thread()
        n, tid, thread = len(times), th.ident or 0, th.name
        rec = time.perf_counter()
        with self._lock:
            chunks, done = self._chunks, 0
            while done < n:
                room = min(_CHUNK, self.capacity)
                if not chunks or len(chunks[-1][0]) >= room:
                    chunks.append([[] for _ in range(_NFIELDS + 1)])
                c = chunks[-1]  # in Span.__slots__ order
                k = min(n - done, room - len(c[0]))
                ts = times[done:done + k]
                c[_REC].extend([rec] * k)
                c[0].extend([name] * k)
                c[1].extend([cat] * k)
                c[2].extend(ts)
                c[3].extend(ts)
                c[4].extend([tid] * k)
                c[5].extend([thread] * k)
                c[6].extend(corrs[done:done + k])
                c[7].extend([None] * k)
                done += k
            self._size += n
            if self._size > self.capacity:
                self._dropped += min(n, self._size - self.capacity)
                self._trim()
            subs = tuple(self._subs)
        for t, corr in zip(times, corrs) if subs else ():
            span = Span(name, cat, t, t, tid, thread, corr, None)
            for fn in subs:
                try:
                    fn(span)
                except Exception:
                    pass  # an observer must never stop an engine thread

    def instant(self, name: str, cat: str = CAT_HOST,
                corr: Optional[str] = None,
                args: Optional[Dict[str, Any]] = None):
        """A zero-length event (rejections, divergence, slot churn)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self.add_span(name, cat, t, t, corr=corr, args=args)

    @contextmanager
    def span(self, name: str, cat: str = CAT_HOST,
             corr: Optional[str] = None,
             args: Optional[Dict[str, Any]] = None):
        """The enclosed block as a span; takes no time stamp while the
        tracer is disabled."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, cat, t0, time.perf_counter(),
                          corr=corr, args=args)

    # -- reading -------------------------------------------------------
    def spans(self) -> List[Span]:
        """The ring in record order, oldest first."""
        with self._lock:
            segs = self._segments()
        return [span for seg in segs for span in window_spans([seg])]

    def window_since(self, t: float) -> List[Tuple[List[list], int, int]]:
        """The ring's spans recorded at or after ``t`` (``perf_counter``
        time), oldest first, as ``(columns, lo, hi)`` references into the
        ring's chunks (read them with :func:`window_spans`), found by
        bisection on the times they were recorded, which rise along the
        ring to within a thread's wait for its lock.  Copies nothing: a
        capture of the spans behind a request (the request X-ray's
        exemplars) costs a bisection."""
        with self._lock:
            segs = self._segments()
            ends, total = [], 0
            for _, lo, hi in segs:
                total += hi - lo
                ends.append(total)

            def rec_at(k: int) -> float:
                c = bisect.bisect_right(ends, k)
                cols, lo, _ = segs[c]
                return cols[_REC][lo + k - (ends[c - 1] if c else 0)]

            a, b = 0, total
            while a < b:
                mid = (a + b) // 2
                if rec_at(mid) < t:
                    a = mid + 1
                else:
                    b = mid
            return self._segments(a)

    def __len__(self) -> int:
        with self._lock:
            return min(self._size, self.capacity)


def window_spans(window: List[Tuple[List[list], int, int]]
                 ) -> Iterator[Span]:
    """The spans of a :meth:`Tracer.window_since` window, oldest first."""
    for cols, lo, hi in window:
        for row in zip(*(c[lo:hi] for c in cols[:_NFIELDS])):
            yield Span(*row)


_GLOBAL: Optional[Tracer] = None
_GLOBAL_LOCK = threading.Lock()


def _env_capacity() -> int:
    try:
        return max(1, int(os.environ.get("BIGDL_TPU_TRACE_BUFFER",
                                         DEFAULT_CAPACITY)))
    except ValueError:
        return DEFAULT_CAPACITY


def get_tracer() -> Tracer:
    """The process-global tracer every subsystem records into, made
    disabled unless ``BIGDL_TPU_TRACE=1``."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Tracer(
                    capacity=_env_capacity(),
                    enabled=os.environ.get("BIGDL_TPU_TRACE", "")
                    not in ("", "0"))
    return _GLOBAL


def enable(capacity: Optional[int] = None) -> Tracer:
    return get_tracer().enable(capacity)


def disable() -> Tracer:
    return get_tracer().disable()


@contextmanager
def enabled(capacity: Optional[int] = None):
    """Global tracing for a block (the prior state restored after)."""
    tr = get_tracer()
    was = tr.enabled
    tr.enable(capacity)
    try:
        yield tr
    finally:
        tr.enabled = was
