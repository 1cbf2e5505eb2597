"""Serving engine: bucketed batching with pipelined dispatch
(counterpart of bigdl_tpu/serving/engine.py:142-528).

* Requests (float32 numpy samples, no batch dim) are padded onto a
  :class:`~bigdl_tpu_torch.serving.bucketing.BucketGrid`.  Each bucket's
  forward is compiled once (``serving/warmup.py`` ``compile_bucket``):
  on the card a CUDA graph, all of them in one memory pool, so a batch
  is one replay; on the CPU the eager call.  ``warmup()`` compiles every
  declared bucket, the largest first, so steady-state traffic never
  waits on a compile; ``metrics.recompiles`` counts the compiles (the
  declared buckets after warmup; growth is a bucket the grid missed,
  compiled on the request path).
* A dispatcher thread groups queued requests by bucket, pads them,
  copies the batch to the device, casts it to ``input_dtype`` there and
  enqueues the forward and a copy of its output without waiting (the
  next replay overwrites the graph's output buffer); a drain thread
  copies results to the host, crops them and resolves the futures.  At
  most ``pipeline_depth`` batches are in flight.
* Admission control: a bounded queue with fast :class:`QueueFullError`,
  per-request deadlines checked before dispatch
  (:class:`DeadlineExceededError`), per-request exception delivery, and a
  draining ``close()`` / context manager.
* Telemetry (``bigdl_tpu_torch.telemetry``), host-side only: tracer
  instants at each request's edges (``enqueue``, ``queue_full``,
  ``deadline_reject``, ``dispatch_batch`` with its ``rids``,
  ``deliver``), the request X-ray's phases (queue, pad, device, deliver)
  and tail exemplars, each bucket's cost stamp (counted from one eager
  call before its capture) and compile in the program registry, the
  flops and bytes of every dispatched batch, and the workload recorder;
  ``start()`` attaches the engine to the debug server (``/metricsz``
  reads its metrics, ``/statusz`` its queue and X-ray, ``/tracez`` its
  exemplars) and registers its metrics and exemplars with the flight
  recorder, and ``close()`` detaches it (bigdl_tpu/serving/engine.py:
  353-387).
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.serving.bucketing import Bucket, BucketGrid
from bigdl_tpu_torch.serving.metrics import (PeriodicMetricsLogger,
                                             ServingMetrics)
from bigdl_tpu_torch.serving.warmup import (build_forward, bucket_struct,
                                            compile_bucket)
from bigdl_tpu_torch.telemetry import (costmodel, debug_server,
                                       flightrecorder, programs)
from bigdl_tpu_torch.telemetry import requests as request_xray
from bigdl_tpu_torch.telemetry import workload
from bigdl_tpu_torch.telemetry.tracer import CAT_SERVE, get_tracer
from bigdl_tpu_torch.utils import graphs

logger = logging.getLogger("bigdl_tpu_torch.serving")


class ServingError(RuntimeError):
    """Base class of serving-engine request failures."""


class QueueFullError(ServingError):
    """Fast rejection: the bounded request queue is full."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired.  While the request X-ray is live,
    ``attribution`` holds the request's exact per-phase budget and the
    message names the dominant phase."""

    def __init__(self, msg: str = "",
                 attribution: Optional[request_xray.Attribution] = None):
        if attribution is not None:
            dom, dom_s = attribution.dominant()
            if dom:
                msg = (f"{msg} [dominant: {dom} {1e3 * dom_s:.1f}ms of "
                       f"{1e3 * attribution.latency:.1f}ms]")
        super().__init__(msg)
        self.attribution = attribution


class EngineClosedError(ServingError):
    """Submitted to (or abandoned by) a closed engine."""


class ServingFuture:
    """Single-request result slot: ``result()`` blocks; an exception
    that failed the request re-raises."""

    def __init__(self):
        self._ev = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable] = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("serving result not ready")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("serving result not ready")
        return self._exc

    def add_done_callback(self, fn: Callable[["ServingFuture"], None]):
        """Call ``fn(self)`` once the request is done (at once if it is)."""
        with self._lock:
            if not self._ev.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _finish(self):
        with self._lock:
            self._ev.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # a callback must not stop the engine
                logger.exception("serving future callback failed")

    def set_result(self, value):
        self._value = value
        self._finish()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._finish()


class _Request:
    __slots__ = ("x", "fut", "t_submit", "deadline", "rid")

    def __init__(self, x, fut, t_submit, deadline, rid=0):
        self.x = x
        self.fut = fut
        self.t_submit = t_submit
        self.deadline = deadline
        self.rid = rid  # correlation ID joining the request's spans


_CLOSE = object()  # queue sentinel


class ServingEngine:
    """Bucketed, pipelined inference engine over one eval-mode model.

    ``model`` is a module of the port; ``variables``, when given, is a
    JAX ``{"params", "state"}`` tree loaded into it by name
    (:func:`~bigdl_tpu_torch.utils.load_jax_variables`).  ``device``
    defaults to the card; ``device="cpu"`` serves on the CPU.
    ``input_dtype`` is the torch dtype the model computes in: requests
    arrive as float32 and are cast on the device.  Thread-safe:
    ``submit``/``predict`` may be called from any number of threads.
    """

    def __init__(self, model: torch.nn.Module, variables: Optional[dict] = None,
                 *, buckets: Optional[Sequence[Sequence[int]]] = None,
                 batch_sizes: Sequence[int] = (1, 8, 32),
                 batch_window_ms: float = 2.0,
                 max_queue: int = 1024,
                 pipeline_depth: int = 2,
                 default_deadline_ms: Optional[float] = None,
                 pad_value: float = 0.0,
                 input_dtype: torch.dtype = torch.float32,
                 warmup: bool = True,
                 start: bool = True,
                 metrics: Optional[ServingMetrics] = None,
                 metrics_log_every_s: Optional[float] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if variables is not None:
            from bigdl_tpu_torch.utils.convert import load_jax_variables
            load_jax_variables(self.model, variables)
        self.grid = (buckets if isinstance(buckets, BucketGrid)
                     else BucketGrid(buckets, batch_sizes, pad_value))
        self.batch_window_ms = batch_window_ms
        self.default_deadline_ms = default_deadline_ms
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.input_dtype = input_dtype
        self._forward = build_forward(self.model)
        self._compiled: dict = {}  # (batch, dims) -> compiled forward
        self._bucket_costs: dict = {}  # (batch, dims) -> ProgramCost
        self._warming = False
        self._tracer = get_tracer()
        self._registry = programs.get_program_registry()
        self._rids = itertools.count()
        # request X-ray: exact per-request budgets and tail exemplars
        self.xray = request_xray.RequestLedger(tracer=self._tracer)
        self.exemplars = request_xray.ExemplarReservoir(
            tracer=self._tracer)
        self._pool = (graphs.new_pool() if self.device.type == "cuda"
                      else None)
        # compiles, replays and the copies of their outputs: one thread
        # at a time, since the graphs share their memory pool
        self._run_lock = threading.Lock()

        self._rq: "queue.Queue" = queue.Queue(maxsize=max(1, max_queue))
        self._fly: "queue.Queue" = queue.Queue(maxsize=max(1, pipeline_depth))
        self._closed = False
        self._discard = False
        self._close_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="bigdl-serve-dispatch")
        self._drainer = threading.Thread(
            target=self._drain_loop, daemon=True, name="bigdl-serve-drain")
        self._periodic = PeriodicMetricsLogger(
            self.log_line, every_s=metrics_log_every_s)
        self._started = False

        if warmup and self.grid.dims_grid:
            self.warmup()
        if start:
            self.start()

    # ------------------------------------------------------------------
    # buckets
    # ------------------------------------------------------------------
    @property
    def declared_buckets(self) -> Tuple[Bucket, ...]:
        return tuple(self.grid.declared_buckets())

    @property
    def recompiles(self) -> int:
        return self.metrics.recompiles

    def warmup(self) -> int:
        """Compile every declared bucket, the largest first (its graph
        sets the shared pool's size); returns how many compiles ran (0
        on a re-warm)."""
        before = self.metrics.recompiles
        # declared buckets are expected compiles: no forensics for them
        self._warming = True
        try:
            for bucket in sorted(self.grid.declared_buckets(), reverse=True,
                                 key=lambda b: b.batch * int(np.prod(b.dims))):
                with self._run_lock:
                    self._ensure_bucket(bucket.batch, bucket.dims)
        finally:
            self._warming = False
        return self.metrics.recompiles - before

    def _ensure_bucket(self, batch: int, dims: Tuple[int, ...]) -> Callable:
        """The bucket's compiled forward, compiled and counted at its
        first sight.  Called with ``_run_lock`` held."""
        key = (batch, tuple(dims))
        fwd = self._compiled.get(key)
        if fwd is None:
            bucket = Bucket(*key)
            count = costmodel.new_count()
            t0 = time.perf_counter()
            fwd = compile_bucket(self._forward, bucket, self.input_dtype,
                                 self.device, self._pool, count)
            dt = time.perf_counter() - t0
            # the bucket's flops and bytes, which _run accounts per batch
            cost = costmodel.stamp(
                f"serving_forward:{batch}x" + "x".join(map(str, dims)),
                count)
            if cost is not None:
                self._bucket_costs[key] = cost
                self.metrics.record_program_cost(cost)
            # registered before record_recompile's span, so that the
            # Watchdog pairs its forensic instant with that span
            programs.register_program(
                "serving_forward",
                programs.signature_of(
                    {"params": self.model,
                     "x": bucket_struct(bucket, self.input_dtype)}),
                fwd, dt, cost=cost, expected=self._warming)
            self.metrics.record_recompile(dt)
            self._compiled[key] = fwd
        return fwd

    def _to_device(self, xp: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(xp, dtype=np.float32))
        return x.to(self.device).to(self.input_dtype)

    def _run(self, xp: np.ndarray) -> torch.Tensor:
        """Enqueue the forward of a padded bucket batch; returns its
        float32 output on the device (not yet waited for) in a tensor of
        its own: the compiled forward's output buffer belongs to the
        graph, and the next replay writes it while the drain thread may
        not have read this batch yet."""
        x = self._to_device(xp)
        key = (xp.shape[0], tuple(xp.shape[1:]))
        with self._run_lock:
            fwd = self._ensure_bucket(*key)
            cost = self._bucket_costs.get(key)
            if cost is not None:
                self.metrics.record_compute(cost.flops, cost.bytes_accessed)
            self._registry.record_call("serving_forward")
            return fwd(x).to(torch.float32, copy=True)

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, x, deadline_ms: Optional[float] = None) -> ServingFuture:
        """Queue one sample (no batch dim); returns a future.  Raises
        :class:`QueueFullError` at once when the queue is full and
        :class:`EngineClosedError` after ``close()``."""
        if self._closed:
            raise EngineClosedError("submit on a closed engine")
        x = np.asarray(x, dtype=np.float32)
        fut = ServingFuture()
        now = time.perf_counter()
        dl = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        rid = next(self._rids)
        req = _Request(x, fut, now, now + dl / 1e3 if dl is not None else None,
                       rid=rid)
        try:
            self._rq.put_nowait(req)
        except queue.Full:
            self.metrics.inc_rejected()
            self._tracer.instant("queue_full", CAT_SERVE, corr=f"req:{rid}",
                                 args={"max_queue": self._rq.maxsize})
            raise QueueFullError(
                f"request queue full ({self._rq.maxsize}); retry later"
            ) from None
        # the request's ``enqueue`` instant and its X-ray entry are
        # recorded by the dispatcher, at this submit time, for its whole
        # batch at once: a traced submit costs the caller nothing more
        rec = workload.recorder()
        if rec is not None:
            rec.record_serve(rid, x.shape, str(x.dtype), deadline_ms=dl)
        return fut

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        """Submit one sample and wait for its (cropped) result."""
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    def predict_batch(self, x) -> np.ndarray:
        """Synchronous path for already-batched, same-shape input (axis
        0 = batch): pads to the grid, runs, crops.  Bypasses the queue."""
        x = np.asarray(x, dtype=np.float32)
        dims, _ = self.grid.choose_dims(x.shape[1:])
        outs = []
        for lo in range(0, x.shape[0], self.grid.max_batch):
            chunk = x[lo:lo + self.grid.max_batch]
            b = self.grid.choose_batch(len(chunk))
            xp = self.grid.pad_batch(chunk, dims, b, np.float32)
            y = self._run(xp).cpu().numpy()
            outs.append(self.grid.unpad_batch(y[:len(chunk)], x.shape[1:],
                                              dims))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        if not self._started:
            self._started = True
            self._dispatcher.start()
            self._drainer.start()
            self._periodic.start()
            # the live plane: host-side registration only (no-ops while
            # it is off)
            self._detach_debug = debug_server.attach_engine(
                "serve", role="serve", metrics=lambda: self.metrics,
                status=lambda: {"queue_depth": self._rq.qsize(),
                                "xray": self.xray.summary(),
                                "exemplars": self.exemplars.summary()},
                exemplars=lambda: self.exemplars)
            flight = flightrecorder.get_flight_recorder()
            if flight is not None:
                flight.add_metrics("serve", lambda: self.metrics)
                flight.add_blob("exemplars-serve", self.exemplars.as_blob)

    @property
    def _logger(self) -> Optional[threading.Thread]:
        """The periodic log line's thread (``None`` while it is off)."""
        return self._periodic.thread

    def close(self, drain: bool = True, timeout: float = 30.0):
        """Stop accepting requests and shut down.  ``drain=True`` serves
        everything already queued or in flight first; ``drain=False``
        fails queued requests with :class:`EngineClosedError`.
        Idempotent."""
        with self._close_lock:
            already, self._closed = self._closed, True
        if already:
            return
        detach = getattr(self, "_detach_debug", None)
        if detach is not None:
            detach()
        self._periodic.close(timeout)
        self._discard = not drain
        if not self._started:
            while True:
                try:
                    req = self._rq.get_nowait()
                except queue.Empty:
                    return
                req.fut.set_exception(
                    EngineClosedError("engine closed before start"))
        # FIFO: the sentinel lands behind every accepted request
        self._rq.put(_CLOSE)
        self._dispatcher.join(timeout)
        self._drainer.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # dispatcher thread: gather -> bucket -> pad -> enqueue the forward
    # ------------------------------------------------------------------
    def _dispatch_loop(self):
        window = max(0.0, self.batch_window_ms) / 1e3
        stopping = False
        while not stopping:
            first = self._rq.get()
            if first is _CLOSE:
                break
            batch = [first]
            deadline = time.perf_counter() + window
            while len(batch) < self.grid.max_batch:
                remaining = deadline - time.perf_counter()
                try:
                    nxt = (self._rq.get(timeout=remaining)
                           if remaining > 0 else self._rq.get_nowait())
                except queue.Empty:
                    break
                if nxt is _CLOSE:
                    stopping = True
                    break
                batch.append(nxt)
            self.metrics.set_queue_depth(self._rq.qsize())
            self._dispatch(batch)
        # late submits that raced close(): never served, fail them
        while True:
            try:
                req = self._rq.get_nowait()
            except queue.Empty:
                break
            if req is not _CLOSE:
                req.fut.set_exception(EngineClosedError("engine closed"))
        self._fly.put(_CLOSE)

    def _dispatch(self, batch: List[_Request]):
        traced = self._tracer.enabled  # as the batch is dispatched
        if traced:
            self._tracer.add_instants(
                "enqueue", CAT_SERVE, [r.t_submit for r in batch],
                [f"req:{r.rid}" for r in batch])
        self.xray.open_many((r.rid, r.t_submit) for r in batch)
        now = time.perf_counter()
        live: List[_Request] = []
        for r in batch:
            if self._discard:
                self.xray.drop(r.rid)
                r.fut.set_exception(EngineClosedError("engine closed"))
            elif r.deadline is not None and now > r.deadline:
                self.metrics.inc_expired()
                self._tracer.instant("deadline_reject", CAT_SERVE,
                                     corr=f"req:{r.rid}")
                r.fut.set_exception(DeadlineExceededError(
                    f"deadline expired {1e3 * (now - r.deadline):.1f}ms "
                    "before dispatch",
                    attribution=self.xray.close(r.rid, now=now)))
            else:
                live.append(r)
        groups: dict = {}
        for r in live:
            dims, _ = self.grid.choose_dims(r.x.shape)
            groups.setdefault(dims, []).append(r)
        for dims, rs in groups.items():
            for lo in range(0, len(rs), self.grid.max_batch):
                chunk = rs[lo:lo + self.grid.max_batch]
                b = self.grid.choose_batch(len(chunk))
                t0 = time.perf_counter()
                try:
                    xp = self.grid.pad_batch([r.x for r in chunk], dims, b,
                                             np.float32)
                    y = self._run(xp)
                except Exception as e:  # per-request delivery, keep serving
                    for r in chunk:
                        self.xray.drop(r.rid)
                        r.fut.set_exception(e)
                    continue
                t1 = time.perf_counter()
                self.metrics.record_dispatch(t1 - t0)
                # the batch's phases, charged once its forward is on the
                # device: the bookkeeping overlaps the device's work
                self.xray.to_many((r.rid for r in chunk),
                                  request_xray.PHASE_PAD, now=t0)
                self.xray.to_many((r.rid for r in chunk),
                                  request_xray.PHASE_DEVICE, now=t1)
                self.metrics.record_batch(len(chunk), b)
                if traced:
                    # one instant per batch, naming its requests
                    self._tracer.instant(
                        "dispatch_batch", CAT_SERVE,
                        args={"bucket": [b, *dims],
                              "rids": [r.rid for r in chunk]})
                # bounded: blocks while pipeline_depth batches are in
                # flight (backpressure instead of unbounded enqueue)
                self._fly.put((y, dims, chunk))

    # ------------------------------------------------------------------
    # drain thread: copy results to the host, crop, deliver
    # ------------------------------------------------------------------
    def _drain_loop(self):
        while True:
            item = self._fly.get()
            if item is _CLOSE:
                return
            y, dims, chunk = item
            t0 = time.perf_counter()
            try:
                ynp = y.cpu().numpy()  # waits for the device
            except Exception as e:
                for r in chunk:
                    self.xray.drop(r.rid)
                    r.fut.set_exception(e)
                continue
            now = time.perf_counter()
            self.metrics.record_fetch(now - t0)
            traced = self._tracer.enabled  # as the batch is delivered
            for i, r in enumerate(chunk):
                r.fut.set_result(self.grid.unpad(ynp[i], r.x.shape, dims))
                self.metrics.record_latency(now - r.t_submit)
            self.metrics.inc_completed(len(chunk))
            # the batch's deliver instants and X-ray closes after its
            # results: tracing adds nothing to the requests' latency here
            if traced:
                self._tracer.add_instants(
                    "deliver", CAT_SERVE, [now] * len(chunk),
                    [f"req:{r.rid}" for r in chunk])
            for att in self.xray.close_many(
                    [r.rid for r in chunk], request_xray.PHASE_DELIVER, now):
                self.exemplars.offer(att)

    def log_line(self) -> str:
        line = self.metrics.log_line()
        if self.xray.enabled:
            line = f"{line} | {self.xray.log_line()}"
        return line
