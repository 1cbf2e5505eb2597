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

The JAX engine's request X-ray, tracer, program registry and workload
recorder hooks are telemetry and are not ported yet.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.serving.bucketing import Bucket, BucketGrid
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.warmup import build_forward, compile_bucket
from bigdl_tpu_torch.utils import graphs

logger = logging.getLogger("bigdl_tpu_torch.serving")


class ServingError(RuntimeError):
    """Base class of serving-engine request failures."""


class QueueFullError(ServingError):
    """Fast rejection: the bounded request queue is full."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before dispatch."""


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
    __slots__ = ("x", "fut", "t_submit", "deadline")

    def __init__(self, x, fut, t_submit, deadline):
        self.x = x
        self.fut = fut
        self.t_submit = t_submit
        self.deadline = deadline


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
        self._log_every_s = metrics_log_every_s or 0.0
        self._log_stop = threading.Event()
        self._logger: Optional[threading.Thread] = None
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
        for bucket in sorted(self.grid.declared_buckets(), reverse=True,
                             key=lambda b: b.batch * int(np.prod(b.dims))):
            with self._run_lock:
                self._ensure_bucket(bucket.batch, bucket.dims)
        return self.metrics.recompiles - before

    def _ensure_bucket(self, batch: int, dims: Tuple[int, ...]) -> Callable:
        """The bucket's compiled forward, compiled and counted at its
        first sight.  Called with ``_run_lock`` held."""
        key = (batch, tuple(dims))
        fwd = self._compiled.get(key)
        if fwd is None:
            t0 = time.perf_counter()
            fwd = compile_bucket(self._forward, Bucket(*key),
                                 self.input_dtype, self.device, self._pool)
            self.metrics.record_recompile(time.perf_counter() - t0)
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
        with self._run_lock:
            y = self._ensure_bucket(xp.shape[0], tuple(xp.shape[1:]))(x)
            return y.to(torch.float32, copy=True)

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
        req = _Request(x, fut, now, now + dl / 1e3 if dl is not None else None)
        try:
            self._rq.put_nowait(req)
        except queue.Full:
            self.metrics.inc_rejected()
            raise QueueFullError(
                f"request queue full ({self._rq.maxsize}); retry later"
            ) from None
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
            if self._log_every_s > 0:
                self._logger = threading.Thread(
                    target=self._log_loop, daemon=True,
                    name="bigdl-serve-log")
                self._logger.start()

    def _log_loop(self):
        while not self._log_stop.wait(self._log_every_s):
            logger.info(self.log_line())

    def close(self, drain: bool = True, timeout: float = 30.0):
        """Stop accepting requests and shut down.  ``drain=True`` serves
        everything already queued or in flight first; ``drain=False``
        fails queued requests with :class:`EngineClosedError`.
        Idempotent."""
        with self._close_lock:
            already, self._closed = self._closed, True
        if already:
            return
        self._log_stop.set()
        if self._logger is not None:
            self._logger.join(timeout)
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
        now = time.perf_counter()
        live: List[_Request] = []
        for r in batch:
            if self._discard:
                r.fut.set_exception(EngineClosedError("engine closed"))
            elif r.deadline is not None and now > r.deadline:
                self.metrics.inc_expired()
                r.fut.set_exception(DeadlineExceededError(
                    f"deadline expired {1e3 * (now - r.deadline):.1f}ms "
                    "before dispatch"))
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
                try:
                    xp = self.grid.pad_batch([r.x for r in chunk], dims, b,
                                             np.float32)
                    y = self._run(xp)
                except Exception as e:  # per-request delivery, keep serving
                    for r in chunk:
                        r.fut.set_exception(e)
                    continue
                self.metrics.record_batch(len(chunk), b)
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
            try:
                ynp = y.cpu().numpy()  # waits for the device
            except Exception as e:
                for r in chunk:
                    r.fut.set_exception(e)
                continue
            now = time.perf_counter()
            for i, r in enumerate(chunk):
                r.fut.set_result(self.grid.unpad(ynp[i], r.x.shape, dims))
                self.metrics.record_latency(now - r.t_submit)
            self.metrics.inc_completed(len(chunk))

    def log_line(self) -> str:
        return self.metrics.log_line()
