"""Serving engine: bucketed batching with pipelined dispatch
(counterpart of bigdl_tpu/serving/engine.py:142-528).

* Requests (float32 numpy samples, no batch dim) are padded onto a
  :class:`~bigdl_tpu_torch.serving.bucketing.BucketGrid`; ``warmup()``
  runs one zero batch per declared bucket, which builds the kernels and
  warms cuDNN, so steady-state traffic never waits on a first sight.
* A dispatcher thread groups queued requests by bucket, pads them,
  copies the batch to the device, casts it to ``input_dtype`` there and
  enqueues the forward without waiting; a drain thread copies results
  to the host, crops them and resolves the futures.  At most
  ``pipeline_depth`` batches are in flight.
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
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.serving.bucketing import Bucket, BucketGrid
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.warmup import build_forward

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

    def set_result(self, value):
        self._value = value
        self._ev.set()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._ev.set()


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
        self._seen_buckets: set = set()
        self._first_sight_lock = threading.Lock()

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

    def warmup(self) -> int:
        """Run one zero batch per declared bucket; returns how many
        buckets were seen for the first time (0 on a re-warm)."""
        before = self.metrics.first_sights
        for bucket in self.grid.declared_buckets():
            self._ensure_bucket(bucket.batch, bucket.dims)
        return self.metrics.first_sights - before

    def _ensure_bucket(self, batch: int, dims: Tuple[int, ...]):
        key = (batch, tuple(dims))
        if key in self._seen_buckets:
            return
        with self._first_sight_lock:
            if key in self._seen_buckets:
                return
            self._forward(self._to_device(
                np.zeros((batch,) + tuple(dims), np.float32))).cpu()
            self.metrics.record_first_sight()
            self._seen_buckets.add(key)

    def _to_device(self, xp: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(xp, dtype=np.float32))
        return x.to(self.device).to(self.input_dtype)

    def _run(self, xp: np.ndarray) -> torch.Tensor:
        """Enqueue the forward of a padded bucket batch; returns the
        float32 output on the device (not yet waited for)."""
        self._ensure_bucket(xp.shape[0], tuple(xp.shape[1:]))
        return self._forward(self._to_device(xp)).float()

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
