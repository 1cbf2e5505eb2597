"""Background prefetch, the async training loop's input stage
(counterpart of bigdl_tpu/dataset/prefetch.py:33-160).

* :func:`prefetch_depth` reads ``BIGDL_TPU_PREFETCH_DEPTH`` (default 2).
* :class:`Prefetcher` pulls from an iterator on a daemon thread, keeps
  the order, holds at most ``depth`` items ready, raises a producer's
  exception in the consumer after the items before it, and stops
  cleanly on ``close()``, also while the producer is blocked on a full
  queue.
* :class:`DevicePrefetcher` is a :class:`Prefetcher` whose ``place``
  runs on the producer thread and puts each batch on the device.  On a
  CUDA device it runs on a side stream of its own, so that the copy to
  the card overlaps the step running on the loop's stream: :func:`to_device`
  pins the host array and copies it with ``non_blocking=True``, and an
  event recorded after ``place`` travels with the item.  The consumer
  makes its current stream wait on that event before it hands the batch
  on, and marks every tensor of the batch as used on that stream
  (``record_stream``), so the allocator does not give the batch's memory
  to the producer's next copy before the step has read it.

The producer records a ``prefetch_item`` span per item (pull, transform
and placement) correlated ``item:<index>`` on the shared timeline
(``telemetry/tracer.py``), so a trace shows which batch the loop's
``data_stall`` waited on.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from bigdl_tpu_torch.telemetry.tracer import CAT_DATA, get_tracer

__all__ = ["DEFAULT_DEPTH", "DevicePrefetcher", "Prefetcher",
           "prefetch_depth", "to_device"]

DEFAULT_DEPTH = 2


def prefetch_depth(default: int = DEFAULT_DEPTH) -> int:
    """The configured prefetch depth (``BIGDL_TPU_PREFETCH_DEPTH``)."""
    try:
        return max(1, int(os.environ.get("BIGDL_TPU_PREFETCH_DEPTH",
                                         default)))
    except ValueError:
        return default


def to_device(a: Any, device: torch.device, non_blocking: bool = False):
    """A batch's numpy array or host tensor (or a list of them) as
    tensors on ``device``; with ``non_blocking`` on a CUDA device, copied
    from pinned host memory without waiting for the copy."""
    if isinstance(a, (list, tuple)):
        return [to_device(v, device, non_blocking) for v in a]
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    if non_blocking and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Prefetcher:
    """An iterator over ``it`` whose items are produced on a background
    thread, up to ``depth`` ahead of the consumer.  ``transform`` runs
    on that thread on each item; ``timer`` gets the seconds each item
    took to produce (pull and transform)."""

    def __init__(self, it: Iterator, depth: int = DEFAULT_DEPTH,
                 transform: Optional[Callable[[Any], Any]] = None,
                 timer: Optional[Callable[[float], None]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._done = object()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._finished = False

        def run():
            tracer = get_tracer()
            idx = 0
            try:
                t0 = time.perf_counter()
                for item in it:
                    if self._stop.is_set():
                        return
                    if transform is not None:
                        item = transform(item)
                    if timer is not None:
                        timer(time.perf_counter() - t0)
                    tracer.add_span("prefetch_item", CAT_DATA, t0,
                                    time.perf_counter(), corr=f"item:{idx}")
                    idx += 1
                    # checked again before the put, so that close() (which
                    # drains the queue) never leaves the producer blocked
                    if self._stop.is_set():
                        return
                    self._q.put(item)
                    t0 = time.perf_counter()
            except BaseException as e:  # raised in the consumer
                self._error = e
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
                self._q.put(self._done)

        self._t = threading.Thread(target=run, daemon=True,
                                   name="bigdl-prefetch")
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0):
        """Stop the producer; safe to call more than once and while the
        producer is inside an item or blocked on a full queue."""
        self._stop.set()
        self._finished = True
        deadline = time.monotonic() + timeout
        while self._t.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.005)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _tensors(tree: Any):
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


class DevicePrefetcher(Prefetcher):
    """A :class:`Prefetcher` whose producer finishes each item with
    ``place(item)``, the placement on ``device`` (a CUDA device: on a
    side stream, the item handed over behind an event; see the module's
    docstring).  ``depth`` defaults to :func:`prefetch_depth`."""

    def __init__(self, it, place: Callable[[Any], Any],
                 depth: Optional[int] = None,
                 timer: Optional[Callable[[float], None]] = None,
                 device: Optional[torch.device] = None):
        self._device = device
        transform = place
        if device is not None and device.type == "cuda":
            side = torch.cuda.Stream(device)

            def transform(item):
                with torch.cuda.device(device), torch.cuda.stream(side):
                    placed = place(item)
                    ready = torch.cuda.Event()
                    ready.record(side)
                return placed, ready

        super().__init__(it, depth=prefetch_depth() if depth is None
                         else depth, transform=transform, timer=timer)

    def __next__(self):
        item = super().__next__()
        if self._device is None or self._device.type != "cuda":
            return item
        placed, ready = item
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(ready)
        for t in _tensors(placed):
            if t.is_cuda:
                t.record_stream(stream)
        return placed
