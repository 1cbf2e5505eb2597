"""Concurrent inference service: the facade over the serving engine
(counterpart of bigdl_tpu/optim/prediction_service.py; reference
optim/PredictionService.scala).

* ``predict(x)``: thread-safe prediction of a batched input (at most
  ``n_concurrent`` callers at once), through the engine's bucket grid;
* ``predict_async(x)``: one sample, micro-batched by the engine; returns
  a single-slot queue that receives the result or the exception that
  failed the request;
* ``predict_serialized``: bytes in, bytes out.  A plain array travels as
  an npz with an ``input`` (request) or ``output`` (response) key; any
  other pytree (dict, tuple, list) in the npz pytree codec of
  :mod:`bigdl_tpu_torch.utils.serialization`.  Both are the JAX
  package's encodings byte for byte, so clients of either serve against
  either;
* ``close()`` and the context manager stop the engine.

``model`` is a module of the port and ``variables``, when given, a JAX
``{"params", "state"}`` tree loaded into it by name.  The remaining
keywords go to :class:`~bigdl_tpu_torch.serving.ServingEngine`
(``device``, ``input_dtype``, ``pipeline_depth``, ...); ``buckets``
declares the padded shape grid and warms it up.
"""
from __future__ import annotations

import io
import queue
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.warmup import build_forward
from bigdl_tpu_torch.utils import graphs
from bigdl_tpu_torch.utils.serialization import dumps_pytree, loads_pytree

__all__ = ["PredictionService"]


def _derived_batch_sizes(max_batch: int) -> tuple:
    """A small power-of-4 ladder below ``max_batch``, so a short backlog
    does not pad to the largest batch."""
    sizes = {1, max(1, int(max_batch))}
    b = int(max_batch)
    while b > 1:
        b //= 4
        sizes.add(max(1, b))
    return tuple(sorted(sizes))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class PredictionService:
    def __init__(self, model: torch.nn.Module, variables: Optional[dict] = None,
                 n_concurrent: int = 4,
                 batch_window_ms: float = 0.0,
                 max_batch: int = 32,
                 buckets: Optional[Sequence[Sequence[int]]] = None,
                 batch_sizes: Optional[Sequence[int]] = None,
                 **engine_kwargs: Any):
        self._sem = threading.Semaphore(n_concurrent)
        engine_kwargs.setdefault("warmup", buckets is not None)
        self.engine = ServingEngine(
            model, variables,
            buckets=buckets,
            batch_sizes=(tuple(batch_sizes) if batch_sizes is not None
                         else _derived_batch_sizes(max_batch)),
            batch_window_ms=batch_window_ms,
            **engine_kwargs)
        self.model = self.engine.model
        self._forward = build_forward(self.model)
        # one compiled forward per input structure and shapes (the JAX
        # service's jitted _pytree_fwd), in a pool of their own, replayed
        # and read back one call at a time
        self._pytree_fwd: dict = {}
        self._pytree_pool = (graphs.new_pool()
                             if self.engine.device.type == "cuda" else None)
        self._pytree_lock = threading.Lock()

    @property
    def metrics(self):
        return self.engine.metrics

    # -- direct path ---------------------------------------------------
    def predict(self, x) -> np.ndarray:
        """Thread-safe prediction of a batched input (axis 0 = batch)."""
        with self._sem:
            return np.asarray(self.engine.predict_batch(np.asarray(x)))

    # -- micro-batching path -------------------------------------------
    def predict_async(self, x) -> "queue.Queue":
        """Queue a single sample (no batch dim); the result, or the
        exception that failed it, arrives on the returned single-slot
        queue (check ``isinstance(item, Exception)``)."""
        out: queue.Queue = queue.Queue(1)
        fut = self.engine.submit(x)
        fut.add_done_callback(
            lambda f: out.put(f._exc if f._exc is not None else f._value))
        return out

    # -- lifecycle -----------------------------------------------------
    def close(self, drain: bool = True):
        self.engine.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- serialized request/response -----------------------------------
    def predict_serialized(self, request: bytes) -> bytes:
        """Serialized activity in, serialized prediction out.  Accepts
        the single-array encoding (npz ``input`` key) and the pytree
        codec (dict/tuple/nested activities)."""
        x = self.decode_request(request)
        if isinstance(x, np.ndarray):
            return self.encode_response(self.predict(x))
        return self.encode_response(self._predict_pytree(x))

    def _predict_pytree(self, x):
        """General-activity path: a multi-input model (tables, tuples)
        runs one compiled forward over the whole tree, unbucketed, one
        per signature of the tree."""
        eng = self.engine

        def to_device(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(eng.device)
            return t.to(eng.input_dtype) if t.is_floating_point() else t

        xt = _tree_map(to_device, x)
        key = graphs.signature(xt)
        with self._sem, self._pytree_lock:
            fwd = self._pytree_fwd.get(key)
            if fwd is None:
                fwd = self._pytree_fwd[key] = graphs.compile(
                    self._forward, (graphs.clone(xt),), self._pytree_pool)
            return _tree_map(lambda t: t.float().cpu().numpy(), fwd(xt))

    @staticmethod
    def encode_request(x) -> bytes:
        """An array travels in the npz ``input`` encoding; any other
        pytree in the pytree codec."""
        if isinstance(x, np.ndarray) or np.isscalar(x):
            buf = io.BytesIO()
            np.savez_compressed(buf, input=np.asarray(x))
            return buf.getvalue()
        return dumps_pytree(x)

    @staticmethod
    def decode_request(request: bytes):
        with np.load(io.BytesIO(request)) as z:
            if "__header__" not in z.files:
                return z["input"]
        return loads_pytree(request)

    @staticmethod
    def encode_response(y) -> bytes:
        if isinstance(y, np.ndarray):
            buf = io.BytesIO()
            np.savez_compressed(buf, output=y)
            return buf.getvalue()
        return dumps_pytree(y)

    @staticmethod
    def decode_response(resp: bytes):
        with np.load(io.BytesIO(resp)) as z:
            if "__header__" not in z.files:
                return z["output"]
        return loads_pytree(resp)
