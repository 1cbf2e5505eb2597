"""Per-module times and device traces (counterpart of
bigdl_tpu/utils/profiling.py; BigDL's ``AbstractModule.getTimes`` and
``getTimesGroupByModuleType``, AbstractModule.scala:168-186).

* :func:`get_times` times each leaf module's forward and backward
  eagerly, in evaluation mode: a ``Sequential`` feeds each child its
  predecessor's output, and a ``Graph`` each node its inputs' outputs,
  so every leaf sees the shapes it sees in the model.  On the card a
  ``torch.cuda.synchronize()`` closes each timed call.  The numbers are
  upper bounds of what a CUDA graph of the model spends per layer (it
  launches without the host), but they rank the layers.
* :func:`trace` is a context manager around ``torch.profiler`` (the
  CPU, and the card when there is one) that writes the device
  trace into ``logdir`` as ``<host>_<pid>.pt.trace.json`` (Chrome trace
  JSON: each kernel by its CUDA function name, ``ui.perfetto.dev`` and
  TensorBoard's profile plugin load it) and, with ``host_spans``, the
  telemetry tracer's spans of the block as ``host_trace.json``.
* :func:`annotate` names a region of a traced block.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn.graph import Graph
from bigdl_tpu_torch.nn.module import Sequential
from bigdl_tpu_torch.utils.convert import subtree

__all__ = ["annotate", "format_times", "format_times_by_type", "get_times",
           "get_times_by_type", "get_times_grouped", "trace"]

Tensors = Dict[str, torch.Tensor]


def _sync(x):
    """Wait for the device when ``x`` holds a CUDA tensor."""
    while isinstance(x, (list, tuple)):
        x = x[0] if x else None
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _sub(flat: Optional[Tensors], key: str) -> Optional[Tensors]:
    return None if flat is None else subtree(flat, key)


def _call(module, params: Optional[Tensors], state: Optional[Tensors], x):
    if params is None and state is None:
        return module(x)
    return functional_call(module, {**(params or {}), **(state or {})},
                           (x,))


def _first(out):
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


def _time_leaf(module, params, state, x, backward: bool
               ) -> Tuple[float, float]:
    with torch.no_grad():
        _sync(_call(module, params, state, x))  # the first call may build
        t0 = time.perf_counter()
        out = _call(module, params, state, x)
        _sync(out)
        fwd_s = time.perf_counter() - t0
    own = dict(module.named_parameters()) if params is None else params
    bwd_s = 0.0
    if backward and own:
        leaves = {k: v.detach().requires_grad_(True) for k, v in own.items()}

        def grads():
            with torch.enable_grad():
                o = _first(functional_call(
                    module, {**leaves, **(state or {})}, (x,)))
                return torch.autograd.grad((o.float() ** 2).sum(),
                                           list(leaves.values()),
                                           allow_unused=True)

        grads()
        t0 = time.perf_counter()
        g = grads()
        _sync([t for t in g if t is not None] or [None])
        bwd_s = time.perf_counter() - t0
    return fwd_s, bwd_s


def get_times(model, params: Optional[Tensors] = None,
              state: Optional[Tensors] = None, x=None, *,
              backward: bool = True, _prefix: str = ""
              ) -> List[Tuple[str, str, float, float]]:
    """``[(path, type, forward_s, backward_s)]`` per leaf module, in
    evaluation mode (bigdl_tpu/utils/profiling.py:34-75).  ``params`` and
    ``state`` are the model's flat dicts (``named_parameters`` and
    ``named_buffers`` names) swapped in, or ``None`` for its own.  A leaf's
    backward is the gradient of ``sum(out ** 2)`` with respect to its
    parameters (0 without any).  Containers recurse; a path is the
    containers' names joined by ``/`` and the leaf's name."""
    top = not _prefix
    was_training = model.training
    if top:
        model.eval()
    try:
        rows: List[Tuple[str, str, float, float]] = []
        if isinstance(model, Sequential):
            cur = x
            for key in model.child_keys:
                child = model._modules[key]
                p, s = _sub(params, key), _sub(state, key)
                rows.extend(get_times(child, p, s, cur, backward=backward,
                                      _prefix=f"{_prefix}{model.name}/"))
                with torch.no_grad():
                    cur = _call(child, p, s, cur)
            return rows
        if isinstance(model, Graph):
            rows += _graph_times(model, params, state, x, backward,
                                 f"{_prefix}{model.name}/")
            return rows
        fwd_s, bwd_s = _time_leaf(model, params, state, x, backward)
        rows.append((f"{_prefix}{model.name}", type(model).__name__,
                     fwd_s, bwd_s))
        return rows
    finally:
        if top:
            model.train(was_training)


def _graph_times(graph: Graph, params, state, x, backward, prefix):
    """Each node of a graph timed on its inputs' outputs, in the graph's
    order (its ``forward``'s walk)."""
    inputs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    values = {node.id: inputs[i] for i, node in enumerate(graph.input_nodes)
              if i < len(inputs)}
    rows = []
    for node in graph._order:
        if node.module is None:
            continue
        key = graph._node_key[node.id]
        args = [values[p.id] for p in node.in_nodes]
        arg = args[0] if len(args) == 1 else tuple(args)
        child = graph._modules[key]
        p, s = _sub(params, key), _sub(state, key)
        rows.extend(get_times(child, p, s, arg, backward=backward,
                              _prefix=prefix))
        with torch.no_grad():
            values[node.id] = _call(child, p, s, arg)
    return rows


def get_times_grouped(model, params=None, state=None, x=None, **kw
                      ) -> Dict[str, Tuple[float, float, int]]:
    """BigDL's ``getTimesGroupByModuleType``: ``{type: (fwd_s, bwd_s,
    n)}``."""
    grouped: Dict[str, Tuple[float, float, int]] = {}
    for _, typ, f, b in get_times(model, params, state, x, **kw):
        pf, pb, n = grouped.get(typ, (0.0, 0.0, 0))
        grouped[typ] = (pf + f, pb + b, n + 1)
    return grouped


def get_times_by_type(model, params=None, state=None, x=None, **kw
                      ) -> Dict[str, Dict[str, float]]:
    """Per module type: the count, the total forward and backward
    seconds and their means per instance (AbstractModule.scala:180-186):
    ``{type: {"count", "fwd_total_s", "bwd_total_s", "fwd_mean_s",
    "bwd_mean_s"}}``."""
    out: Dict[str, Dict[str, float]] = {}
    for typ, (f, b, n) in get_times_grouped(model, params, state, x,
                                            **kw).items():
        out[typ] = {"count": n, "fwd_total_s": f, "bwd_total_s": b,
                    "fwd_mean_s": f / n, "bwd_mean_s": b / n}
    return out


def format_times_by_type(grouped: Dict[str, Dict[str, float]]) -> str:
    """A table of :func:`get_times_by_type`, the heaviest type first."""
    out = [f"{'type':28s} {'count':>5s} {'fwd ms':>9s} {'bwd ms':>9s} "
           f"{'fwd/ea':>9s} {'bwd/ea':>9s}"]
    rows = sorted(grouped.items(),
                  key=lambda kv: kv[1]["fwd_total_s"]
                  + kv[1]["bwd_total_s"], reverse=True)
    for typ, r in rows:
        out.append(
            f"{typ[:28]:28s} {r['count']:5d} "
            f"{r['fwd_total_s'] * 1e3:9.3f} {r['bwd_total_s'] * 1e3:9.3f} "
            f"{r['fwd_mean_s'] * 1e3:9.3f} {r['bwd_mean_s'] * 1e3:9.3f}")
    return "\n".join(out)


def format_times(rows) -> str:
    """A table of :func:`get_times`, one line per leaf."""
    out = [f"{'module':40s} {'type':28s} {'fwd ms':>9s} {'bwd ms':>9s}"]
    for name, typ, f, b in rows:
        out.append(f"{name[:40]:40s} {typ[:28]:28s} {f*1e3:9.3f} {b*1e3:9.3f}")
    return "\n".join(out)


@contextlib.contextmanager
def trace(logdir: str, host_spans: bool = True, xplane: bool = True):
    """``with profiling.trace(logdir):`` records the block with
    ``torch.profiler`` and writes its Chrome trace to ``logdir`` (see the
    module's docstring); ``xplane=False`` skips the profiler (the name is
    the JAX package's, whose device trace is an XPlane).  With
    ``host_spans`` the telemetry tracer is on for the block and its spans
    go to ``<logdir>/host_trace.json``; its state is restored after."""
    tracer = enter_t = None
    if host_spans:
        from bigdl_tpu_torch.telemetry import tracer as _ttr

        tracer = _ttr.get_tracer()
        was_enabled = tracer.enabled
        tracer.enable()
        enter_t = time.perf_counter()
    prof = None
    if xplane:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        yield
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"{socket.gethostname()}_{os.getpid()}"
                        ".pt.trace.json"))
        if tracer is not None:
            from bigdl_tpu_torch.telemetry import export as _texp

            spans = [s for s in tracer.spans() if s.t1 >= enter_t]
            _texp.write_chrome_trace(
                os.path.join(logdir, "host_trace.json"), tracer,
                spans=spans)
            tracer.enabled = was_enabled


def annotate(name: str):
    """A named region inside a traced block
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
