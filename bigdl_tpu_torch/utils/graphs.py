"""Compiled calls: CUDA graphs, the port's counterpart of ``jax.jit``.

The JAX package compiles its forwards and train steps (``jax.jit``, the
serving engine's per-bucket AOT compile, the donated train step).  The
port captures the same calls in CUDA graphs: :func:`compile` runs ``fn``
a few times to warm it, captures one call at the shapes of
``example_args`` and returns a :class:`Compiled` that replays it.  A
replay launches every kernel of the call from one host call, so a step
or a forward no longer waits on the host to enqueue its launches.

The rule is the device's, decided before anything runs: for tensors on a
CUDA device ``compile`` captures, and a capture that fails raises (there
is no eager fallback); for tensors on the CPU "compiled" is the eager
call, and ``compile`` returns ``fn`` itself.

The example arguments become the graph's static inputs: the graph reads
and writes those very tensors.  A call copies (and casts) each tensor
argument into its static input, except one that is that input already,
and replays.  A caller that wants buffers of its own passes fresh ones
(the serving engine, ``evaluate``); the train step passes its parameter,
state and optimizer trees, which the captured step updates in place (the
counterpart of donation).  The warm-up calls leave every argument as it
was: ``compile`` puts the tensors back afterwards.

The outputs are the graph's static outputs.  The next replay overwrites
them, and so may a replay of another graph captured into the same memory
pool (:func:`new_pool`): read or copy them before that.  A ``Compiled``,
and all graphs of one pool, are called from one thread at a time.

``COUNTS`` adds up, over the process, the captures, their seconds and
the replays, as the kernels' ``LAUNCHES`` count launches.  A kernel
wrapper counts a launch when the host enqueues it, so a capture counts
each kernel of the call once (and each warm-up call does too), while a
replay adds nothing to ``LAUNCHES`` and one to ``COUNTS["replays"]``.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

__all__ = ["COUNTS", "Cache", "Compiled", "WARMUP", "clone", "compile",
           "donate", "leaves", "new_pool", "prepare", "reset_counts",
           "signature"]

#: warm-up calls before a capture (lazy initialisation: cuBLAS handles
#: and workspaces, cuDNN plans, the kernels' shared-memory attributes,
#: the allocator's blocks)
WARMUP = 3

#: captures, their seconds and replays since the last :func:`reset_counts`
COUNTS = {"captures": 0, "capture_seconds": 0.0, "replays": 0}
_lock = threading.Lock()


def reset_counts():
    with _lock:
        COUNTS.update(captures=0, capture_seconds=0.0, replays=0)


def leaves(tree: Any, out: Optional[List[Any]] = None) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples, in order."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for v in tree.values():
            leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            leaves(v, out)
    else:
        out.append(tree)
    return out


def clone(tree: Any) -> Any:
    """A copy of a tree whose tensors are fresh copies: static inputs of
    a caller's own."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v) for v in tree)
    return tree.clone() if torch.is_tensor(tree) else tree


def signature(tree: Any):
    """A hashable key of a tree: its structure, its tensors' shapes,
    types and devices, and its other leaves' values.  Calls with equal
    signatures can replay one graph."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, signature(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(signature(v) for v in tree))
    if torch.is_tensor(tree):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    return ("const", tree)


def _copy_tree(dst: Any, src: Any):
    """Copy tree ``src`` into the tensors of tree ``dst`` (dicts by key,
    lists and tuples by position); other leaves of ``dst`` stay."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_tree(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    elif torch.is_tensor(dst):
        dst.copy_(src)


def donate(fn: Callable, out_at: Union[None, int, Tuple[int, ...]] = None
           ) -> Callable:
    """``fn`` with its leading arguments donated, the counterpart of
    ``donate_argnums``: the new value of argument ``a`` is the output at
    ``out_at[a]`` (an int: of argument 0; ``None``: ``fn``'s whole output
    is argument 0's).  It is copied into the argument's tensors, and the
    argument is returned in its place.  Compiled, a call so updates the
    graph's static inputs, and a caller that passes them back copies
    nothing."""
    at = (out_at,) if isinstance(out_at, int) else out_at

    def donated(*args):
        out = fn(*args)
        with torch.no_grad():
            if at is None:
                _copy_tree(args[0], out)
                return args[0]
            out = list(out)
            for a, j in enumerate(at):
                _copy_tree(args[a], out[j])
                out[j] = args[a]
        return tuple(out)

    return donated


class Cache(dict):
    """Compiled calls cached on a module, by :func:`signature`; a copy of
    the module starts with an empty one (a CUDA graph is not copied)."""

    def __deepcopy__(self, memo):
        return Cache()


def new_pool():
    """A memory pool for graphs replayed one after another: a bucket
    grid shares one, so it does not hold an activation pool per bucket
    (capture the largest first)."""
    return torch.cuda.graph_pool_handle()


def prepare(device: torch.device):
    """What a capture may not do, done before it: build and load every
    kernel library (``nvcc`` cannot run inside a capture) and allocate
    kernel 7's split-K workspace on ``device``."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.int8_matmul import _workspace

    for name in _build.SOURCES:
        _build.load(name)
    _workspace(device)


_capturing = 0  # captures in progress, in any thread
_collector_was_on = True
_collector_lock = threading.Lock()


@contextlib.contextmanager
def _collector_off():
    """Python's cyclic collector off while any capture runs.  A dead
    cycle holding an old graph, collected inside a capture, would destroy
    that graph there: an API call a capture does not permit, which
    invalidates it.  The first capture to start collects the dead cycles
    first; the last to end turns the collector back on if it was on."""
    global _capturing, _collector_was_on
    with _collector_lock:
        if _capturing == 0:
            gc.collect()
            _collector_was_on = gc.isenabled()
            gc.disable()
        _capturing += 1
    try:
        yield
    finally:
        with _collector_lock:
            _capturing -= 1
            if _capturing == 0 and _collector_was_on:
                gc.enable()


def _launches() -> Dict[str, int]:
    """The hand-written kernels' launch counters, merged."""
    from bigdl_tpu_torch.ops import flash_attention, fused_matmul, int8_matmul

    return {**fused_matmul.LAUNCHES, **flash_attention.LAUNCHES,
            "int8_matmul": int8_matmul.LAUNCHES["int8_matmul"]}


class Compiled:
    """One call of ``fn`` captured in a CUDA graph; see the module's
    docstring.  ``captures`` is 1, ``capture_seconds`` the time the
    warm-up and the capture took, ``replays`` the calls since, and
    ``launches`` the hand-written kernels the capture recorded (each
    replay runs them again), by name."""

    def __init__(self, fn: Callable, example_args: tuple, pool=None):
        self._static = leaves(example_args)
        tensors = [t for t in self._static if torch.is_tensor(t)]
        if not tensors:
            raise ValueError("compile: the example arguments hold no tensor")
        device = tensors[0].device
        t0 = time.perf_counter()
        prepare(device)
        saved = [t.clone() for t in tensors]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*example_args)
            with torch.no_grad():  # undo the warm-up's writes
                for t, s in zip(tensors, saved):
                    t.copy_(s)
        torch.cuda.current_stream(device).wait_stream(side)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        before = _launches()
        # captured on the warm-up's stream, one per capture: captures in
        # two threads (a first-sight bucket and a pytree forward) never
        # share a capture stream
        with _collector_off(), torch.cuda.graph(
                self.graph, pool=pool, stream=side,
                capture_error_mode="thread_local"):
            self.outputs = fn(*example_args)
        self.launches = {k: n - before[k] for k, n in _launches().items()
                         if n != before[k]}
        torch.cuda.synchronize(device)
        self.captures, self.replays = 1, 0
        self.capture_seconds = time.perf_counter() - t0
        with _lock:
            COUNTS["captures"] += 1
            COUNTS["capture_seconds"] += self.capture_seconds

    def __call__(self, *args):
        """Copy ``args`` into the static inputs, replay, and return the
        static outputs (valid until the next replay of the pool)."""
        given = leaves(args)
        if len(given) != len(self._static):
            raise ValueError(f"compiled call: {len(given)} argument "
                             f"leaves, captured with {len(self._static)}")
        with torch.no_grad():
            for a, s in zip(given, self._static):
                if a is s:
                    continue
                if torch.is_tensor(s):
                    if not torch.is_tensor(a) or a.shape != s.shape:
                        raise ValueError(
                            f"compiled call: got {getattr(a, 'shape', a)!r}"
                            f" where the capture had {tuple(s.shape)}")
                    s.copy_(a)
                elif a != s:
                    raise ValueError(f"compiled call: constant {a!r} where "
                                     f"the capture had {s!r}")
        self.graph.replay()
        self.replays += 1
        with _lock:
            COUNTS["replays"] += 1
        return self.outputs


def compile(fn: Callable, example_args: tuple, pool=None) -> Callable:
    """``fn`` captured at the shapes of ``example_args`` when they lie on
    a CUDA device (a :class:`Compiled`), ``fn`` itself on the CPU.
    ``pool`` is a shared memory pool (:func:`new_pool`) or ``None`` for
    the graph's own."""
    first = next((t for t in leaves(example_args)
                  if torch.is_tensor(t)), None)
    if first is None or first.device.type != "cuda":
        return fn
    return Compiled(fn, example_args, pool)
