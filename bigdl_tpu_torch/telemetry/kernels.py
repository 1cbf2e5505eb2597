"""The hand-written kernels' telemetry hook: :func:`accounted` wraps a
kernel wrapper so that each call registers the kernel's route in the
program registry (``kernel:<name>``, static config ``route``: ``cuda``,
or ``plain`` for a CPU tensor) and, while a cost count runs, adds the
kernel's operations and bytes from its formula in place of whatever the
wrapper runs inside (telemetry/costmodel.py)."""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from bigdl_tpu_torch.telemetry import costmodel, programs


def accounted(name: str, x_of: Callable[..., torch.Tensor],
              cost: Callable[..., Tuple[float, float]]) -> Callable:
    """Decorator of the wrapper of kernel ``name``.  ``x_of`` and
    ``cost`` take the wrapper's arguments: ``x_of`` returns the tensor
    whose device picks the route, ``cost`` the kernel's ``(flops,
    bytes)`` (called only while a count runs, so a call with bad
    arguments raises the wrapper's own error)."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            x = x_of(*args, **kwargs)
            programs.record_route(
                name, "cuda" if x.device.type == "cuda" else "plain")
            with costmodel.kernel(lambda: cost(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return deco
