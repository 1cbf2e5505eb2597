"""The forward the serving engine runs per bucket, its compile, and a
check that every declared bucket compiles (counterpart of
bigdl_tpu/serving/warmup.py:22-80).

The JAX package proves its grid offline by compiling each bucket against
a deviceless TPU topology (``deviceless_bucket_check``).  CUDA has no
deviceless target, so :func:`bucket_program_check` does what
``decode_program_check`` does for the decode programs: it compiles each
declared bucket for real, on the card a capture in a throwaway memory
pool (its forward run and checked for finite values), on the CPU an
eager call.  A shape-only run on the ``meta`` device was the other way:
it would need a third route in every kernel wrapper, and it would prove
nothing of what can fail on the card (a kernel's build, its launch, a
capture).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.serving.bucketing import Bucket, BucketGrid
from bigdl_tpu_torch.utils import graphs


def build_forward(model: torch.nn.Module) -> Callable:
    """Eval-mode forward under ``torch.inference_mode()``: the eager body
    that :func:`compile_bucket` compiles."""
    model.eval()

    def fwd(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return fwd


def bucket_struct(bucket: Bucket, dtype: torch.dtype) -> torch.Tensor:
    """A bucket's padded input batch as shape and type alone (a tensor on
    the ``meta`` device, the counterpart of ``jax.ShapeDtypeStruct``)."""
    return torch.empty((bucket.batch,) + tuple(bucket.dims), dtype=dtype,
                       device="meta")


def compile_bucket(forward: Callable, bucket: Bucket, dtype: torch.dtype,
                   device: torch.device, pool=None, count=None) -> Callable:
    """``forward`` compiled for one bucket's padded ``(batch,) + dims``
    batch of ``dtype`` (``utils/graphs.py``): on the card a CUDA graph
    whose static input is a zero batch of its own, captured into
    ``pool``; on the CPU the eager forward.  ``count`` (a
    ``telemetry.costmodel.Count``) is filled from one eager call."""
    x = torch.zeros(bucket_struct(bucket, dtype).shape, dtype=dtype,
                    device=device)
    return graphs.compile(forward, (x,), pool, count)


def bucket_program_check(model: torch.nn.Module, grid: BucketGrid,
                         dtype: torch.dtype = torch.float32,
                         log: Optional[Callable[[str], None]] = None,
                         device: DeviceLike = None) -> int:
    """Compile and run every declared bucket of ``grid`` for ``model``
    (on the card each captured into one throwaway pool); returns the
    failure count, ``log`` receiving one line per bucket."""
    device = resolve_device(device)
    log = log or (lambda s: None)
    forward = build_forward(model.to(device))
    pool = graphs.new_pool() if device.type == "cuda" else None
    failures = 0
    for bucket in grid.declared_buckets():
        tag = f"bucket {bucket.batch}x{'x'.join(map(str, bucket.dims))}"
        try:
            fwd = compile_bucket(forward, bucket, dtype, device, pool)
            y = fwd(torch.zeros(bucket_struct(bucket, dtype).shape,
                                dtype=dtype, device=device))
            if not bool(torch.isfinite(y.float()).all()):
                raise FloatingPointError("non-finite output")
            log(f"{tag}: OK")
        except Exception as e:
            failures += 1
            log(f"{tag}: FAIL {str(e)[:200]}")
    return failures
