"""Int8 x int8 -> int32 matmul with a fused dequant epilogue:
bigdl_tpu/ops/pallas/int8_matmul.py.

``int8_matmul_dequant(x_q, w_q, scale_row, out_dtype)`` computes

    y[m, n] = (sum_k x_q[m, k] * w_q[k, n]) * scale_row[n]

for ``(M, K)`` and ``(K, N)`` int8 operands, with an f32 ``scale_row`` of
shape ``(N,)`` or ``(1, N)`` (the activation's per-tensor scale folded
into the weight's per-column scale), cast once to ``out_dtype`` (bf16 or
f32).  It takes one of two routes, decided by where ``x_q`` lies:

- a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/int8_matmul.cu``) or raises.  The kernel takes every M, K and
  N (it zero-fills the ragged edges itself) and ``w_q`` with any
  strides, so the transposed view ``k_q.T`` of an int8 key cache passes
  without a copy.  There is no shape routing: the reference sends shapes
  with ``K % 128``, ``N % 128`` or ``K * N > 8M`` to XLA, a rule of the
  TPU's VMEM that this kernel does not have;
- a CPU tensor runs :func:`int8_matmul_dequant_plain`.

The plain version sums in f64, which holds every int8 product sum below
2**53 exactly (CUDA has no integer ``mm``, and ``torch.matmul`` of int8
tensors wraps around), then rounds to f32 as XLA's s32 -> f32 does, so
the kernel and the plain version agree bit for bit.

``LAUNCHES`` counts kernel launches; the plain version does not count.
:func:`record_calls` collects the ``(M, K, N)`` of every call, on either
route, while it is open.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List

import torch

from bigdl_tpu_torch.ops import _build

__all__ = ["int8_matmul_dequant", "int8_matmul_dequant_plain", "LAUNCHES",
           "reset_launches", "record_calls"]

Tensor = torch.Tensor

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"int8_matmul": 0}
_lock = threading.Lock()
_recorders: List[list] = []
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def reset_launches():
    with _lock:
        LAUNCHES["int8_matmul"] = 0


@contextlib.contextmanager
def record_calls() -> Iterator[list]:
    """Collect ``(M, K, N, w_q.stride())`` of every call made while the
    context is open."""
    calls: list = []
    with _lock:
        _recorders.append(calls)
    try:
        yield calls
    finally:
        with _lock:
            _recorders.remove(calls)


def _check(x_q: Tensor, w_q: Tensor, scale_row: Tensor, out_dtype):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul_dequant: x_q and w_q must be int8, got "
                        f"{x_q.dtype} and {w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_matmul_dequant: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} do not chain")
    if scale_row.numel() != w_q.shape[1]:
        raise ValueError(f"int8_matmul_dequant: scale_row has "
                         f"{scale_row.numel()} values for N = {w_q.shape[1]}")
    if out_dtype not in _SUFFIX:
        raise TypeError(f"int8_matmul_dequant: out_dtype must be bfloat16 or "
                        f"float32, got {out_dtype}")


def int8_matmul_dequant_plain(x_q: Tensor, w_q: Tensor, scale_row: Tensor,
                              out_dtype=torch.bfloat16) -> Tensor:
    """The plain PyTorch version of the kernel: the exact integer sum
    (in f64), rounded to f32, times ``scale_row`` in f32, cast once."""
    acc = x_q.double() @ w_q.double()
    return (acc.float() * scale_row.reshape(-1).float()).to(out_dtype)


def _int8_matmul_cuda(x_q: Tensor, w_q: Tensor, scale_row: Tensor,
                      out_dtype) -> Tensor:
    name = "int8_matmul"
    for t in (w_q, scale_row):
        if t.device != x_q.device:
            raise ValueError(f"{name}: x_q on {x_q.device} but an operand on "
                             f"{t.device}")
    if x_q.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: x_q is on {x_q.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    m, k = x_q.shape
    n = w_q.shape[1]
    if m == 0 or k == 0 or n == 0:
        raise ValueError(f"{name}: empty operand {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)}")
    if x_q.stride(1) != 1:  # the activation: rows must be k-contiguous
        x_q = x_q.contiguous()
    scale = scale_row.reshape(-1).to(torch.float32).contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    fn = getattr(_build.load(name),
                 f"int8_matmul_dequant_{_SUFFIX[out_dtype]}")
    err = fn(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
             m, k, n, x_q.stride(0), w_q.stride(0), w_q.stride(1),
             torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check(err, name)
    with _lock:
        LAUNCHES[name] += 1
    return y


def int8_matmul_dequant(x_q: Tensor, w_q: Tensor, scale_row: Tensor,
                        out_dtype=torch.bfloat16) -> Tensor:
    """``(M, K) s8 @ (K, N) s8 -> (M, N) out_dtype``, scaled per column:
    the kernel for a CUDA tensor, the plain version for a CPU tensor;
    any other device raises."""
    _check(x_q, w_q, scale_row, out_dtype)
    if _recorders:
        with _lock:
            for calls in _recorders:
                calls.append((x_q.shape[0], x_q.shape[1], w_q.shape[1],
                              tuple(w_q.stride())))
    if x_q.device.type == "cpu":
        return int8_matmul_dequant_plain(x_q, w_q, scale_row, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul_dequant: no kernel for {x_q.device}")
    return _int8_matmul_cuda(x_q, w_q, scale_row, out_dtype)
