"""Fused matmul / 3x3 conv with a BatchNorm prologue and a statistics
epilogue: the forward half of bigdl_tpu/ops/pallas/fused_matmul.py.

``fused_matmul_bn(x, w, ps, pb, relu)`` computes
``y = [relu](x * ps + pb) @ w`` and the per-column ``ssum``/``ssq`` of
the f32 accumulator; ``fused_conv3x3_bn`` is the same for a 3x3 stride-1
SAME convolution over NHWC ``x`` with an HWIO ``w``.  Rounding points
follow the JAX kernels: the prologue runs in f32 and rounds to w's type
before the product, y rounds to x's type, and the statistics come from
the unrounded f32 accumulator.

Each wrapper takes one of two routes, decided by where ``x`` lies:

- a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/fused_matmul_bn.cu``, ``csrc/fused_conv3x3_bn.cu``) or raises;
- a CPU tensor runs the plain PyTorch version (``*_plain``), which the
  CPU tests hold against the JAX package and ``chip_smoke.py`` holds the
  kernels against on the card.

``LAUNCHES`` counts kernel launches per wrapper; the plain versions do
not count.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build

__all__ = ["fused_matmul_bn", "fused_conv3x3_bn", "fused_matmul_bn_plain",
           "fused_conv3x3_bn_plain", "bn_constants", "LAUNCHES",
           "reset_launches"]

Tensor = torch.Tensor
Stats = Tuple[Tensor, Tensor, Tensor]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"fused_matmul_bn": 0, "fused_conv3x3_bn": 0}
_launch_lock = threading.Lock()

_BM = 128  # row tile of the kernels (fused_gemm_bn.cuh BM)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def reset_launches():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _prologue(x: Tensor, ps: Optional[Tensor], pb: Optional[Tensor],
              relu: bool, w_dtype: torch.dtype) -> Tensor:
    """``[relu](x * ps + pb)`` in f32 over the last axis, rounded to the
    weight's type; ``x`` itself when there is no prologue."""
    if ps is None:
        return x
    uf = x.float() * ps.float()
    uf = uf + (pb.float() if pb is not None else 0.0)
    if relu:
        uf = torch.clamp_min(uf, 0.0)
    return uf.to(w_dtype)


def _stats(yf: Tensor) -> Tuple[Tensor, Tensor]:
    y2 = yf.reshape(-1, yf.shape[-1])
    return y2.sum(0), (y2 * y2).sum(0)


# --------------------------------------------------------------------------
# plain versions (mirror _xla_fwd and _conv3_xla)
# --------------------------------------------------------------------------
def fused_matmul_bn_plain(x: Tensor, w: Tensor,
                          prologue_scale: Optional[Tensor] = None,
                          prologue_bias: Optional[Tensor] = None,
                          relu: bool = True) -> Stats:
    """The plain PyTorch version of :func:`fused_matmul_bn`: the product
    in f32 from the (possibly bf16) operands, so it is exact products
    summed in f32, as ``preferred_element_type=f32`` is."""
    u = _prologue(x, prologue_scale, prologue_bias, relu, w.dtype)
    yf = torch.matmul(u.float(), w.float())
    return (yf.to(x.dtype),) + _stats(yf)


def fused_conv3x3_bn_plain(x: Tensor, w: Tensor,
                           prologue_scale: Optional[Tensor] = None,
                           prologue_bias: Optional[Tensor] = None,
                           relu: bool = True) -> Stats:
    """The plain PyTorch version of :func:`fused_conv3x3_bn`: prologue,
    then the zero padding, then an f32 convolution."""
    u = _prologue(x, prologue_scale, prologue_bias, relu, w.dtype)
    yf = F.conv2d(u.float().permute(0, 3, 1, 2),
                  w.float().permute(3, 2, 0, 1), padding=1)
    yf = yf.permute(0, 2, 3, 1)
    return (yf.to(x.dtype),) + _stats(yf)


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------
def _check_cuda_args(name: str, x: Tensor, w: Tensor, ps, pb,
                     widths) -> Tuple[Tensor, Tensor]:
    """Validate what the kernel takes; return the f32 ``(ps, pb)`` (ones
    and zeros when there is no prologue: the kernel then skips it)."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: x must be bfloat16 or float32, "
                        f"got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: w must have x's dtype ({x.dtype}), "
                        f"got {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"{name}: x on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    for v in widths:
        if v % 8:
            raise ValueError(f"{name}: channel widths must be multiples "
                             f"of 8 (16-byte vectors), got {tuple(widths)}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")
    k = widths[0]
    if ps is None:
        return _identity_prologue(x.device, k)
    ps = ps.to(device=x.device, dtype=torch.float32).contiguous()
    pb = (torch.zeros(k, device=x.device) if pb is None else
          pb.to(device=x.device, dtype=torch.float32).contiguous())
    if ps.shape != (k,) or pb.shape != (k,):
        raise ValueError(f"{name}: prologue scale/bias must be ({k},), "
                         f"got {tuple(ps.shape)}, {tuple(pb.shape)}")
    return ps, pb


_identity: dict = {}


def _identity_prologue(device: torch.device, k: int):
    """Cached (ones, zeros) stand-ins when there is no prologue (the
    kernel is told to skip it and never reads them)."""
    key = (device, k)
    if key not in _identity:
        _identity[key] = (torch.ones(k, device=device),
                          torch.zeros(k, device=device))
    return _identity[key]


def _launch(name: str, x: Tensor, w: Tensor, ps: Tensor,
            pb: Tensor, y: Tensor, m: int, n: int, dims, prologue: bool,
            relu: bool) -> Tuple[Tensor, Tensor]:
    """Allocate scratch and stats, launch on the current stream, count."""
    grid_m = -(-m // _BM)
    # one allocation: per-block partial sums and squares, then the stats
    buf = torch.empty((2 * grid_m + 2, n), device=x.device,
                      dtype=torch.float32)
    fn = getattr(_build.load(name), f"{name}_{_SUFFIX[x.dtype]}")
    if x.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: x is on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    p0 = buf.data_ptr()
    row = 4 * n
    err = fn(x.data_ptr(), w.data_ptr(), ps.data_ptr(), pb.data_ptr(),
             y.data_ptr(), p0, p0 + grid_m * row, p0 + 2 * grid_m * row,
             p0 + (2 * grid_m + 1) * row, *dims, int(prologue), int(relu),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    with _launch_lock:
        LAUNCHES[name] += 1
    return buf[2 * grid_m], buf[2 * grid_m + 1]


def fused_matmul_bn(x: Tensor, w: Tensor,
                    prologue_scale: Optional[Tensor] = None,
                    prologue_bias: Optional[Tensor] = None,
                    relu: bool = True) -> Stats:
    """``y = [relu](x * scale + bias) @ w`` plus per-column stats of the
    f32 accumulator (bigdl_tpu/ops/pallas/fused_matmul.py:433).

    ``x`` (M, K) and ``w`` (K, N) share a dtype; ``prologue_scale``/
    ``prologue_bias`` are (K,) f32 constants of the previous BatchNorm
    (:func:`bn_constants`), ``None`` feeding x straight to the product;
    ``relu`` applies only with a prologue.  Returns ``(y, ssum, ssq)``:
    y (M, N) in x's dtype, ssum/ssq (N,) f32.
    """
    m, k = x.shape
    kw, n = w.shape
    if k != kw:
        raise ValueError(f"fused_matmul_bn: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return fused_matmul_bn_plain(x, w, prologue_scale, prologue_bias,
                                     relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_bn: no kernel for {x.device}")
    ps, pb = _check_cuda_args("fused_matmul_bn", x, w, prologue_scale,
                              prologue_bias, (k, n))
    if m == 0:
        raise ValueError("fused_matmul_bn: x has no rows")
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    ssum, ssq = _launch("fused_matmul_bn", x, w, ps, pb, y, m, n,
                        (m, k, n), prologue_scale is not None, relu)
    return y, ssum, ssq


def fused_conv3x3_bn(x: Tensor, w: Tensor,
                     prologue_scale: Optional[Tensor] = None,
                     prologue_bias: Optional[Tensor] = None,
                     relu: bool = True) -> Stats:
    """3x3 stride-1 SAME conv with the same prologue/epilogue contract as
    :func:`fused_matmul_bn` (bigdl_tpu/ops/pallas/fused_matmul.py:859).
    ``x`` (B, H, W, C) NHWC, ``w`` (3, 3, C, Co) HWIO; returns
    ``(y (B, H, W, Co), ssum (Co,), ssq (Co,))``."""
    if tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"fused_conv3x3_bn: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    b, h, wd, c = x.shape
    co = w.shape[3]
    if x.device.type == "cpu":
        return fused_conv3x3_bn_plain(x, w, prologue_scale, prologue_bias,
                                      relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3_bn: no kernel for {x.device}")
    ps, pb = _check_cuda_args("fused_conv3x3_bn", x, w, prologue_scale,
                              prologue_bias, (c, co))
    m = b * h * wd
    if m == 0:
        raise ValueError("fused_conv3x3_bn: x has no pixels")
    y = torch.empty((b, h, wd, co), device=x.device, dtype=x.dtype)
    ssum, ssq = _launch("fused_conv3x3_bn", x, w, ps, pb, y, m, co,
                        (b, h, wd, c, co), prologue_scale is not None, relu)
    return y, ssum, ssq


def bn_constants(ssum: Tensor, ssq: Tensor, count, gamma: Tensor,
                 beta: Tensor, eps: float):
    """Per-channel ``(scale, bias, mean, var)`` in f32 so that
    ``y * scale + bias`` is BatchNorm (fused_matmul.py:936-948)."""
    mean = ssum / count
    var = torch.clamp_min(ssq / count - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma.float()
    bias = beta.float() - mean * scale
    return scale, bias, mean, var
