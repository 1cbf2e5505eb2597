"""Fused matmul / 3x3 conv with a BatchNorm prologue and a statistics
epilogue, forward and backward: bigdl_tpu/ops/pallas/fused_matmul.py.

``fused_matmul_bn(x, w, ps, pb, relu)`` computes
``y = [relu](x * ps + pb) @ w`` and the per-column ``ssum``/``ssq`` of
the f32 accumulator; ``fused_conv3x3_bn`` is the same for a 3x3 stride-1
SAME convolution over NHWC ``x`` with an HWIO ``w``.  Both are
``torch.autograd.Function``s (the JAX ``custom_vjp``s ``_fused`` and
``_conv3``) whose backward takes the cotangents of all three outputs:

- 1x1: ``dx, d_ps, d_pb`` from :func:`fused_matmul_bn_dgrad` and ``dW``
  from :func:`fused_matmul_bn_wgrad` (``_fused_bwd``);
- 3x3: ``dx, d_ps, d_pb`` from :func:`fused_conv3x3_bn_dgrad` and ``dW``
  from a library convolution, as the JAX package computes it in XLA
  (``_conv3_bwd``, its Pallas-dgrad branch).

Rounding points follow the JAX kernels: the prologue runs in f32 and
rounds to the weight's type before a product, y rounds to x's type, the
statistics come from the unrounded f32 accumulator; in the backward
``ytot = dy + dssum + 2 * y * dssq`` is formed in f32 from the saved
(rounded) y and rounded before its product, the ReLU mask is
``x * ps + pb > 0`` in f32, and ``d_ps``/``d_pb``/``dx`` come from the
unrounded f32 gradient.

Each kernel wrapper takes one of two routes, decided by where ``x`` lies:

- a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/fused_matmul_bn*.cu``, ``csrc/fused_conv3x3_bn*.cu``) or raises;
- a CPU tensor runs the plain PyTorch version (``*_plain``), which the
  CPU tests hold against the JAX package and ``chip_smoke.py`` holds the
  kernels against on the card.

The kernels read channels in 16-byte vectors, so every channel width
must be a multiple of 8.  A call on the card with any other width runs
the kernel on operands zero-padded to the next multiple of 8 and slices
the outputs back (:func:`_padded_forward`, :func:`_padded_dgrad`,
:func:`_padded_wgrad`): a padded input channel is 0 after the prologue
(``relu(0 * 0 + 0)``) and meets a zero row of the weight; a padded output
channel has zero y, ssum and ssq, and in the backward zero dy, y and
statistics cotangents, so its ``ytot`` is 0 and adds nothing to dx or dW.

``LAUNCHES`` counts kernel launches per wrapper and ``COPIES`` the
calls whose operands were copied to be padded; the plain versions do not
count.  ``COSTS`` holds each kernel's ``(operations, bytes)`` formula,
which the cost model adds to a counted call (``telemetry/kernels.py``)
and ``chip_smoke.py`` divides by the card's peaks for its bounds.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.telemetry.kernels import accounted

__all__ = ["fused_matmul_bn", "fused_conv3x3_bn", "fused_matmul_bn_plain",
           "fused_conv3x3_bn_plain", "fused_matmul_bn_dgrad",
           "fused_matmul_bn_wgrad", "fused_conv3x3_bn_dgrad",
           "fused_matmul_bn_dgrad_plain", "fused_matmul_bn_wgrad_plain",
           "fused_conv3x3_bn_dgrad_plain", "conv3x3_wgrad", "bn_constants",
           "COPIES", "COSTS", "LAUNCHES", "reset_launches"]

Tensor = torch.Tensor
Stats = Tuple[Tensor, Tensor, Tensor]
Dgrad = Tuple[Tensor, Optional[Tensor], Optional[Tensor]]

#: kernel launches per wrapper since the last :func:`reset_launches`,
#: counted when the host enqueues them: a CUDA graph capture counts each
#: launch once, and a replay of the graph adds nothing
LAUNCHES = {"fused_matmul_bn": 0, "fused_conv3x3_bn": 0,
            "fused_matmul_bn_dgrad": 0, "fused_matmul_bn_wgrad": 0,
            "fused_conv3x3_bn_dgrad": 0}
#: calls on the card whose channel widths were padded (their operands
#: copied), since the last :func:`reset_launches`
COPIES = {"fused_channel_pad": 0}
_launch_lock = threading.Lock()

_BM = 128  # row tile of the kernels (fused_gemm_bn.cuh BM)
_CONV3_BM = 128  # kernel 4's bf16 row tile: two consumer warpgroups of 64
_CONV3_BK = 64   # kernel 4's bf16 reduction step: one tap, 64 channels
_MM_BM = 128     # kernel 1's bf16 row tile: two consumer warpgroups of 64
_MM_BK = 64      # kernel 1's bf16 reduction step: 64 channels
_WGRAD_BN = 128  # kernel 3's bf16 tile of dW^T rows (N): two warpgroups
_WGRAD_BM = 64   # kernel 3's reduction step: 64 rows of M
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


# --------------------------------------------------------------------------
# cost formulas: operations, and bytes with each input read once and each
# output written once (``size`` bytes per element of x; ps, pb and the
# column vectors in f32).  Without a prologue a dgrad reads no x and no
# kernel reads ps, pb.
# --------------------------------------------------------------------------
def cost_matmul(m: int, k: int, n: int, prologue: bool, size: int):
    """Kernel 1: x, w, y; ps, pb, ssum, ssq."""
    pro = int(prologue)
    return 2 * m * k * n, size * (m * k + k * n + m * n) \
        + 4 * (2 * pro * k + 2 * n)


def cost_matmul_dgrad(m: int, k: int, n: int, prologue: bool, size: int):
    """Kernel 2: dy, y, w, dx (+ x); dssum, dssq (+ ps, pb, d_ps, d_pb)."""
    pro = int(prologue)
    return 2 * m * k * n, size * (2 * m * n + k * n + m * k + pro * m * k) \
        + 4 * (4 * pro * k + 2 * n)


def cost_matmul_wgrad(m: int, k: int, n: int, prologue: bool, size: int):
    """Kernel 3: x, dy, y, dW; ps, pb, dssum, dssq, and the f32 partial
    dW."""
    pro = int(prologue)
    return 2 * m * k * n, size * (m * k + 2 * m * n) \
        + 4 * (2 * pro * k + 2 * n) + 4 * k * n


def cost_conv3(b: int, h: int, w: int, c: int, co: int, prologue: bool,
               size: int):
    """Kernel 4: x, w, y; ps, pb, ssum, ssq."""
    m, pro = b * h * w, int(prologue)
    return 18 * m * c * co, size * (m * c + 9 * c * co + m * co) \
        + 4 * (2 * pro * c + 2 * co)


def cost_conv3_dgrad(b: int, h: int, w: int, c: int, co: int,
                     prologue: bool, size: int):
    """Kernel 5: dy, y, dx, w (+ x); dssum, dssq (+ ps, pb, d_ps, d_pb)."""
    m, pro = b * h * w, int(prologue)
    return 18 * m * c * co, \
        size * (2 * m * co + m * c + 9 * c * co + pro * m * c) \
        + 4 * (4 * pro * c + 2 * co)


#: kernel name -> its formula, over ``(m, k, n)`` or ``(b, h, w, c, co)``
#: then ``prologue`` and ``size``
COSTS = {"fused_matmul_bn": cost_matmul,
         "fused_matmul_bn_dgrad": cost_matmul_dgrad,
         "fused_matmul_bn_wgrad": cost_matmul_wgrad,
         "fused_conv3x3_bn": cost_conv3,
         "fused_conv3x3_bn_dgrad": cost_conv3_dgrad}


def reset_launches():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        COPIES["fused_channel_pad"] = 0


def _prologue(x: Tensor, ps: Optional[Tensor], pb: Optional[Tensor],
              relu: bool, dtype: torch.dtype) -> Tensor:
    """``[relu](x * ps + pb)`` in f32 over the last axis, rounded to
    ``dtype``; ``x`` itself when there is no prologue."""
    if ps is None:
        return x
    uf = x.float() * ps.float()
    uf = uf + (pb.float() if pb is not None else 0.0)
    if relu:
        uf = torch.clamp_min(uf, 0.0)
    return uf.to(dtype)


def _stats(yf: Tensor) -> Tuple[Tensor, Tensor]:
    y2 = yf.reshape(-1, yf.shape[-1])
    return y2.sum(0), (y2 * y2).sum(0)


def _ytot(dy: Tensor, y: Tensor, dssum: Tensor, dssq: Tensor) -> Tensor:
    """The total f32 cotangent of the raw output: dy plus the statistics'
    cotangents, from the saved (rounded) y (fused_matmul.py:222-224)."""
    return dy.float() + dssum + 2.0 * y.float() * dssq


def _prologue_backward(g_out: Tensor, x: Tensor, ps: Optional[Tensor],
                       pb: Optional[Tensor], relu: bool) -> Dgrad:
    """``dx, d_ps, d_pb`` from the f32 gradient of the product's input
    (fused_matmul.py:234-245): the strict ReLU mask on the f32
    ``x * ps + pb``, then ``dx = g * ps`` in x's type and the per-channel
    sums of ``g * x`` and ``g`` over every other axis."""
    if ps is None:
        return g_out.to(x.dtype), None, None
    xf = x.float()
    g = g_out
    if relu:
        pre = xf * ps.float() + (pb.float() if pb is not None else 0.0)
        g = torch.where(pre > 0.0, g_out, 0.0)
    axes = tuple(range(x.dim() - 1))
    return ((g * ps.float()).to(x.dtype), (g * xf).sum(axes),
            g.sum(axes))


def _nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: Tensor) -> Tensor:
    return t.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# plain versions (mirror _xla_fwd, _conv3_xla and the Pallas backward
# kernels' arithmetic)
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
    yf = _nhwc(F.conv2d(_nchw(u.float()), w.float().permute(3, 2, 0, 1),
                        padding=1))
    return (yf.to(x.dtype),) + _stats(yf)


def fused_matmul_bn_dgrad_plain(dy: Tensor, y: Tensor, dssum: Tensor,
                                dssq: Tensor, w: Tensor, x: Tensor,
                                prologue_scale: Optional[Tensor] = None,
                                prologue_bias: Optional[Tensor] = None,
                                relu: bool = True) -> Dgrad:
    """The plain version of :func:`fused_matmul_bn_dgrad`
    (``_dgrad_kernel``, fused_matmul.py:218-245): ``ytot`` rounded to
    w's type, ``g = ytot @ w^T`` in f32, then the prologue's backward.
    ``d_ps``/``d_pb`` are ``None`` without a prologue."""
    ytot = _ytot(dy, y, dssum, dssq).to(w.dtype)
    g_out = torch.matmul(ytot.float(), w.float().t())
    return _prologue_backward(g_out, x, prologue_scale, prologue_bias, relu)


def fused_matmul_bn_wgrad_plain(x: Tensor,
                                prologue_scale: Optional[Tensor],
                                prologue_bias: Optional[Tensor], dy: Tensor,
                                y: Tensor, dssum: Tensor, dssq: Tensor,
                                relu: bool = True) -> Tensor:
    """The plain version of :func:`fused_matmul_bn_wgrad`
    (``_wgrad_kernel``, fused_matmul.py:300-320): ``u`` recomputed and
    rounded to dy's type, ``ytot`` rounded to u's type, ``u^T @ ytot``
    summed in f32 over all rows and rounded once to x's type."""
    u = _prologue(x, prologue_scale, prologue_bias, relu, dy.dtype)
    ytot = _ytot(dy, y, dssum, dssq).to(u.dtype)
    return torch.matmul(u.float().t(), ytot.float()).to(x.dtype)


def fused_conv3x3_bn_dgrad_plain(dy: Tensor, y: Tensor, dssum: Tensor,
                                 dssq: Tensor, w: Tensor, x: Tensor,
                                 prologue_scale: Optional[Tensor] = None,
                                 prologue_bias: Optional[Tensor] = None,
                                 relu: bool = True) -> Dgrad:
    """The plain version of :func:`fused_conv3x3_bn_dgrad`
    (``_conv3_dgrad_kernel``, fused_matmul.py:671-711): ``ytot`` rounded
    to dy's type, zero-padded AFTER it is formed, an f32 convolution
    with the flipped io-swapped weight, then the prologue's backward."""
    ytot = _ytot(dy, y, dssum, dssq).to(dy.dtype)
    wf = w.flip(0, 1).transpose(2, 3)  # (3, 3, Co, Ci) HWIO
    g_out = _nhwc(F.conv2d(_nchw(ytot.float()),
                           wf.float().permute(3, 2, 0, 1), padding=1))
    return _prologue_backward(g_out, x, prologue_scale, prologue_bias, relu)


def conv3x3_wgrad(x: Tensor, prologue_scale: Optional[Tensor],
                  prologue_bias: Optional[Tensor], dy: Tensor, y: Tensor,
                  dssum: Tensor, dssq: Tensor, relu: bool,
                  w_shape) -> Tensor:
    """The weight gradient of :func:`fused_conv3x3_bn` as one library
    convolution, in x's type, as the JAX package computes it in XLA
    outside any kernel (fused_matmul.py:811-829): ``u`` and ``ytot``
    rounded to x's type, correlated over the 3x3 taps.  HWIO result in
    x's type."""
    u = _prologue(x, prologue_scale, prologue_bias, relu, x.dtype)
    ytot = _ytot(dy, y, dssum, dssq).to(x.dtype)
    kh, kw, ci, co = w_shape
    dw = torch.nn.grad.conv2d_weight(_nchw(u), (co, ci, kh, kw),
                                     _nchw(ytot), padding=1)
    return dw.permute(2, 3, 1, 0)


# --------------------------------------------------------------------------
# channel padding (widths that are not multiples of 8)
# --------------------------------------------------------------------------
def _pad8(t: Optional[Tensor], *axes: int) -> Optional[Tensor]:
    """``t`` zero-padded along ``axes`` (default the last) to multiples
    of 8; ``None`` stays ``None``."""
    if t is None:
        return None
    pads = [0] * (2 * t.dim())
    for a in axes or (-1,):
        pads[2 * (-a - 1 if a < 0 else t.dim() - 1 - a) + 1] = \
            -t.shape[a] % 8
    return F.pad(t, pads)


def _padded_forward(fn, x: Tensor, w: Tensor, ps, pb, relu: bool) -> Stats:
    """``fn(x, w, ps, pb, relu)`` (kernel 1 or 4, or a plain version) on
    channels zero-padded to multiples of 8: x's last axis and the
    prologue vectors to C', w's last two axes (C, Co) to (C', Co'); y,
    ssum and ssq are sliced back to Co."""
    co = w.shape[-1]
    y, ssum, ssq = fn(_pad8(x), _pad8(w, -2, -1), _pad8(ps), _pad8(pb), relu)
    return y[..., :co].contiguous(), ssum[:co], ssq[:co]


def _padded_dgrad(fn, dy: Tensor, y: Tensor, dssum: Tensor, dssq: Tensor,
                  w: Tensor, x: Tensor, ps, pb, relu: bool) -> Dgrad:
    """``fn(dy, y, dssum, dssq, w, x, ps, pb, relu)`` (kernel 2 or 5, or
    a plain version) on zero-padded channels: dy, y and the statistics'
    cotangents to Co', w to (C', Co'), x and the prologue vectors to C';
    dx, d_ps and d_pb are sliced back to C."""
    c = x.shape[-1]
    dx, dps, dpb = fn(_pad8(dy), _pad8(y), _pad8(dssum), _pad8(dssq),
                      _pad8(w, -2, -1), _pad8(x), _pad8(ps), _pad8(pb), relu)
    return (dx[..., :c].contiguous(),
            None if dps is None else dps[:c],
            None if dpb is None else dpb[:c])


def _padded_wgrad(fn, x: Tensor, ps, pb, dy: Tensor, y: Tensor,
                  dssum: Tensor, dssq: Tensor, relu: bool) -> Tensor:
    """``fn(x, ps, pb, dy, y, dssum, dssq, relu)`` (kernel 3, or its
    plain version) on zero-padded channels; dW sliced back to (K, N)."""
    k, n = x.shape[-1], dy.shape[-1]
    dw = fn(_pad8(x), _pad8(ps), _pad8(pb), _pad8(dy), _pad8(y),
            _pad8(dssum), _pad8(dssq), relu)
    return dw[:k, :n].contiguous()


def _count_pad(widths) -> bool:
    """Whether a call with these channel widths pads (and count it)."""
    if all(v % 8 == 0 for v in widths):
        return False
    with _launch_lock:
        COPIES["fused_channel_pad"] += 1
    return True


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------
def _check_cuda(name: str, x: Tensor, others):
    """Raise on what the kernels do not take: a type other than bf16/f32,
    operands of another type or device, non-contiguous or unaligned
    operands, or ``x`` off the current device."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: x must be bfloat16 or float32, "
                        f"got {x.dtype}")
    for t in others:
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: operands must have x's dtype "
                            f"({x.dtype}), got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: x on {x.device} but an operand on "
                             f"{t.device}")
    for t in (x,) + tuple(others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    if x.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: x is on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def _vector(name: str, v: Tensor, n: int, device) -> Tensor:
    """A per-channel (n,) vector as the kernels read it: f32, contiguous,
    on ``device``."""
    v = v.to(device=device, dtype=torch.float32).contiguous()
    if v.shape != (n,):
        raise ValueError(f"{name}: expected a ({n},) vector, got "
                         f"{tuple(v.shape)}")
    return v


_identity: dict = {}


def _prologue_vectors(name: str, device, k: int, ps, pb):
    """f32 ``(ps, pb)``; cached (ones, zeros) stand-ins when there is no
    prologue (the kernel is told to skip it and never reads them)."""
    if ps is None:
        key = (device, k)
        if key in _identity:
            return _identity[key]
        pair = (torch.ones(k, device=device), torch.zeros(k, device=device))
        # memory allocated while a CUDA graph is captured belongs to the
        # graph's pool: use it, but do not keep it beyond the graph
        if not torch.cuda.is_current_stream_capturing():
            _identity[key] = pair
        return pair
    pb = torch.zeros(k, device=device) if pb is None else pb
    return _vector(name, ps, k, device), _vector(name, pb, k, device)


def _call(name: str, x: Tensor, *args):
    """Launch ``name``'s entry point for x's type on the current stream
    (tensors are passed as their device addresses) and count it."""
    fn = getattr(_build.load(name), f"{name}_{_SUFFIX[x.dtype]}")
    err = fn(*(a.data_ptr() if isinstance(a, Tensor) else a for a in args),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    with _launch_lock:
        LAUNCHES[name] += 1


def _colsum_scratch(grid_m: int, n: int, device):
    """One f32 allocation for the two-pass column sums: the two
    (grid_m, n) partial arrays (one row per row tile, or per block of a
    persistent kernel), then the two (n,) results.  Returns (four
    addresses, the two results)."""
    buf = torch.empty((2 * grid_m + 2, n), device=device,
                      dtype=torch.float32)
    p0, row = buf.data_ptr(), 4 * n
    ptrs = (p0, p0 + grid_m * row, p0 + 2 * grid_m * row,
            p0 + (2 * grid_m + 1) * row)
    return ptrs, (buf[2 * grid_m], buf[2 * grid_m + 1])


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _route(name: str, x: Tensor) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version
    (a CPU tensor); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    return True


def _slices(tiles: int, slots: int, cap: int) -> int:
    """Slices of a split reduction: 1 where ``tiles`` output tiles fill
    the card's ``slots`` (blocks in flight at once); else, among
    ceil(slots / tiles) to twice that many (at most ``cap``), the count
    that wastes the least of the last wave, ceil(tiles * s / slots) / s,
    fewest slices first."""
    if tiles >= slots:
        return 1
    lo = -(-slots // tiles)
    cands = range(min(lo, cap), min(2 * lo, cap) + 1)
    return min(cands, key=lambda s: (-(-tiles * s // slots) / s, s))


class MatmulPlan(NamedTuple):
    """How kernel 1's bf16 path tiles one call: ``bm`` rows by ``bn``
    columns per tile, the reduction's ``steps`` (64 channels each) cut
    into ``slices`` of ``per`` steps, and ``blocks`` persistent blocks
    walking the tiles: one per SM, but without a split a multiple of the
    column tiles (rounded down, at least one per column tile), so that
    each block keeps one column tile."""
    bm: int
    bn: int
    steps: int
    per: int
    slices: int
    blocks: int


def _matmul_plan(m: int, k: int, n: int, sms: int) -> MatmulPlan:
    """Kernel 1's tiling for an (m, k) @ (k, n) product on ``sms`` SMs:
    128 columns per tile, or 64 where ``n`` is 64 or 128-column tiles
    would leave half the SMs idle; the reduction split (:func:`_slices`)
    only where the tiles leave three quarters of the SMs idle: on an
    H100 a split's f32 round trip through the workspace cost more than
    the SMs it filled at every ResNet-50 shape at batch 32."""
    rows = -(-m // _MM_BM)
    bn = 64 if n <= 64 or 2 * rows * -(-n // 128) < sms else 128
    steps = -(-k // _MM_BK)
    cols = -(-n // bn)
    slices = 1 if 4 * rows * cols >= sms else _slices(rows * cols, sms,
                                                      steps)
    per = -(-steps // slices)
    slices = -(-steps // per)
    blocks = min(rows * cols * slices, sms if slices > 1
                 else max(1, sms // cols) * cols)
    return MatmulPlan(_MM_BM, bn, steps, per, slices, blocks)


@accounted("fused_matmul_bn", lambda x, *a: x,
           lambda x, w, ps, *a: cost_matmul(
               *x.shape, w.shape[1], ps is not None, x.element_size()))
def _matmul_forward(x: Tensor, w: Tensor, ps, pb, relu: bool) -> Stats:
    m, k = x.shape
    kw, n = w.shape
    if k != kw:
        raise ValueError(f"fused_matmul_bn: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if not _route("fused_matmul_bn", x):
        return fused_matmul_bn_plain(x, w, ps, pb, relu)
    if _count_pad((k, n)):
        return _padded_forward(_matmul_forward, x, w, ps, pb, relu)
    _check_cuda("fused_matmul_bn", x, (w,))
    if m == 0:
        raise ValueError("fused_matmul_bn: x has no rows")
    psv, pbv = _prologue_vectors("fused_matmul_bn", x.device, k, ps, pb)
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    plan = _matmul_plan(m, k, n, _sms(x.device))
    ws = 0  # the split reduction's (slices, m, n) f32 partial tiles
    if x.dtype == torch.bfloat16 and plan.slices > 1:
        ws = torch.empty((plan.slices, m, n), device=x.device,
                         dtype=torch.float32)
    # partial rows: one per block (bf16 without a split) or per 128-row
    # tile (bf16 split, f32)
    ptrs, (ssum, ssq) = _colsum_scratch(max(plan.blocks, -(-m // _BM)), n,
                                        x.device)
    _call("fused_matmul_bn", x, x, w, psv, pbv, y, ws, *ptrs, m, k, n,
          int(ps is not None), int(relu), plan.bn, plan.per, plan.blocks)
    return y, ssum, ssq


class Conv3Plan(NamedTuple):
    """How kernel 4's bf16 path tiles one call: ``bm`` output pixels by
    ``bn`` output channels per block, the reduction's ``steps`` (one tap
    and 64 channels each, taps innermost) cut into ``slices`` of ``per``
    whole steps, a multiple of 3 (the taps that share one x window)."""
    bm: int
    bn: int
    steps: int
    per: int
    slices: int


def _conv3_plan(b: int, h: int, w: int, c: int, co: int,
                sms: int) -> Conv3Plan:
    """Kernel 4's tiling for an (b, h, w, c) -> co conv on ``sms`` SMs.

    The column tile is the widest of 256, 128, 64 (at most ``co``) whose
    (128-pixel x bn) tiles still fill the card twice; else 128 (64 where
    ``co`` is 64).  Where the tiles number fewer than the SMs, the
    reduction is split: among ceil(sms / tiles) to twice that many
    slices (at least one x window of 3 steps each), the one that wastes
    the least of the last wave, ceil(tiles * s / sms) / s, fewest slices
    first (:func:`_slices`)."""
    m, bm = b * h * w, _CONV3_BM
    steps = 9 * -(-c // _CONV3_BK)
    rows = -(-m // bm)
    bn = next((t for t in (256, 128, 64)
               if t <= max(co, 64) and rows * -(-co // t) >= 2 * sms),
              128 if co > 64 else 64)
    slices = _slices(rows * -(-co // bn), sms, steps // 3)
    per = 3 * -(-steps // (3 * slices))
    return Conv3Plan(bm, bn, steps, per, -(-steps // per))


@accounted("fused_conv3x3_bn", lambda x, *a: x,
           lambda x, w, ps, *a: cost_conv3(
               *x.shape, w.shape[3], ps is not None, x.element_size()))
def _conv3x3_forward(x: Tensor, w: Tensor, ps, pb, relu: bool) -> Stats:
    if tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"fused_conv3x3_bn: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    b, h, wd, c = x.shape
    co = w.shape[3]
    if not _route("fused_conv3x3_bn", x):
        return fused_conv3x3_bn_plain(x, w, ps, pb, relu)
    if _count_pad((c, co)):
        return _padded_forward(_conv3x3_forward, x, w, ps, pb, relu)
    _check_cuda("fused_conv3x3_bn", x, (w,))
    m = b * h * wd
    if m == 0:
        raise ValueError("fused_conv3x3_bn: x has no pixels")
    psv, pbv = _prologue_vectors("fused_conv3x3_bn", x.device, c, ps, pb)
    y = torch.empty((b, h, wd, co), device=x.device, dtype=x.dtype)
    plan = _conv3_plan(b, h, wd, c, co, _sms(x.device))
    ws = 0  # the split reduction's (slices, m, co) f32 partial tiles
    if x.dtype == torch.bfloat16 and plan.slices > 1:
        ws = torch.empty((plan.slices, m, co), device=x.device,
                         dtype=torch.float32)
    ptrs, (ssum, ssq) = _colsum_scratch(-(-m // plan.bm), co, x.device)
    _call("fused_conv3x3_bn", x, x, w, psv, pbv, y, ws, *ptrs, b, h, wd, c,
          co, int(ps is not None), int(relu), plan.bn, plan.per)
    return y, ssum, ssq


def _dgrad_launch(name: str, dy, y, dssum, dssq, w, x, ps, pb, relu,
                  m: int, n_out: int, dims, tiling, slices: int,
                  part_rows: int) -> Dgrad:
    """Shared launch of kernels 2 and 5: (m, n_out) dx and, with a
    prologue, the two-pass column sums d_ps/d_pb over n_out channels from
    ``part_rows`` partial rows.  ``w`` is the weight as the entry point
    for x's type takes it, ``tiling`` the bf16 plan's launch arguments
    and ``slices`` its reduction split (an f32 workspace when > 1)."""
    n_in = dy.shape[-1]
    dssum = _vector(name, dssum, n_in, x.device)
    dssq = _vector(name, dssq, n_in, x.device)
    psv, pbv = _prologue_vectors(name, x.device, n_out, ps, pb)
    dx = torch.empty_like(x)
    ws = 0  # the split reduction's (slices, m, n_out) f32 partial tiles
    if slices > 1:
        ws = torch.empty((slices, m, n_out), device=x.device,
                         dtype=torch.float32)
    ptrs, (dps, dpb) = _colsum_scratch(part_rows, n_out, x.device)
    _call(name, x, dy, y, dssum, dssq, w, x, psv, pbv, dx, ws, *ptrs, *dims,
          int(ps is not None), int(relu), *tiling)
    return (dx, None, None) if ps is None else (dx, dps, dpb)


class DgradPlan(NamedTuple):
    """How kernel 2's bf16 path tiles one call: ``bm`` rows by ``bn``
    columns of dx (over K) per tile, the reduction over N in ``steps`` of
    64 channels cut into ``slices`` of ``per`` steps, ``blocks``
    persistent blocks walking the tiles (without a split a multiple of
    the column tiles, so that each block keeps one column tile) and the
    ``part_rows`` rows of column partials it leaves: one per block, or
    one per row tile after a split's sum."""
    bm: int
    bn: int
    steps: int
    per: int
    slices: int
    blocks: int
    part_rows: int


def _dgrad_plan(m: int, k: int, n: int, sms: int) -> DgradPlan:
    """Kernel 2's tiling for dx (m, k) = ytot (m, n) @ W^T on ``sms``
    SMs: kernel 1's rules (:func:`_matmul_plan`) with the output's
    columns K and the reduction N: 128 columns per tile, or 64 where
    ``k`` is 64 or 128-column tiles would leave half the SMs idle; the
    reduction split only where the tiles leave three quarters of the SMs
    idle (no ResNet-50 shape at batch 32 or 256)."""
    rows = -(-m // _MM_BM)
    bn = 64 if k <= 64 or 2 * rows * -(-k // 128) < sms else 128
    steps = -(-n // _MM_BK)
    cols = -(-k // bn)
    slices = 1 if 4 * rows * cols >= sms else _slices(rows * cols, sms,
                                                      steps)
    per = -(-steps // slices)
    slices = -(-steps // per)
    if slices > 1:
        blocks, part_rows = min(rows * cols * slices, sms), rows
    else:
        blocks = min(rows * cols, max(1, sms // cols) * cols)
        part_rows = blocks // cols
    return DgradPlan(_MM_BM, bn, steps, per, slices, blocks, part_rows)


@accounted("fused_matmul_bn_dgrad",
           lambda dy, y, dssum, dssq, w, x, *a, **k: x,
           lambda dy, y, dssum, dssq, w, x, prologue_scale=None, *a, **k:
           cost_matmul_dgrad(*x.shape, w.shape[1],
                             prologue_scale is not None, x.element_size()))
def fused_matmul_bn_dgrad(dy: Tensor, y: Tensor, dssum: Tensor,
                          dssq: Tensor, w: Tensor, x: Tensor,
                          prologue_scale: Optional[Tensor] = None,
                          prologue_bias: Optional[Tensor] = None,
                          relu: bool = True) -> Dgrad:
    """Kernel 2 (``_dgrad_kernel``): ``(dx, d_ps, d_pb)`` of
    :func:`fused_matmul_bn` from the cotangents ``dy`` (M, N) and
    ``dssum``/``dssq`` (N,), the saved ``y`` (M, N), ``w`` (K, N) and
    ``x`` (M, K).  ``d_ps``/``d_pb`` are ``None`` without a prologue.
    The bf16 kernel reads ``w`` as it lies; the f32 one takes a
    contiguous copy of ``w.t()``."""
    m, k = x.shape
    n = w.shape[1]
    name = "fused_matmul_bn_dgrad"
    if tuple(w.shape) != (k, n) or tuple(dy.shape) != (m, n) \
            or tuple(y.shape) != (m, n):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, y "
                         f"{tuple(y.shape)}, w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}")
    if not _route(name, x):
        return fused_matmul_bn_dgrad_plain(dy, y, dssum, dssq, w, x,
                                           prologue_scale, prologue_bias,
                                           relu)
    if _count_pad((k, n)):
        return _padded_dgrad(fused_matmul_bn_dgrad, dy, y, dssum, dssq, w,
                             x, prologue_scale, prologue_bias, relu)
    _check_cuda(name, x, (dy, y, w))
    if m == 0:
        raise ValueError(f"{name}: x has no rows")
    if x.dtype == torch.bfloat16:
        plan = _dgrad_plan(m, k, n, _sms(x.device))
        return _dgrad_launch(name, dy, y, dssum, dssq, w, x, prologue_scale,
                             prologue_bias, relu, m, k, (m, k, n),
                             (plan.bn, plan.per, plan.blocks), plan.slices,
                             plan.part_rows)
    # f32: the FMA tiles take B = W^T as a contiguous (N, K) matrix
    return _dgrad_launch(name, dy, y, dssum, dssq, w.t().contiguous(), x,
                         prologue_scale, prologue_bias, relu, m, k,
                         (m, k, n), (0, 0, 0), 1, -(-m // _BM))


class WgradPlan(NamedTuple):
    """How kernel 3's bf16 path tiles one call: ``bn`` rows of dW^T (N)
    by ``bk`` columns (K) per block, the reduction over M in ``steps`` of
    64 rows cut into ``slices`` of ``per`` steps.  The f32 path takes
    slices of the same ``64 * per`` rows."""
    bn: int
    bk: int
    steps: int
    per: int
    slices: int


def _wgrad_plan(m: int, k: int, n: int, sms: int) -> WgradPlan:
    """Kernel 3's tiling for dW (k, n) over m rows on ``sms`` SMs: the
    widest column tile of 64, 128, 256 that ``k`` fills, and the M
    reduction split (:func:`_slices`) until the tiles fill the card, with
    at least 6 steps (384 rows) per slice: each slice writes a (k, n) f32
    partial, and on an H100 shorter slices cost more in partials than
    they gained at the ResNet-50 shapes at batch 32."""
    bk = 64 if k <= 64 else 128 if k <= 128 else 256
    steps = -(-m // _WGRAD_BM)
    slices = _slices(-(-n // _WGRAD_BN) * -(-k // bk), sms,
                     max(1, steps // 6))
    per = -(-steps // slices)
    return WgradPlan(_WGRAD_BN, bk, steps, per, -(-steps // per))


@accounted("fused_matmul_bn_wgrad", lambda x, *a, **k: x,
           lambda x, prologue_scale, prologue_bias, dy, *a, **k:
           cost_matmul_wgrad(*x.shape, dy.shape[1],
                             prologue_scale is not None, x.element_size()))
def fused_matmul_bn_wgrad(x: Tensor, prologue_scale: Optional[Tensor],
                          prologue_bias: Optional[Tensor], dy: Tensor,
                          y: Tensor, dssum: Tensor, dssq: Tensor,
                          relu: bool = True) -> Tensor:
    """Kernel 3 (``_wgrad_kernel``): ``dW`` (K, N) of
    :func:`fused_matmul_bn`, summed in f32 over all M rows and rounded
    once to x's type (the weight's type wherever the kernel runs)."""
    m, k = x.shape
    n = dy.shape[1]
    name = "fused_matmul_bn_wgrad"
    if tuple(dy.shape) != (m, n) or tuple(y.shape) != (m, n):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, y {tuple(y.shape)}")
    if not _route(name, x):
        return fused_matmul_bn_wgrad_plain(x, prologue_scale, prologue_bias,
                                           dy, y, dssum, dssq, relu)
    if _count_pad((k, n)):
        return _padded_wgrad(fused_matmul_bn_wgrad, x, prologue_scale,
                             prologue_bias, dy, y, dssum, dssq, relu)
    _check_cuda(name, x, (dy, y))
    if m == 0:
        raise ValueError(f"{name}: x has no rows")
    dssum = _vector(name, dssum, n, x.device)
    dssq = _vector(name, dssq, n, x.device)
    psv, pbv = _prologue_vectors(name, x.device, k, prologue_scale,
                                 prologue_bias)
    plan = _wgrad_plan(m, k, n, _sms(x.device))
    part = torch.empty((plan.slices, k, n), device=x.device,
                       dtype=torch.float32)
    dw = torch.empty((k, n), device=x.device, dtype=x.dtype)
    _call(name, x, x, psv, pbv, dy, y, dssum, dssq, part, dw, m, k, n,
          plan.bk, plan.per, int(prologue_scale is not None), int(relu))
    return dw


def _conv3_dgrad_plan(b: int, h: int, w: int, ci: int, co: int,
                      sms: int) -> Conv3Plan:
    """Kernel 5's tiling for the dgrad of an (b, h, w, ci) -> co conv on
    ``sms`` SMs, by kernel 2's rules (:func:`_dgrad_plan`): 128 input
    channels per tile, or 64 where ``ci`` is 64 or 128-channel tiles
    would leave half the SMs idle; the reduction (9 taps x 64-channel
    chunks of ``co``, taps innermost) split as kernel 4's is
    (:func:`_slices`, whole windows of 3 taps per slice) only where the
    tiles leave three quarters of the SMs idle: on an H100 a split's f32
    round trip cost more than the SMs it filled at every ResNet-50 shape
    at batch 32 (``kernel_ab.py --sweep 32``)."""
    m, bm = b * h * w, _CONV3_BM
    rows = -(-m // bm)
    steps = 9 * -(-co // _CONV3_BK)
    bn = 64 if ci <= 64 or 2 * rows * -(-ci // 128) < sms else 128
    tiles = rows * -(-ci // bn)
    slices = 1 if 4 * tiles >= sms else _slices(tiles, sms, steps // 3)
    per = 3 * -(-steps // (3 * slices))
    return Conv3Plan(bm, bn, steps, per, -(-steps // per))


@accounted("fused_conv3x3_bn_dgrad",
           lambda dy, y, dssum, dssq, w, x, *a, **k: x,
           lambda dy, y, dssum, dssq, w, x, prologue_scale=None, *a, **k:
           cost_conv3_dgrad(*x.shape, w.shape[3],
                            prologue_scale is not None, x.element_size()))
def fused_conv3x3_bn_dgrad(dy: Tensor, y: Tensor, dssum: Tensor,
                           dssq: Tensor, w: Tensor, x: Tensor,
                           prologue_scale: Optional[Tensor] = None,
                           prologue_bias: Optional[Tensor] = None,
                           relu: bool = True) -> Dgrad:
    """Kernel 5 (``_conv3_dgrad_kernel``): ``(dx, d_ps, d_pb)`` of
    :func:`fused_conv3x3_bn` from ``dy``/``y`` (B, H, W, Co),
    ``dssum``/``dssq`` (Co,), ``w`` (3, 3, Ci, Co) and ``x``
    (B, H, W, Ci).  The bf16 kernel reads ``w`` as it lies; the f32 one
    takes a contiguous flipped, io-swapped copy."""
    b, h, wd, ci = x.shape
    co = w.shape[3]
    name = "fused_conv3x3_bn_dgrad"
    if tuple(w.shape) != (3, 3, ci, co) or tuple(dy.shape) != (b, h, wd, co) \
            or tuple(y.shape) != (b, h, wd, co):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, y "
                         f"{tuple(y.shape)}, w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}")
    if not _route(name, x):
        return fused_conv3x3_bn_dgrad_plain(dy, y, dssum, dssq, w, x,
                                            prologue_scale, prologue_bias,
                                            relu)
    if _count_pad((ci, co)):
        return _padded_dgrad(fused_conv3x3_bn_dgrad, dy, y, dssum, dssq, w,
                             x, prologue_scale, prologue_bias, relu)
    _check_cuda(name, x, (dy, y, w))
    m = b * h * wd
    if m == 0:
        raise ValueError(f"{name}: x has no pixels")
    dims = (b, h, wd, ci, co)
    if x.dtype == torch.bfloat16:
        plan = _conv3_dgrad_plan(b, h, wd, ci, co, _sms(x.device))
        return _dgrad_launch(name, dy, y, dssum, dssq, w, x, prologue_scale,
                             prologue_bias, relu, m, ci, dims,
                             (plan.bn, plan.per), plan.slices,
                             -(-m // plan.bm))
    # f32: the FMA tiles take B = w[2-dh, 2-dw, ci, co] as a contiguous
    # (9*Co, Ci) matrix
    wf = w.flip(0, 1).transpose(2, 3).contiguous()
    return _dgrad_launch(name, dy, y, dssum, dssq, wf, x, prologue_scale,
                         prologue_bias, relu, m, ci, dims, (0, 0), 1,
                         -(-m // _BM))


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------
def _cotangents(dy: Tensor, dssum: Tensor, dssq: Tensor):
    """Incoming gradients may be expanded or non-contiguous (``dssum``/
    ``dssq`` come through broadcasts in bn_constants)."""
    return dy.contiguous(), dssum.float().contiguous(), \
        dssq.float().contiguous()


class _FusedMatmul(torch.autograd.Function):
    """``_fused`` with its custom VJP (fused_matmul.py:378-430)."""

    @staticmethod
    def forward(ctx, x, w, ps, pb, relu):
        y, ssum, ssq = _matmul_forward(x, w, ps, pb, relu)
        ctx.save_for_backward(x, w, ps, pb, y)
        ctx.relu = relu
        return y, ssum, ssq

    @staticmethod
    def backward(ctx, dy, dssum, dssq):
        x, w, ps, pb, y = ctx.saved_tensors
        dy, dssum, dssq = _cotangents(dy, dssum, dssq)
        need = ctx.needs_input_grad
        dx = dw = dps = dpb = None
        if need[0] or need[2] or need[3]:
            dx, dps, dpb = fused_matmul_bn_dgrad(dy, y, dssum, dssq, w, x,
                                                 ps, pb, ctx.relu)
        if need[1]:
            dw = fused_matmul_bn_wgrad(x, ps, pb, dy, y, dssum, dssq,
                                       ctx.relu).to(w.dtype)
        return dx, dw, dps, dpb, None


class _FusedConv3x3(torch.autograd.Function):
    """``_conv3`` with its custom VJP (fused_matmul.py:776-856), along
    the Pallas-dgrad branch."""

    @staticmethod
    def forward(ctx, x, w, ps, pb, relu):
        y, ssum, ssq = _conv3x3_forward(x, w, ps, pb, relu)
        ctx.save_for_backward(x, w, ps, pb, y)
        ctx.relu = relu
        return y, ssum, ssq

    @staticmethod
    def backward(ctx, dy, dssum, dssq):
        x, w, ps, pb, y = ctx.saved_tensors
        dy, dssum, dssq = _cotangents(dy, dssum, dssq)
        need = ctx.needs_input_grad
        dx = dw = dps = dpb = None
        if need[0] or need[2] or need[3]:
            dx, dps, dpb = fused_conv3x3_bn_dgrad(
                dy, y, dssum, dssq, w.to(x.dtype), x, ps, pb, ctx.relu)
        if need[1]:
            dw = conv3x3_wgrad(x, ps, pb, dy, y, dssum, dssq, ctx.relu,
                               w.shape).to(w.dtype)
        return dx, dw, dps, dpb, None


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
    y (M, N) in x's dtype, ssum/ssq (N,) f32.  Differentiable in x, w and
    the prologue constants, through kernels 2 and 3.
    """
    return _FusedMatmul.apply(x, w, prologue_scale, prologue_bias, relu)


def fused_conv3x3_bn(x: Tensor, w: Tensor,
                     prologue_scale: Optional[Tensor] = None,
                     prologue_bias: Optional[Tensor] = None,
                     relu: bool = True) -> Stats:
    """3x3 stride-1 SAME conv with the same prologue/epilogue contract as
    :func:`fused_matmul_bn` (bigdl_tpu/ops/pallas/fused_matmul.py:859).
    ``x`` (B, H, W, C) NHWC, ``w`` (3, 3, C, Co) HWIO; returns
    ``(y (B, H, W, Co), ssum (Co,), ssq (Co,))``.  Differentiable through
    kernel 5 (dgrad) and a library convolution (wgrad)."""
    return _FusedConv3x3.apply(x, w, prologue_scale, prologue_bias, relu)


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
