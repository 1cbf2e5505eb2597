"""Int8 x int8 -> int32 matmul with a fused dequant epilogue:
bigdl_tpu/ops/pallas/int8_matmul.py.

``int8_matmul_dequant(x_q, w_q, scale_row, out_dtype)`` computes

    y[m, n] = (sum_k x_q[m, k] * w_q[k, n]) * scale_row[n]

for ``(M, K)`` and ``(K, N)`` int8 operands, with an f32 ``scale_row`` of
shape ``(N,)`` or ``(1, N)`` (the activation's per-tensor scale folded
into the weight's per-column scale), cast once to ``out_dtype`` (bf16 or
f32).  It takes one of two routes, decided by where ``x_q`` lies:

- a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/int8_matmul.cu``) or raises.  The kernel reads both operands
  as rows of K bytes by TMA: x as it lies and ``w_q`` through its
  ``(N, K)`` view, so a ``w_q`` with K contiguous (the quantized layers'
  weights, the transposed view ``k_q.T`` of an int8 key cache) passes
  without a copy.  Any other ``w_q`` gets one K-major copy per call
  (``LAUNCHES["int8_matmul_w_relayout"]``); an operand whose rows TMA
  cannot describe (a row stride that is not a multiple of 16 bytes, a
  base not 16-byte aligned), x with K not contiguous, or a y whose rows
  are not a multiple of 16 bytes, gets a zero-padded copy
  (``LAUNCHES["int8_matmul_pad"]``): zeros add nothing to the integer
  sum, so the result stays exact.  :func:`_int8_plan` tiles the call.
  There is no shape routing: the reference sends shapes with
  ``K % 128``, ``N % 128`` or ``K * N > 8M`` to XLA, a rule of the TPU's
  VMEM that this kernel does not have;
- a CPU tensor runs :func:`int8_matmul_dequant_plain`.

The plain version sums in f64, which holds every int8 product sum below
2**53 exactly (CUDA has no integer ``mm``, and ``torch.matmul`` of int8
tensors wraps around), then rounds to f32 as XLA's s32 -> f32 does, so
the kernel and the plain version agree bit for bit.

``LAUNCHES`` counts kernel launches and operand copies; the plain
version counts nothing.  :func:`record_calls` collects the ``(M, K, N)``
of every call, on either route, while it is open.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.telemetry.kernels import accounted

__all__ = ["int8_cost", "int8_matmul_dequant", "int8_matmul_dequant_plain",
           "LAUNCHES", "reset_launches", "record_calls", "Int8Plan"]

Tensor = torch.Tensor

#: kernel launches, and the operand copies made for the kernel (a
#: K-major copy of w_q; a zero-padded copy of an operand or of y that
#: TMA cannot describe), since the last :func:`reset_launches`.  They
#: count what the host enqueues: a CUDA graph capture counts each launch
#: once, and a replay of the graph adds nothing.
LAUNCHES = {"int8_matmul": 0, "int8_matmul_w_relayout": 0,
            "int8_matmul_pad": 0}
_lock = threading.Lock()
_recorders: List[list] = []
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

_KB = 128        # K bytes per ring stage: one 128-byte swizzled row
_BM = 128        # large-M row tile: two consumer warpgroups of 64
_BW = 64         # swap-AB weight rows per block: one consumer warpgroup
SWAP_M = 64      # the swap-AB route takes M <= SWAP_M
#: the N integer wgmma (.s8) takes up to 64: multiples of 8 to 32, then 16
_MX = (8, 16, 24, 32, 48, 64)
_SMEM = 232448   # the most shared memory a block may ask for on an H100
_MISC = 2048 + 1024  # barriers and the scale slice, and the 1 KB alignment
_MAX_STAGES = 8
_MAX_PANEL = 48  # resident weight chunks the kernel has barriers for


def reset_launches():
    with _lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


class Int8Plan(NamedTuple):
    """How kernel 7 tiles one call.  ``swap``: the small-M route, where
    ``bm`` is MX (x's rows padded to an integer-wgmma N) and ``bn`` the
    64 weight rows of a block; else ``bm`` = 128 rows by ``bn`` columns
    per tile.  K is cut into ``kc`` chunks of 128 bytes; ``stages`` is the
    ring's depth; ``resident``: the block's (K, bn) weight panel is loaded
    once (large route); K is split into ``slices`` of ``per`` chunks
    (swap route); ``blocks`` is the grid."""
    swap: bool
    bm: int
    bn: int
    kc: int
    stages: int
    resident: bool
    per: int
    slices: int
    blocks: int


def _int8_smem(plan: Int8Plan) -> int:
    """Dynamic shared memory of a plan's block, as the kernel lays it
    out (``big::layout``, ``swp::layout`` in int8_matmul.cu)."""
    if plan.swap:
        return plan.stages * (_BW * _KB + plan.bm * _KB) + 256 * plan.bm \
            + _MISC
    stage = _BM * _KB + (0 if plan.resident else plan.bn * _KB)
    panel = plan.kc * plan.bn * _KB if plan.resident else 0
    return plan.stages * stage + panel + 512 * plan.bn + _MISC


def _int8_plan(m: int, k: int, n: int, sms: int) -> Int8Plan:
    """Kernel 7's tiling for an (m, k) @ (k, n) product on ``sms`` SMs.

    M <= :data:`SWAP_M` swaps A and B: blocks of 64 weight rows, x's rows
    padded to the next N integer wgmma takes (MX).  Where those N / 64
    tiles leave most SMs idle (2 * tiles < sms), K is split into up to
    sms // tiles slices of whole 128-byte chunks, each at least MX / 2
    chunks long: a slice then streams at least 16 times the bytes its s32
    partial adds into the workspace (64 * MX * 4), which is where a
    split paid on an H100 (``kernel_ab.py --sweep``: the MLP head
    (8, 8192, 1000) 0.0136 -> 0.0055 ms in 8 slices of 8 chunks, the fc
    (32, 2048, 1000) 0.0054 ms unsplit, 0.0067 in 8 slices of 2).

    Larger M takes 128-row tiles by the widest column tile of 256, 128
    and 64 (not past n rounded up to 64) whose tiles still number at
    least sms / 2 and whose block fits with a ring of 4 stages; else 64
    columns.  The weight panel stays resident where it is at most two
    chunks (K <= 256) and fits; with a longer K its up-front load cost
    more than the L2 re-reads of the weight it saves.  The ring is as
    deep as fits, at most 8 stages (on the swap route at most the chunks
    a block walks); the persistent grid is one block per SM, rounded down
    to a multiple of the column tiles."""
    kc = -(-k // _KB)
    if m <= SWAP_M:
        mx = next(v for v in _MX if v >= m)
        tiles = -(-n // _BW)
        slices = 1
        if 2 * tiles < sms:
            slices = max(1, min(sms // tiles, kc // max(1, mx // 2)))
        per = -(-kc // slices)
        slices = -(-kc // per)
        stage = _BW * _KB + mx * _KB
        stages = min(_MAX_STAGES, per,
                     (_SMEM - _MISC - 256 * mx) // stage)
        return Int8Plan(True, mx, _BW, kc, stages, False, per, slices,
                        tiles * slices)
    rows = -(-m // _BM)

    def fit(bn: int, resident: bool) -> int:
        plan = Int8Plan(False, _BM, bn, kc, 0, resident, kc, 1, 0)
        room = _SMEM - _int8_smem(plan)
        stage = _BM * _KB + (0 if resident else bn * _KB)
        return min(_MAX_STAGES, room // stage) if room > 0 else 0

    choice = 64, False  # 64 columns fit without a panel at any K
    for bn in (256, 128, 64):
        if bn > 64 and (bn > -(-n // 64) * 64
                        or 2 * rows * -(-n // bn) < sms):
            continue
        resident = kc <= 2 and fit(bn, True) >= 4
        if resident or fit(bn, False) >= 4:
            choice = bn, resident
            break
    bn, resident = choice
    cols = -(-n // bn)
    blocks = min(rows * cols, max(1, sms // cols) * cols)
    return Int8Plan(False, _BM, bn, kc, fit(bn, resident), resident, kc, 1,
                    blocks)


def _operand_fix(k: int, k_stride: int, rows: int, row_stride: int,
                 ptr: int) -> str:
    """What an operand read as ``rows`` rows of ``k`` int8 values needs
    before TMA can load it: ``"relayout"`` where K is not the contiguous
    axis, ``"pad"`` where the rows are not 16-byte aligned (the row
    stride, unless there is one row, or the base address), else
    ``"ok"``."""
    if k > 1 and k_stride != 1:
        return "relayout"
    if (rows > 1 and row_stride % 16) or ptr % 16:
        return "pad"
    return "ok"


def _k_major(t: Tensor, k: int) -> Tuple[Tensor, int]:
    """A zero-padded copy of ``t`` (rows, k) with K contiguous and rows of
    a multiple of 16 bytes; returns it and its row stride."""
    kp = -(-k // 16) * 16
    buf = torch.zeros((t.shape[0], kp), dtype=torch.int8, device=t.device)
    buf[:, :k] = t
    return buf, kp


def _rows(t: Tensor, k: int, counter: str) -> Tuple[Tensor, int]:
    """``t`` (rows, k) as TMA reads it: itself or a counted copy, and its
    row stride in bytes."""
    fix = _operand_fix(k, t.stride(1), t.shape[0], t.stride(0),
                       t.data_ptr())
    if fix == "ok":
        return t, (t.stride(0) if t.shape[0] > 1 else -(-k // 16) * 16)
    with _lock:
        LAUNCHES[counter if fix == "relayout" else "int8_matmul_pad"] += 1
    return _k_major(t, k)


_workspaces: Dict[int, Tuple[Tensor, Tensor]] = {}


def _workspace(device) -> Tuple[Tensor, Tensor]:
    """The split-K workspace of ``device``, allocated once: s32 sums for
    ``sms`` tiles of 64 x 64 (a split call has fewer than sms / 2 tiles)
    and one arrival counter per tile, all 0 between calls (the last slice
    of a tile puts them back).  Calls on one device share it, so they
    must be ordered, as calls on one stream are.  It is allocated outside
    any CUDA graph capture (``utils/graphs.py`` ``prepare`` does it before
    capturing): memory allocated during a capture belongs to the graph's
    pool, so a first call inside one raises rather than cache it."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _lock:
        ws = _workspaces.get(index)
        if ws is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "int8_matmul: the split-K workspace is first needed "
                    "inside a CUDA graph capture; allocate it before "
                    "capturing (bigdl_tpu_torch.utils.graphs.prepare)")
            sms = _sms(device)
            ws = (torch.zeros(sms * _BW * _MX[-1], dtype=torch.int32,
                              device=device),
                  torch.zeros(sms, dtype=torch.int32, device=device))
            _workspaces[index] = ws
    return ws


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    x, lda = _rows(x_q, k, "int8_matmul_pad")
    w, ldw = _rows(w_q.t(), k, "int8_matmul_w_relayout")
    scale = scale_row.reshape(-1).to(torch.float32).contiguous()
    plan = _int8_plan(m, k, n, _sms(x_q.device))
    ws, cnt = _workspace(x_q.device)
    if plan.slices > 1 and -(-n // _BW) > cnt.numel():
        raise ValueError(f"{name}: a split of {-(-n // _BW)} tiles exceeds "
                         f"the workspace's {cnt.numel()}")
    es = torch.finfo(out_dtype).bits // 8
    ldy = n if (n * es) % 16 == 0 else -(-n * es // 16) * 16 // es
    y = torch.empty((m, ldy), dtype=out_dtype, device=x_q.device)
    fn = getattr(_build.load(name), f"int8_matmul_dequant_{_SUFFIX[out_dtype]}")
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
             ws.data_ptr(), cnt.data_ptr(), m, k, n, lda, ldw, ldy,
             int(plan.swap), plan.bm, plan.bn, plan.stages, plan.per,
             plan.blocks, int(plan.resident),
             torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check(err, name)
    with _lock:
        LAUNCHES[name] += 1
        if ldy != n:
            LAUNCHES["int8_matmul_pad"] += 1
    return y if ldy == n else y[:, :n].contiguous()


def int8_cost(m: int, k: int, n: int, out_size: int):
    """Kernel 7's ``(operations, bytes)``: 2*M*N*K int8 operations; x_q,
    w_q and the f32 scale read once, y (``out_size`` bytes per element)
    written once."""
    return 2 * m * n * k, m * k + k * n + 4 * n + out_size * m * n


@accounted("int8_matmul", lambda x_q, *a, **k: x_q,
           lambda x_q, w_q, scale_row, out_dtype=torch.bfloat16: int8_cost(
               *x_q.shape, w_q.shape[1],
               torch.finfo(out_dtype).bits // 8))
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
