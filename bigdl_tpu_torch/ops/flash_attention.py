"""Fused (flash) attention: bigdl_tpu/ops/pallas/flash_attention.py.

``flash_attention(q, k, v, causal=False, sm_scale=None)`` computes
``softmax(q k^T * sm_scale) v`` over ``(B, H, T, D)`` tensors without
materialising the ``(T, S)`` score matrix, and is differentiable:

- the forward is the online softmax over key blocks, returning O and the
  f32 row logsumexp ``lse`` of shape ``(B, H, T)``;
- the backward (``_flash_backward``) is the JAX package's
  ``_bwd_blockwise`` in plain PyTorch: the probabilities are recomputed
  from ``lse`` one block of query rows at a time, so memory stays
  O(block_q * S) with no ``(T, S)`` residual.  The JAX package has no
  backward kernel either (a ``lax.scan`` there, a Python loop here).

The forward takes one of two routes, decided by where ``q`` lies:

- a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/flash_attention.cu``) or raises.  The kernel takes D in
  {32, 64, 128}, bf16 or f32, any T and S (it masks the ragged edges
  itself), and the tensors' strides as they are, as long as D is
  contiguous and each row is 16-byte aligned; the transposed head views
  that ``MultiHeadAttention`` makes pass without a copy.  Any other
  layout is copied to a contiguous tensor first.  O is allocated with
  q's strides, so the attention output folds back into ``(N, T, H * D)``
  as a view;
- a CPU tensor runs :func:`flash_attention_plain`, which repeats the
  kernel's arithmetic block for block.

Rounding points, as the TPU kernel keeps them: ``sm_scale`` and
``q * sm_scale`` round to q's type before the product; scores, the
running max and sum and the accumulator are f32; ``p`` rounds to v's
type before ``p @ v``; the sum is clamped at 1e-30; O rounds once from
``acc / l``.  Masked scores are -1e30, never -inf.  Under causal the
mask is top-left (``q_pos >= k_pos``) and T must equal S.

``LAUNCHES`` counts kernel launches; the plain version does not count.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from bigdl_tpu_torch.ops import _build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse",
           "LAUNCHES", "reset_launches", "BLOCK_K"]

Tensor = torch.Tensor

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}
_launch_lock = threading.Lock()

BLOCK_K = 64     # keys per step of the kernel (csrc/flash_attention.cu BKV)
BLOCK_Q = 1024   # query rows per block of the backward (JAX's block_q)
NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def reset_launches():
    with _launch_lock:
        LAUNCHES["flash_attention"] = 0


def _scale(q: Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _in_type(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float.  A tensor times it
    rounds the exact product once (a product of two bf16 values is
    exact in the f32 arithmetic of the op), as the weakly typed product
    of a JAX array and a Python scalar does."""
    return float(torch.tensor(x, dtype=dtype))


def _check_shapes(q: Tensor, k: Tensor, v: Tensor, causal: bool):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    t, s = q.shape[2], k.shape[2]
    if causal and t != s:
        raise ValueError("causal flash attention needs matching q/kv "
                         f"lengths, got {t} vs {s}")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          causal: bool = False,
                          sm_scale: Optional[float] = None,
                          block_k: int = BLOCK_K) -> Tuple[Tensor, Tensor]:
    """The plain PyTorch version of the forward kernel: ``(O, lse)``.

    The online softmax of ``_attn_kernel`` (flash_attention.py:36-86)
    over key blocks of ``block_k``, with its rounding points.  All query
    rows go at once: a row's result depends only on the key blocking, so
    this equals the kernel's 64-row tiles.  A short last block is the
    kernel's masked ragged edge (a masked key adds exactly 0)."""
    _check_shapes(q, k, v, causal)
    t, s = q.shape[2], k.shape[2]
    qs = (q * _in_type(_scale(q, sm_scale), q.dtype)).float()
    shape = q.shape[:3] + (1,)
    m = torch.full(shape, NEG_INF, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(q.shape[:3] + (v.shape[3],), device=q.device)
    q_pos = torch.arange(t, device=q.device)[:, None]
    for k0 in range(0, s, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k]
        sc = torch.matmul(qs, kb.transpose(-1, -2))
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            sc = torch.where(q_pos >= k_pos, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _flash_backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                    g: Tensor, causal: bool, sm_scale: float,
                    block_q: int = BLOCK_Q):
    """``dq, dk, dv`` as ``_bwd_blockwise`` (flash_attention.py:151-188)
    computes them: ``delta = sum(o * g)`` in f32; per block of query
    rows the scores are recomputed in the input type (the einsum has no
    f32 accumulation type there), ``p = exp(s - lse)``, and ``dp``,
    ``dscore`` and the dk/dv sums are f32; all three are cast back to
    the input types at the end.  Any device: this is plain PyTorch."""
    t, s_len = q.shape[2], k.shape[2]
    scale = _in_type(sm_scale, q.dtype)
    delta = (o.float() * g.float()).sum(-1)
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dq = []
    k_pos = torch.arange(s_len, device=q.device)[None, :]
    for i in range(0, t, block_q):
        qs, gs = q[:, :, i:i + block_q], g[:, :, i:i + block_q].float()
        sc = torch.matmul(qs, k.transpose(-1, -2)) * scale
        if causal:
            q_pos = i + torch.arange(qs.shape[2], device=q.device)[:, None]
            sc = torch.where(q_pos >= k_pos, sc, NEG_INF)
        p = torch.exp(sc.float() - lse[:, :, i:i + block_q, None])
        dp = torch.matmul(gs, vf.transpose(-1, -2))
        dscore = p * (dp - delta[:, :, i:i + block_q, None]) * sm_scale
        dq.append(torch.matmul(dscore, kf))
        dk += torch.matmul(dscore.transpose(-1, -2), qs.float())
        dv += torch.matmul(p.transpose(-1, -2), gs)
    return (torch.cat(dq, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


# --------------------------------------------------------------------------
# kernel launch
# --------------------------------------------------------------------------
def _kernel_operand(t: Tensor) -> Tensor:
    """``t`` as the kernel reads it: D contiguous and every row 16-byte
    aligned, else a contiguous copy."""
    size = t.element_size()
    if t.stride(3) != 1 or any((st * size) % 16 for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _flash_forward_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        sm_scale: float) -> Tuple[Tensor, Tensor]:
    name = "flash_attention"
    if q.dtype not in _SUFFIX:
        raise TypeError(f"{name}: q must be bfloat16 or float32, got "
                        f"{q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: k and v must have q's dtype "
                            f"({q.dtype}), got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: q on {q.device} but k or v on "
                             f"{t.device}")
    if q.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: q is on {q.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    b, h, t, d = q.shape
    s = k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head dims {_HEAD_DIMS}, "
                         f"got {d}")
    if t == 0 or s == 0 or b * h == 0:
        raise ValueError(f"{name}: empty operand {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    o = torch.empty_like(q)  # q's strides: a (B, T, H, D) buffer stays one
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    strides = (ctypes.c_longlong * 12)(*(st for x in (q, k, v, o)
                                         for st in x.stride()[:3]))
    fn = getattr(_build.load(name), f"flash_attention_fwd_{_SUFFIX[q.dtype]}")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, h, t, s, d, strides, sm_scale, int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    with _launch_lock:
        LAUNCHES[name] += 1
    return o, lse


def flash_attention_lse(q: Tensor, k: Tensor, v: Tensor, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[Tensor, Tensor]:
    """The forward alone, ``(O, lse)``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor; any other device raises."""
    _check_shapes(q, k, v, causal)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _flash_forward_cuda(q, k, v, causal, scale)


class _Flash(torch.autograd.Function):
    """The JAX ``custom_vjp`` ``_flash``: forward ``(O, lse)``, backward
    :func:`_flash_backward` from the saved q, k, v, O and lse.  ``lse``
    is an auxiliary output and takes no cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_lse(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, _scale(q, sm_scale)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do, ctx.causal,
                                     ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = False,
                    sm_scale: Optional[float] = None) -> Tensor:
    """Fused attention over ``(B, H, T, D)`` tensors, returning O in q's
    type (``sm_scale`` defaults to ``1/sqrt(D)``).  Raises
    ``ValueError`` for causal attention with T != S, as the JAX
    function does."""
    return _Flash.apply(q, k, v, causal, sm_scale)[0]
