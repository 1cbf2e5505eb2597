"""Sequence (context) parallelism: ring attention and Ulysses all-to-all
(counterpart of bigdl_tpu/parallel/sequence.py).

Both take this rank's block of a sequence split over the ``seq`` axis,
``(B, H, T / n, D)`` (heads already split over ``model`` under tensor
parallelism), and return this rank's block of the output:

* :func:`ring_attention` keeps the query block and rotates the K/V
  blocks around the axis (``comm.ppermute``, whose backward rotates the
  cotangents back), accumulating the softmax blockwise with the running
  max and denominator (``_blockwise_update``, JAX's, ``-inf`` masks and
  its guards for fully masked rows); the causal mask comes from global
  positions.  Its products are plain torch matmuls, as JAX computes them
  outside any Pallas kernel.
* :func:`ulysses_attention` swaps the split from the sequence to the
  heads (``comm.all_to_all``), runs ``ops.attention.dot_product_attention``
  (the flash kernel, kernel 6, on the card) over whole sequences with
  ``H / n`` heads, and swaps back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.ops.attention import dot_product_attention
from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh

__all__ = ["RingSelfAttention", "ring_attention", "ulysses_attention"]

_NEG_INF = float("-inf")


def _blockwise_update(o, m, l, scores, v_blk):
    """One streaming-softmax step: ``o`` (B,H,Tq,Dv) the unnormalised
    output, ``m``/``l`` (B,H,Tq,1) the running max and denominator,
    ``scores`` (B,H,Tq,Tk) one key block's."""
    m_blk = scores.amax(-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    # all -inf rows (a fully masked block): no NaN from -inf - -inf
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - m_safe)
    p = torch.where(torch.isfinite(scores), p, 0.0)
    finite = torch.isfinite(m)
    correction = torch.exp(torch.where(finite, m - m_safe, _NEG_INF))
    correction = torch.where(finite, correction, 0.0)
    l_new = l * correction + p.sum(-1, keepdim=True)
    o_new = o * correction + torch.einsum("bhqk,bhkd->bhqd", p,
                                          v_blk.to(p.dtype))
    return o_new, m_new, l_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, causal: bool = False,
                   scale: Optional[float] = None,
                   axis_name: str = SEQ_AXIS) -> torch.Tensor:
    """Exact attention of this rank's query block over every rank's K/V
    blocks, which travel the ring once (``n_ring`` steps)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    n_ring = mesh.shape[axis_name]
    my_idx = mesh.rank(axis_name)
    b, h, t_loc, _ = q.shape
    dev = q.device
    q_pos = my_idx * t_loc + torch.arange(t_loc, device=dev)
    o = torch.zeros((b, h, t_loc, v.shape[-1]), dtype=torch.float32,
                    device=dev)
    m = torch.full((b, h, t_loc, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, t_loc, 1), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for step in range(n_ring):
        # after `step` shifts by +1 this rank holds block my_idx - step
        src = (my_idx - step) % n_ring
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                              k_cur.float()) * scale
        if causal:
            k_pos = src * t_loc + torch.arange(t_loc, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores, _NEG_INF)
        o, m, l = _blockwise_update(o, m, l, scores, v_cur)
        if step + 1 < n_ring:  # the last rotation's blocks go unused
            k_cur = comm.ppermute(k_cur, mesh, axis_name)
            v_cur = comm.ppermute(v_cur, mesh, axis_name)
    return (o / torch.clamp_min(l, 1e-30)).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, causal: bool = False,
                      scale: Optional[float] = None,
                      axis_name: str = SEQ_AXIS) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): sequence
    blocks to head groups, attention over whole sequences, and back.
    The per-rank heads must divide over the axis."""
    n = mesh.shape[axis_name]
    assert q.shape[1] % n == 0, (
        f"per-device heads ({q.shape[1]}) must divide the seq axis size "
        f"({n})")
    qf, kf, vf = (comm.all_to_all(x, mesh, axis_name, 1, 2)
                  for x in (q, k, v))
    of = dot_product_attention(qf, kf, vf, causal=causal, scale=scale)
    return comm.all_to_all(of, mesh, axis_name, 2, 1)


class RingSelfAttention:
    """The attention core of ``MultiHeadAttention`` under a ``seq_mesh``:
    the mesh and mode bound, called on ``(q, k, v)`` blocks."""

    MODES = ("ring", "ulysses")

    def __init__(self, mesh: Mesh, causal: bool = False, mode: str = "ring"):
        if mode not in self.MODES:
            raise ValueError(f"unknown sequence-parallel mode {mode!r}; "
                             f"expected one of {self.MODES}")
        self.mesh = mesh
        self.causal = causal
        self.mode = mode

    def __call__(self, q, k, v, **kw):
        fn = ring_attention if self.mode == "ring" else ulysses_attention
        return fn(q, k, v, self.mesh, causal=self.causal)
