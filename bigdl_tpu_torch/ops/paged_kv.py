"""Paged (and optionally int8-quantized) KV-cache ops (counterpart of
bigdl_tpu/ops/paged_kv.py).

The dense decode cache (``MultiHeadAttention.init_cache``) holds
``max_len`` rows per slot.  The paged layout cuts each layer's cache into
fixed-size pages,

    pool  {"k": (P, Q, H, D), "v": (P, Q, H, D), "length": (S,)}
          [+ "k_scale"/"v_scale": (P, Q, H) f32 when int8-quantized]

with a per-slot block table ``(S, M)`` int32 mapping each slot's logical
page ``0..M-1`` to a physical page.  The table is kept on the host
(:mod:`bigdl_tpu_torch.serving.paging`) and enters a compiled tick as
data: its values change as pages move, its shape never does.

Physical page 0 is the trash page: it is never allocated, unmapped table
entries point at it, and writes of inactive slots and of positions past
the logical extent go to it.  Several such writes may hit one index in
one scatter; which one lands is unspecified, on either device, and page 0
is only ever read under the length mask.

int8 pools store K/V as int8 with a per-(token, head) scale (``amax /
127``, round half to even).  The QK^T of a query chunk against the int8
K is kernel 7's contract (int8 operand, per-output-column scale), so
where :func:`_int8_eligible` says so, :func:`int8_scores` runs it on
:func:`~bigdl_tpu_torch.ops.int8_matmul.int8_matmul_dequant`; elsewhere
the gather dequantizes and the plain attention runs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from bigdl_tpu_torch.ops.int8_matmul import int8_matmul_dequant

__all__ = ["num_logical_pages", "quantize_kv", "dequantize_kv",
           "init_pool", "is_quantized", "page_bytes", "flat_positions",
           "paged_append", "paged_gather", "paged_gather_q", "int8_scores",
           "scatter_rows"]

Tensor = torch.Tensor
Pool = Dict[str, Tensor]


def num_logical_pages(max_len: int, page_size: int) -> int:
    """Block-table width: logical pages covering ``max_len`` tokens."""
    return -(-max_len // page_size)


# ---------------------------------------------------------------- int8
def quantize_kv(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 quantization over the last axis: ``(q int8, scale
    f32)`` with ``scale.shape == x.shape[:-1]`` and ``q * scale`` the
    dequantized value (``amax / 127``, at least ``1e-8 / 127``)."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


# ---------------------------------------------------------------- pool
def init_pool(num_pages: int, page_size: int, num_heads: int,
              head_dim: int, batch: int, dtype=torch.float32,
              quantized: bool = False, device=None) -> Pool:
    """One attention layer's paged pool, zeros (page 0 is the trash
    page).  ``length`` is per slot, as in the dense cache."""
    shape = (num_pages, page_size, num_heads, head_dim)
    store = torch.int8 if quantized else dtype
    pool = {"k": torch.zeros(shape, dtype=store, device=device),
            "v": torch.zeros(shape, dtype=store, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}
    if quantized:
        pool["k_scale"] = torch.zeros(shape[:3], device=device)
        pool["v_scale"] = torch.zeros(shape[:3], device=device)
    return pool


def is_quantized(pool: Pool) -> bool:
    return "k_scale" in pool


def page_bytes(page_size: int, num_heads: int, head_dim: int,
               dtype=torch.float32, quantized: bool = False) -> int:
    """Bytes one physical page costs in one layer's pool (K, V and, when
    quantized, their f32 scales): the unit a server budgets pages in."""
    if quantized:
        per_tok = num_heads * head_dim * 2 + num_heads * 4 * 2
    else:
        per_tok = num_heads * head_dim * 2 * dtype.itemsize
    return page_size * per_tok


def flat_positions(table: Tensor, pos: Tensor, active: Tensor,
                   page_size: int, max_len: int) -> Tensor:
    """Logical positions ``pos`` (S, T) of the slots of ``table`` (S, M)
    as indices into the pool's flat ``(P * Q, ...)`` view.  Inactive rows
    (``active`` (S,) bool) and positions outside ``[0, max_len)`` land on
    the trash page (flat indices ``[0, Q)``)."""
    m = table.shape[1]
    logical = torch.div(pos, page_size, rounding_mode="floor")
    ok = (pos >= 0) & (pos < max_len) & active[:, None]
    phys = torch.gather(table, 1, logical.clamp(0, m - 1).to(torch.int64))
    within = torch.remainder(pos, page_size)
    return torch.where(ok, phys * page_size + within, within)


def _flat(leaf: Tensor) -> Tensor:
    """A pool leaf ``(P, Q, ...)`` as its ``(P * Q, ...)`` view."""
    return leaf.reshape((-1,) + tuple(leaf.shape[2:]))


def paged_append(pool: Pool, table: Tensor, active: Tensor, k_new: Tensor,
                 v_new: Tensor, page_size: int, max_len: int) -> Pool:
    """The pool with ``k_new``/``v_new`` (S, H, T, D) written at each
    slot's ``length .. length + T - 1`` (quantized when the pool is
    int8); a new dict of new leaves.  ``length`` is not advanced here:
    the layer owns it, as in the dense cache."""
    s, h, t, d = k_new.shape
    pos = pool["length"][:, None] + torch.arange(
        t, dtype=torch.int32, device=k_new.device)[None]
    idx = (flat_positions(table, pos, active, page_size, max_len)
           .reshape(s * t).to(torch.int64),)
    out = dict(pool)
    for name, new in (("k", k_new), ("v", v_new)):
        scatter_rows(out, name, idx,
                     new.transpose(1, 2).reshape(s * t, h, d))
    return out


def scatter_rows(pool: Pool, name: str, idx: tuple, vals: Tensor):
    """Put new leaves in ``pool`` (a dict, changed) with rows ``vals``
    (R, H, D) written at flat indices ``idx`` (a 1-tuple of (R,) int64)
    of leaf ``name`` ("k" or "v"), quantized with their scales into an
    int8 pool, else cast to the leaf's type."""
    leaf = pool[name]
    if is_quantized(pool):
        q, scale = quantize_kv(vals)
        pool[name] = _flat(leaf).index_put(idx, q).view(leaf.shape)
        sc = pool[name + "_scale"]
        pool[name + "_scale"] = _flat(sc).index_put(idx, scale).view(
            sc.shape)
    else:
        pool[name] = _flat(leaf).index_put(idx, vals.to(leaf.dtype)).view(
            leaf.shape)


def _extent(table: Tensor, page_size: int) -> Tensor:
    """Flat pool indices of every slot's whole logical extent:
    ``(S, M * Q)`` int64."""
    s, m = table.shape
    within = torch.arange(page_size, device=table.device)
    return (table.to(torch.int64)[:, :, None] * page_size
            + within[None, None]).reshape(s, m * page_size)


def _take(leaf: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` (S, L) of a pool leaf's flat view: ``(S, L, ...)``."""
    flat = _flat(leaf)
    return flat.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(flat.shape[1:]))


def paged_gather(pool: Pool, table: Tensor, page_size: int, dtype
                 ) -> Tuple[Tensor, Tensor]:
    """Each slot's whole logical extent: ``(k, v)``, each (S, H, M*Q, D)
    in ``dtype`` (dequantized from an int8 pool).  Entries past a slot's
    length come from unmapped or trash pages: callers mask by length."""
    idx = _extent(table, page_size)
    out = []
    for name in ("k", "v"):
        g = _take(pool[name], idx)                          # (S, L, H, D)
        if is_quantized(pool):
            g = dequantize_kv(g, _take(pool[name + "_scale"], idx), dtype)
        out.append(g.to(dtype).transpose(1, 2))
    return out[0], out[1]


def paged_gather_q(pool: Pool, table: Tensor, page_size: int
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The gather of the int8 score route: ``(k_q (S, H, L, D) int8,
    k_scale (S, H, L) f32, v (S, H, L, D) f32)``.  K stays quantized
    (kernel 7 applies its scale) and each (slot, head) block of ``k_q``
    is a contiguous (L, D), so kernel 7 reads its (D, L) transpose in
    place; V is dequantized for the plain PV product."""
    idx = _extent(table, page_size)
    k_q = _take(pool["k"], idx).transpose(1, 2).contiguous()
    k_s = _take(pool["k_scale"], idx).transpose(1, 2)
    v = dequantize_kv(_take(pool["v"], idx), _take(pool["v_scale"], idx),
                      torch.float32)
    return k_q, k_s, v.transpose(1, 2)


# ------------------------------------------------- int8 kernel routing
_ROW_TILES = (2048, 1024, 768, 512, 384, 256, 128, 64, 32, 16, 8)


def _int8_shape_ok(m: int, k: int, n: int) -> bool:
    """The JAX kernel's shape rule (bigdl_tpu/ops/pallas/int8_matmul.py
    ``candidate_params``): K and N multiples of 128, K * N at most 8 Mi,
    and a row tile that divides M within its 12 MiB budget."""
    if k % 128 or n % 128 or k * n > 8 * 1024 * 1024:
        return False
    return any(m % bm == 0 and bm * k + bm * n * 6 <= 12 * 1024 * 1024
               for bm in _ROW_TILES)


def _int8_eligible(tq: int, length: int, head_dim: int, device) -> bool:
    """Whether an int8 pool's QK^T takes kernel 7 (:func:`int8_scores`):
    the tensors lie on a CUDA device and both ``(tq, head_dim, length)``
    and ``(tq, length, head_dim)`` pass the JAX kernel's shape rule, as
    the JAX package decides on a TPU.  Decided from shapes and device
    before anything runs; a single-token step (tq 1) never is."""
    return (torch.device(device).type == "cuda"
            and _int8_shape_ok(tq, head_dim, length)
            and _int8_shape_ok(tq, length, head_dim))


def int8_scores(q: Tensor, k_q: Tensor, k_scale: Tensor,
                out_dtype=torch.float32) -> Tensor:
    """QK^T against int8 K on kernel 7: ``q`` (S, H, Tq, D) float,
    ``k_q`` (S, H, L, D) int8, ``k_scale`` (S, H, L) -> (S, H, Tq, L).

    q is quantized per tensor, over every slot and head, and its scale
    folded into each (slot, head)'s scale row: ``(q_q @ k_q.T) *
    (k_scale * q_scale)``, one kernel-7 product per (slot, head), with
    cache positions as the output columns."""
    qf = q.float()
    q_scale = qf.abs().amax().clamp_min(1e-8) / 127.0
    q_q = torch.round(qf / q_scale).clamp(-127, 127).to(
        torch.int8).contiguous()
    s, h = q.shape[:2]
    rows = [int8_matmul_dequant(q_q[i, j], k_q[i, j].t(),
                                (k_scale[i, j] * q_scale).float(),
                                out_dtype=torch.float32)
            for i in range(s) for j in range(h)]
    scores = torch.stack(rows).reshape(s, h, q.shape[2], k_q.shape[2])
    return scores.to(out_dtype)
