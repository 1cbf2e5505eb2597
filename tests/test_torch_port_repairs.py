"""Three faults of the port against the JAX package, held on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

- Causal attention with Tq != Tk: the flash kernel's causal mask is
  top-left and needs Tq == Tk, so ``dot_product_attention`` routes such a
  call to its plain path (bottom-right causal), as the JAX function does
  by catching the kernel's error.  Held against JAX's
  ``dot_product_attention`` and ``MultiHeadAttention``: f32 within 1e-5
  of max|O|, bf16 within one bf16 step at the largest |O| (both compute
  f32 scores and an f32 softmax, then round p and O to bf16).
- NaN through the prologue ReLU: the plain versions of kernels 1, 3 and
  4 put NaN exactly where JAX's functions do (``jnp.maximum`` keeps a
  NaN; so must the kernels, which ``chip_smoke.py`` checks on the card).
- Flash head dims the kernel does not take (D = 12, 8): the CUDA route
  zero-pads D to the next of 32/64/128 (``_padded``).  The padded plain
  computation, with ``sm_scale = 1/sqrt(true D)`` and O's extra columns
  dropped, against JAX's ``flash_attention`` in interpret mode at the
  same key block: f32 within 1e-5 of max|O|, bf16 within one bf16 step.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ops.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.pallas import fused_matmul as jfm
from bigdl_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.ops import dot_product_attention
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import fused_matmul as tfm
from bigdl_tpu_torch.utils import load_jax_variables

TOL = {"f32": lambda m: 1e-5 * m,
       "bf16": lambda m: 2.0 ** (np.floor(np.log2(m)) - 7)}  # one step
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol(scale), (what, err, scale)


# ------------------------------------------------------ causal, Tq != Tk
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_attention_with_shorter_queries_matches_jax(dt):
    tdt, jdt = DT[dt]
    rs = np.random.RandomState(0)
    q = rs.randn(1, 2, 3, 32).astype(np.float32)
    k, v = (rs.randn(1, 2, 5, 32).astype(np.float32) for _ in range(2))
    want = jax_dpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True)
    got = dot_product_attention(*(torch.tensor(a).to(tdt)
                                  for a in (q, k, v)), causal=True)
    assert got.dtype == tdt and tuple(got.shape) == (1, 2, 3, 32)
    _close(got.float(), want.astype(jnp.float32), TOL[dt], "O")


def test_causal_multi_head_attention_on_a_query_kv_pair_matches_jax():
    d, heads = 32, 4
    jm = jnn.MultiHeadAttention(d, heads, causal=True)
    tm = tnn.MultiHeadAttention(d, heads, causal=True)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)
    tree = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) / np.sqrt(a.shape[0])
                   ).astype(np.float32), tree)
    load_jax_variables(tm, tree)
    query = rs.randn(2, 6, d).astype(np.float32)
    kv = rs.randn(2, 10, d).astype(np.float32)
    want, _ = jm.apply(tree["params"], {}, (jnp.asarray(query),
                                            jnp.asarray(kv)))
    got = tm.eval()((torch.tensor(query), torch.tensor(kv)))
    _close(got.detach(), want, TOL["f32"], "MHA")


# ----------------------------------------------- NaN through the prologue
def _nan_operands(kind, seed):
    rs = np.random.RandomState(seed)
    if kind == "mm":
        x_shape, w_shape = (96, 16), (16, 24)
    else:
        x_shape, w_shape = (2, 6, 6, 8), (3, 3, 8, 16)
    x = rs.randn(*x_shape).astype(np.float32)
    x.reshape(-1, x_shape[-1])[37, 5] = np.nan  # one NaN in x
    w = (rs.randn(*w_shape) * 0.2).astype(np.float32)
    c = x_shape[-1]
    ps = (rs.rand(c) + 0.5).astype(np.float32)
    pb = (rs.randn(c) * 0.3).astype(np.float32)
    return x, w, ps, pb


def _same_nans(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isnan(want).any(), what  # the NaN reached the output
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("kind", ["mm", "cv"])
def test_forward_plain_versions_keep_a_nan_where_jax_does(kind, interpret):
    """Kernels 1 (matmul) and 4 (3x3 conv): y, ssum and ssq."""
    x, w, ps, pb = _nan_operands(kind, 2)
    jfn, plain = ((jfm.fused_matmul_bn, tfm.fused_matmul_bn_plain)
                  if kind == "mm" else
                  (jfm.fused_conv3x3_bn, tfm.fused_conv3x3_bn_plain))
    want = jfn(*(jnp.asarray(a) for a in (x, w, ps, pb)), relu=True,
               interpret=interpret)
    got = plain(*(torch.from_numpy(a) for a in (x, w, ps, pb)), relu=True)
    for g, wv, what in zip(got, want, ("y", "ssum", "ssq")):
        _same_nans(g, wv, what)


@pytest.mark.parametrize("interpret", [None, True])
def test_wgrad_plain_version_keeps_a_nan_where_jax_does(interpret):
    """Kernel 3: dW of the matmul, through ``jax.vjp`` on the JAX side."""
    x, w, ps, pb = _nan_operands("mm", 3)
    rs = np.random.RandomState(4)
    cy = rs.randn(96, 24).astype(np.float32)
    cs, cq = rs.randn(24).astype(np.float32), rs.randn(24).astype(np.float32)
    jx, jps, jpb = (jnp.asarray(a) for a in (x, ps, pb))
    _, vjp = jax.vjp(lambda w_: jfm.fused_matmul_bn(
        jx, w_, jps, jpb, relu=True, interpret=interpret), jnp.asarray(w))
    want = vjp(tuple(jnp.asarray(c) for c in (cy, cs, cq)))[0]
    tx, tw, tps, tpb = (torch.from_numpy(a) for a in (x, w, ps, pb))
    y, _, _ = tfm.fused_matmul_bn_plain(tx, tw, tps, tpb, relu=True)
    got = tfm.fused_matmul_bn_wgrad_plain(
        tx, tps, tpb, torch.from_numpy(cy), y, torch.from_numpy(cs),
        torch.from_numpy(cq), relu=True)
    _same_nans(got, want, "dW")


# -------------------------------------------------- flash, D not in 32/64/128
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [12, 8])
def test_padded_head_dim_matches_jax_flash(d, causal, dt):
    tdt, jdt = DT[dt]
    rs = np.random.RandomState(d + causal)
    q, k, v = (rs.randn(1, 2, 256, d).astype(np.float32) for _ in range(3))
    want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                     causal=causal, block_q=64, block_k=fa.BLOCK_K,
                     interpret=True)
    o, lse = fa._padded(fa.flash_attention_plain,
                        *(torch.tensor(a).to(tdt) for a in (q, k, v)),
                        causal, 1.0 / np.sqrt(d))
    assert tuple(o.shape) == (1, 2, 256, d) and o.dtype == tdt
    _close(o.float(), want.astype(jnp.float32), TOL[dt], "O")
    # the padding changes no score: lse equals the unpadded plain version's
    _, ref_lse = fa.flash_attention_plain(
        *(torch.tensor(a).to(tdt) for a in (q, k, v)), causal)
    _close(lse, ref_lse, TOL["f32"], "lse")
