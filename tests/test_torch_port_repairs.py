"""Five faults of the port against the JAX package, held on the CPU.

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
- Flash head dims above 128: the kernel takes D = 256 (key blocks of
  ``BLOCK_K_WIDE``, 64) and zero-pads 128 < D < 256 to it.  The plain
  version at D 256 and the padded one at D 200 against JAX's XLA path
  (``_xla_attention_lse``, not the interpret kernel: tier-1's budget),
  causal and not: f32 within 1e-5 of max|O| (max|lse|); bf16 within one
  bf16 step at the largest |O| (|lse|): XLA rounds p once against the
  exact row logsumexp, the port against each key block's running max,
  and XLA does not round ``q * sm_scale`` (measured: half a step to one
  step of O, 6e-4 of max|lse| at D 200, whose scale is not a power of
  two).  Then one Adam step of a Transformer LM with one head of 256
  (``transformer_train --numHeads 1`` at a tiny vocabulary, filter and
  depth) against the JAX step in f32 (loss, parameters, Adam's m and v
  within 1e-5 relative L2 per leaf), and `transformer_train.main` on the CPU.
- Channel widths that are not multiples of 8: on the card kernels 1-5
  run on zero-padded channels (``_padded_forward``, ``_padded_dgrad``,
  ``_padded_wgrad``).  The helpers around the plain versions against the
  plain versions themselves, bit for bit: y, ssum, ssq, dx, d_ps, d_pb
  and dW, with dyadic inputs (multiples of 1/8 of a few bits) so every
  sum is exact whatever its order (the padded and unpadded reductions
  take other orders).  A ``FusedBottleneck`` of width 12 (12 -> 3 -> 3
  -> 12) in training against the JAX block, forward and every gradient
  within 2e-4 (the block tolerance of test_torch_train_layers.py), with
  the plain versions as they are and wrapped in the padding helpers.
"""
import math
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ops.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.pallas import fused_matmul as jfm
from bigdl_tpu import optim as joptim
from bigdl_tpu.ops.pallas.flash_attention import _xla_attention_lse
from bigdl_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash
from bigdl_tpu.optim.optimizer import make_train_step as jax_make_train_step
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.models import transformer_train
from bigdl_tpu_torch.ops import dot_product_attention
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import fused_matmul as tfm
from bigdl_tpu_torch.utils import (flatten, load_jax_variables,
                                   random_variables)

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


# ------------------------------------------------ flash, D above 128
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [256, 200])
def test_wide_head_dim_matches_jax_xla_attention(d, causal, dt):
    tdt, jdt = DT[dt]
    rs = np.random.RandomState(d + causal)
    q, k, v = (rs.randn(1, 2, 160, d).astype(np.float32) for _ in range(3))
    want, want_lse = _xla_attention_lse(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal,
        1.0 / np.sqrt(d))
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    if d in fa._HEAD_DIMS:
        o, lse = fa.flash_attention_plain(tq, tk, tv, causal)
    else:  # the card's route: zero-padded to 256
        o, lse = fa._padded(fa.flash_attention_plain, tq, tk, tv, causal,
                            1.0 / np.sqrt(d))
    assert tuple(o.shape) == (1, 2, 160, d) and o.dtype == tdt
    _close(o.float(), want.astype(jnp.float32), TOL[dt], "O")
    _close(lse, want_lse, TOL[dt], "lse")


def test_wide_head_dim_blocks_keys_as_the_kernel():
    """Above D 128 the plain version steps the wide kernel's 64 keys:
    the bf16 result differs from a 128-key blocking (p rounds against
    another running max) and equals an explicit 64-key one."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.tensor(rs.randn(1, 1, 256, 256), dtype=torch.bfloat16)
               for _ in range(3))
    o, _ = fa.flash_attention_plain(q, k, v)
    assert torch.equal(o, fa.flash_attention_plain(
        q, k, v, block_k=fa.BLOCK_K_WIDE)[0])
    assert not torch.equal(o, fa.flash_attention_plain(
        q, k, v, block_k=fa.BLOCK_K)[0])


LM1 = dict(vocab_size=50, hidden_size=256, num_heads=1, filter_size=64,
           num_layers=1, dropout=0.0)


def test_one_head_of_256_lm_step_matches_jax():
    jm = jnn.Transformer(**LM1)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(4)

    def fill(path, a):
        if a.ndim == 2:
            return (rs.randn(*a.shape) / math.sqrt(a.shape[0])
                    ).astype(np.float32)
        scale = 1.0 if getattr(path[-1], "key", "") == "weight" else 0.0
        return (scale + 0.1 * rs.randn(*a.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, tree)
    tm = tnn.Transformer(**LM1)
    load_jax_variables(tm, v)
    x, y = (rs.randint(0, LM1["vocab_size"], (2, 160)) for _ in range(2))
    jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(logits=True))
    tcrit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(logits=True))
    jstep = jax.jit(jax_make_train_step(
        jm, jcrit, {"__all__": joptim.Adam(1e-3)}, grad_clip_norm=1.0))
    jp, _, jo, jl = jstep(v["params"], v["state"],
                          {"__all__": joptim.Adam(1e-3).init_state(
                              v["params"])}, jnp.asarray(1, jnp.int32), None,
                          jnp.asarray(x), jnp.asarray(y),
                          [jnp.asarray(1e-3, jnp.float32)])
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tstep = toptim.make_train_step(tm, tcrit,
                                   {"__all__": toptim.Adam(1e-3)},
                                   grad_clip_norm=1.0)
    tp, _, to, tl = tstep(params, {}, {"__all__": toptim.Adam(1e-3)
                                       .init_state(params)}, 1, None,
                          torch.tensor(x), torch.tensor(y), [1e-3])
    assert abs(float(tl) - float(jl)) < 1e-5 * abs(float(jl))

    def rel(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    for got, want in ((tp, jp), (to["__all__"]["m"], jo["__all__"]["m"]),
                      (to["__all__"]["v"], jo["__all__"]["v"])):
        want = flatten(jax.tree_util.tree_map(np.asarray, want))
        assert got.keys() == want.keys()
        for key in want:
            assert rel(got[key].numpy(), want[key]) < 1e-5, key


def test_transformer_train_with_one_head_runs_on_the_cpu():
    res = transformer_train.main([
        "--device", "cpu", "--maxEpoch", "1", "-b", "2", "--seqLen", "80",
        "--vocabSize", "50", "--hiddenSize", "256", "--numHeads", "1",
        "--filterSize", "64", "--numLayers", "1", "--syntheticSize",
        "1000"])
    assert math.isfinite(res["val_loss"]) and res["perplexity"] < 50


# ------------------------------------- channel widths off a multiple of 8
def _dyadic(rs, *shape):
    """Multiples of 1/8 in [-2, 2]: products and sums stay exact in f32."""
    return torch.tensor(rs.randint(-16, 17, shape) / 8.0,
                        dtype=torch.float32)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co", [(12, 20), (12, 16), (16, 12), (7, 3)])
def test_channel_padding_equals_the_unpadded_plain_version(c, co, dt):
    rs = np.random.RandomState(c * co)
    x, w = _dyadic(rs, 37, c).to(dt), _dyadic(rs, c, co).to(dt)
    x4, w4 = _dyadic(rs, 2, 5, 6, c).to(dt), _dyadic(rs, 3, 3, c, co).to(dt)
    ps, pb = _dyadic(rs, c), _dyadic(rs, c)
    dy, y = _dyadic(rs, 37, co).to(dt), _dyadic(rs, 37, co).to(dt)
    dy4, y4 = (_dyadic(rs, 2, 5, 6, co).to(dt) for _ in range(2))
    ds, dq = _dyadic(rs, co), _dyadic(rs, co) / 8

    def same(got, want, what):
        assert len(got) == len(want)
        for i, (g, w_) in enumerate(zip(got, want)):
            assert g.shape == w_.shape and g.dtype == w_.dtype, (what, i)
            assert g.is_contiguous(), (what, i)
            assert torch.equal(g, w_), (what, i)

    for fn, args in ((tfm.fused_matmul_bn_plain, (x, w, ps, pb, True)),
                     (tfm.fused_matmul_bn_plain, (x, w, None, None, True)),
                     (tfm.fused_conv3x3_bn_plain, (x4, w4, ps, pb, True))):
        same(tfm._padded_forward(fn, *args), fn(*args), fn.__name__)
    for fn, args in (
            (tfm.fused_matmul_bn_dgrad_plain,
             (dy, y, ds, dq, w, x, ps, pb, True)),
            (tfm.fused_conv3x3_bn_dgrad_plain,
             (dy4, y4, ds, dq, w4, x4, ps, pb, True))):
        same(tfm._padded_dgrad(fn, *args), fn(*args), fn.__name__)
    got = tfm._padded_dgrad(tfm.fused_matmul_bn_dgrad_plain, dy, y, ds, dq,
                            w, x, None, None, True)
    assert got[1] is None and got[2] is None
    fn = tfm.fused_matmul_bn_wgrad_plain
    args = (x, ps, pb, dy, y, ds, dq, True)
    same((tfm._padded_wgrad(fn, *args),), (fn(*args),), "wgrad")


def test_no_padding_and_no_copy_at_multiples_of_8():
    x = torch.zeros(4, 16)
    assert tfm._pad8(x).shape == (4, 16) and tfm._pad8(None) is None
    assert tfm._pad8(torch.zeros(3, 3, 12, 20), -2, -1).shape == \
        (3, 3, 16, 24)
    tfm.reset_launches()
    assert not tfm._count_pad((64, 256))
    assert tfm.COPIES["fused_channel_pad"] == 0
    assert tfm._count_pad((12, 16))
    assert tfm.COPIES["fused_channel_pad"] == 1
    tfm.reset_launches()
    assert tfm.COPIES["fused_channel_pad"] == 0


@pytest.fixture(params=["plain", "padded"])
def channel_route(request, monkeypatch):
    """The plain versions as the CPU runs them, or wrapped in the padding
    helpers as the card runs the kernels at these widths."""
    if request.param == "padded":
        for name, helper in (
                ("fused_matmul_bn_plain", tfm._padded_forward),
                ("fused_conv3x3_bn_plain", tfm._padded_forward),
                ("fused_matmul_bn_dgrad_plain", tfm._padded_dgrad),
                ("fused_conv3x3_bn_dgrad_plain", tfm._padded_dgrad),
                ("fused_matmul_bn_wgrad_plain", tfm._padded_wgrad)):
            fn = getattr(tfm, name)
            monkeypatch.setattr(
                tfm, name, lambda *a, _f=fn, _h=helper: _h(_f, *a))
    return request.param


def test_width_12_fused_bottleneck_training_matches_jax(channel_route):
    rs = np.random.RandomState(12)
    j = jnn.FusedBottleneck(12, 3, 1)
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, j.init(jax.random.PRNGKey(0))), 12)
    x = rs.randn(2, 6, 6, 12).astype(np.float32)
    cot = rs.randn(2, 6, 6, 12).astype(np.float32)

    def scalar(params, xx):
        out, _ = j.apply(params, v["state"], xx, training=True)
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(
        scalar, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    t = tnn.FusedBottleneck(12, 3, 1, remat=False)
    load_jax_variables(t, v)
    xt = torch.tensor(x, requires_grad=True)
    out = t.train()(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    block = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **block)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **block)
    grads = flatten(jax.tree_util.tree_map(np.asarray, gp))
    named = dict(t.named_parameters())
    assert grads.keys() == named.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g, err_msg=k,
                                   **block)
