"""The data gradients of the fused matmul and 3x3 conv (kernels 2 and 5)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
saved forward output y and the cotangents are the same arrays on both
sides, fed straight to JAX's backward rules.

- NaN through the prologue's ReLU mask: with a NaN in x at row 37,
  channel 5, the plain versions ``fused_matmul_bn_dgrad_plain`` and
  ``fused_conv3x3_bn_dgrad_plain`` give dx, d_ps and d_pb with NaN
  exactly where JAX's ``_fused_bwd`` / ``_conv3_bwd`` do, on their XLA
  path and on their Pallas kernels in interpret mode: ``pre > 0`` is
  False at a NaN, so g and dx are 0 there and d_pb stays finite, while
  d_ps carries ``0 * NaN``.  The finite values agree within 1e-5 of the
  largest |value| in f32 (sums in another order), and in bf16 within two
  bf16 steps of the largest |dx| and 1e-2 of the largest |d_ps|, |d_pb|
  (JAX's XLA conv rounds its product to bf16 before the mask).
- The weight as the bf16 kernels read it, in place: kernel 2 takes W (K,
  N) as the K-major B operand (row k of the tile is W's row k), and
  kernel 5 reads tap (dh, dw) as rows ((2-dh)*3 + (2-dw))*Ci of w viewed
  as (9*Ci, Co), over a window of pixels shifted by (dh - 1) rows and
  dw - 1 columns with the out-of-image taps zeroed after ytot.  That
  indexing, written out in PyTorch, gives the numbers of the copies the
  f32 path makes (``w.t().contiguous()``, the flipped io-swapped
  ``(9*Co, Ci)`` matrix) and of the plain versions, within 1e-5 of the
  largest |g| (f32, sums in another order).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.ops.pallas import fused_matmul as jfm
from bigdl_tpu_torch.ops import fused_matmul as tfm

DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = {"mm": ((96, 16), (16, 24)), "cv": ((2, 6, 6, 8), (3, 3, 8, 16))}


def _operands(kind, seed, nan=True):
    """x (with a NaN at row 37, channel 5), w, ps, pb, and the saved y
    and the cotangents dy, dssum, dssq at the scales a step gives."""
    rs = np.random.RandomState(seed)
    x_shape, w_shape = SHAPES[kind]
    x = rs.randn(*x_shape).astype(np.float32)
    if nan:
        x.reshape(-1, x_shape[-1])[37, 5] = np.nan
    w = (rs.randn(*w_shape) * 0.2).astype(np.float32)
    c, co = x_shape[-1], w_shape[-1]
    y_shape = x_shape[:-1] + (co,)
    m = int(np.prod(y_shape[:-1]))
    return dict(
        x=x, w=w, ps=(rs.rand(c) + 0.5).astype(np.float32),
        pb=(rs.randn(c) * 0.3).astype(np.float32),
        y=rs.randn(*y_shape).astype(np.float32),
        dy=(rs.randn(*y_shape) / np.sqrt(m)).astype(np.float32),
        dssum=(rs.randn(co) / m).astype(np.float32),
        dssq=(rs.randn(co) / m).astype(np.float32))


def _jax_dgrad(kind, o, dt, interpret):
    """dx, d_ps, d_pb from JAX's backward rule: the XLA path
    (interpret None) or the Pallas dgrad kernel in interpret mode."""
    jdt = DT[dt][1]
    res = tuple(jnp.asarray(o[k], jdt) for k in ("x", "w")) + tuple(
        jnp.asarray(o[k]) for k in ("ps", "pb")) + (jnp.asarray(o["y"], jdt),)
    cots = (jnp.asarray(o["dy"], jdt), jnp.asarray(o["dssum"]),
            jnp.asarray(o["dssq"]))
    if kind == "mm":
        bm = 32 if interpret else None
        dx, _, dps, dpb = jfm._fused_bwd(True, True, bm, bool(interpret),
                                         res, cots)
    else:
        bimg = 2 if interpret else None
        dx, _, dps, dpb = jfm._conv3_bwd(True, True, bimg, bool(interpret),
                                         res, cots)
    return dx, dps, dpb


def _torch_dgrad(kind, o, dt):
    tdt = DT[dt][0]
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    fn = (tfm.fused_matmul_bn_dgrad_plain if kind == "mm"
          else tfm.fused_conv3x3_bn_dgrad_plain)
    return fn(t["dy"].to(tdt), t["y"].to(tdt), t["dssum"], t["dssq"],
              t["w"].to(tdt), t["x"].to(tdt), t["ps"], t["pb"], relu=True)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("kind", ["mm", "cv"])
def test_dgrad_plain_versions_keep_a_nan_where_jax_does(kind, interpret,
                                                        dt):
    o = _operands(kind, 5)
    want = [_f32(a) for a in _jax_dgrad(kind, o, dt, interpret)]
    got = [_f32(a) for a in _torch_dgrad(kind, o, dt)]
    c = o["x"].shape[-1]
    for g, w, what in zip(got, want, ("dx", "d_ps", "d_pb")):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=what)
    # the mask zeroes g at the NaN: dx is 0 there, d_pb finite, and only
    # d_ps's channel carries the NaN
    assert got[0].reshape(-1, c)[37, 5] == 0.0
    assert not np.isnan(got[0]).any() and not np.isnan(got[2]).any()
    assert np.isnan(got[1]).tolist() == [i == 5 for i in range(c)]
    for g, w, what in zip(got, want, ("dx", "d_ps", "d_pb")):
        scale = np.nanmax(np.abs(w))
        if dt == "f32":
            tol = 1e-5 * scale
        elif what == "dx":
            tol = 2.0 ** (np.floor(np.log2(scale)) - 6)  # two bf16 steps
        else:
            tol = 1e-2 * scale
        err = np.nanmax(np.abs(g - w))
        assert err <= tol, (what, err, scale)


def _ytot(o, dtype):
    t = {k: torch.from_numpy(o[k]) for k in ("dy", "y", "dssum", "dssq")}
    return tfm._ytot(t["dy"], t["y"], t["dssum"], t["dssq"]).to(dtype)


def _close(got, want, what):
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= 1e-5 * scale, (what, err, scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_matmul_dgrad_reads_w_in_place(seed):
    o = _operands("mm", seed, nan=False)
    ytot = _ytot(o, torch.float32)  # (M, N)
    w = torch.from_numpy(o["w"])   # (K, N)
    k = w.shape[0]
    # kernel 2: column k of g is ytot against W's row k (K-major B)
    g_in_place = torch.stack([ytot @ w[i] for i in range(k)], dim=1)
    g_copy = ytot @ w.t().contiguous()  # the f32 path's B = W^T
    _close(g_in_place, g_copy, "in place vs copy")
    dx, dps, dpb = tfm._prologue_backward(
        g_in_place, torch.from_numpy(o["x"]), torch.from_numpy(o["ps"]),
        torch.from_numpy(o["pb"]), True)
    t = {k_: torch.from_numpy(v) for k_, v in o.items()}
    want = tfm.fused_matmul_bn_dgrad_plain(t["dy"], t["y"], t["dssum"],
                                           t["dssq"], t["w"], t["x"],
                                           t["ps"], t["pb"], relu=True)
    for g, w_, what in zip((dx, dps, dpb), want, ("dx", "d_ps", "d_pb")):
        _close(g, w_, what)


@pytest.mark.parametrize("shape", [(2, 6, 6, 8, 16), (1, 5, 7, 16, 8)])
def test_conv3_dgrad_reads_w_in_place(shape):
    b, h, wd, ci, co = shape
    rs = np.random.RandomState(sum(shape))
    o = dict(dy=rs.randn(b, h, wd, co).astype(np.float32),
             y=rs.randn(b, h, wd, co).astype(np.float32),
             dssum=rs.randn(co).astype(np.float32),
             dssq=rs.randn(co).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, ci, co) * 0.2).astype(np.float32))
    m = b * h * wd
    ytot = _ytot(o, torch.float32).reshape(m, co)
    p = torch.arange(m)
    oh, ow = (p // wd) % h, p % wd
    w9 = w.reshape(9 * ci, co)  # the bf16 kernel's view, no copy
    wf = w.flip(0, 1).transpose(2, 3).contiguous().reshape(9 * co, ci)
    g_in_place = torch.zeros(m, ci)
    g_copy = torch.zeros(m, ci)
    for tap in range(9):
        dh, dw = divmod(tap, 3)
        # the window: pixel p reads p + (dh - 1) W + dw - 1, 0 where the
        # tap leaves the image (after ytot)
        ih, iw = oh + dh - 1, ow + dw - 1
        valid = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd)
        src = (p + (dh - 1) * wd + dw - 1).clamp(0, m - 1)
        a = torch.where(valid[:, None], ytot[src], 0.0)
        g_in_place += a @ w9[(8 - tap) * ci:(9 - tap) * ci].t()
        g_copy += a @ wf[tap * co:(tap + 1) * co]  # the f32 path's B rows
    _close(g_in_place, g_copy, "in place vs copy")
    want = tfm._nhwc(torch.nn.functional.conv2d(
        tfm._nchw(ytot.reshape(b, h, wd, co)),
        w.flip(0, 1).transpose(2, 3).permute(3, 2, 0, 1),
        padding=1)).reshape(m, ci)
    _close(g_in_place, want, "in place vs the plain convolution")
