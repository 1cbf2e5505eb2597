"""Parity of the port's fused matmul / 3x3 conv (bigdl_tpu_torch.ops)
with the JAX package's (bigdl_tpu.ops.pallas.fused_matmul).

The same numpy inputs go through the JAX function, on its XLA path
(``interpret=None`` on the CPU) and through the Pallas kernel in
interpret mode (``interpret=True``), and through the port's wrapper on
CPU tensors, which runs the kernel's plain PyTorch version.  The CUDA
kernels themselves are held against that plain version on the card by
``chip_smoke.py``.

Tolerances: f32 ``rtol=atol=1e-5`` (the same f32 products summed in
another order).  bf16 ``rtol=atol=1e-2``: both sides round the same f32
accumulator to bf16, so they differ by at most one bf16 step (2**-8
relative) where the summation order moves a value across a rounding
boundary.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.ops.pallas import fused_matmul as jfm
from bigdl_tpu_torch.ops import fused_matmul as tfm

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _operands(rs, x_shape, w_shape, prologue):
    c = x_shape[-1]
    x = rs.randn(*x_shape).astype(np.float32)
    w = (rs.randn(*w_shape) / np.sqrt(np.prod(w_shape[:-1]))).astype(
        np.float32)
    ps = (rs.rand(c) + 0.5).astype(np.float32) if prologue else None
    pb = rs.randn(c).astype(np.float32) if prologue else None
    return x, w, ps, pb


def _jax(fn, x, w, ps, pb, relu, interpret, dtype=jnp.float32):
    out = fn(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
             None if ps is None else jnp.asarray(ps),
             None if pb is None else jnp.asarray(pb),
             relu=relu, interpret=interpret)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _torch(fn, x, w, ps, pb, relu, dtype=torch.float32):
    out = fn(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
             None if ps is None else torch.from_numpy(ps),
             None if pb is None else torch.from_numpy(pb), relu=relu)
    return [o.float().numpy() for o in out]


def _assert_close(got, want, tol):
    for g, w, what in zip(got, want, ("y", "ssum", "ssq")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, err_msg=what, **tol)


# m=96 tiles into 3 Pallas row blocks; m=147 (3 x 7x7, ragged) does not
# tile, so there the JAX side takes its XLA path under both settings
@pytest.mark.parametrize("m", [96, 147])
@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("prologue,relu", [(False, False), (True, False),
                                           (True, True)])
def test_fused_matmul_bn_matches_jax(m, interpret, prologue, relu):
    rs = np.random.RandomState(m)
    x, w, ps, pb = _operands(rs, (m, 16), (16, 24), prologue)
    want = _jax(jfm.fused_matmul_bn, x, w, ps, pb, relu, interpret)
    got = _torch(tfm.fused_matmul_bn, x, w, ps, pb, relu)
    _assert_close(got, want, F32)


@pytest.mark.parametrize("x_shape", [(2, 6, 6, 8), (1, 5, 7, 8)])
@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("prologue,relu", [(False, False), (True, False),
                                           (True, True)])
def test_fused_conv3x3_bn_matches_jax(x_shape, interpret, prologue, relu):
    rs = np.random.RandomState(x_shape[0])
    x, w, ps, pb = _operands(rs, x_shape, (3, 3, 8, 16), prologue)
    want = _jax(jfm.fused_conv3x3_bn, x, w, ps, pb, relu, interpret)
    got = _torch(tfm.fused_conv3x3_bn, x, w, ps, pb, relu)
    _assert_close(got, want, F32)


def test_conv3x3_halo_is_zero_after_the_prologue():
    """A 1x1 image: only the centre tap sees data.  A halo padded before
    the prologue would add relu(pb) @ w from the 8 border taps."""
    rs = np.random.RandomState(3)
    x, w, ps, pb = _operands(rs, (1, 1, 1, 8), (3, 3, 8, 8), True)
    pb = np.abs(pb) + 1.0  # relu(pb) > 0 everywhere
    y, _, _ = _torch(tfm.fused_conv3x3_bn, x, w, ps, pb, True)
    u = np.maximum(x[0, 0, 0] * ps + pb, 0)
    np.testing.assert_allclose(y[0, 0, 0], u @ w[1, 1], **F32)


@pytest.mark.parametrize("kind", ["matmul", "conv3x3"])
def test_bf16_matches_jax(kind):
    rs = np.random.RandomState(7)
    if kind == "matmul":
        fns = (jfm.fused_matmul_bn, tfm.fused_matmul_bn)
        x, w, ps, pb = _operands(rs, (147, 32), (32, 16), True)
    else:
        fns = (jfm.fused_conv3x3_bn, tfm.fused_conv3x3_bn)
        x, w, ps, pb = _operands(rs, (2, 7, 7, 16), (3, 3, 16, 16), True)
    want = _jax(fns[0], x, w, ps, pb, True, None, jnp.bfloat16)
    got = _torch(fns[1], x, w, ps, pb, True, torch.bfloat16)
    # stats come from the f32 accumulator on both sides: f32 tolerance
    # relative to the column scale
    np.testing.assert_allclose(got[0], want[0], **BF16)
    for g, wv in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, wv, rtol=1e-4,
                                   atol=1e-4 * np.abs(wv).max())


def test_bn_constants_match_jax():
    rs = np.random.RandomState(4)
    ssum, ssq = rs.randn(8) * 10, rs.rand(8) * 100 + 50
    gamma, beta = rs.rand(8) + 0.5, rs.randn(8)
    want = jfm.bn_constants(*(jnp.asarray(v, jnp.float32)
                              for v in (ssum, ssq)), 32.0,
                            jnp.asarray(gamma, jnp.float32),
                            jnp.asarray(beta, jnp.float32), 1e-5)
    got = tfm.bn_constants(*(torch.tensor(v, dtype=torch.float32)
                             for v in (ssum, ssq)), 32.0,
                           torch.tensor(gamma, dtype=torch.float32),
                           torch.tensor(beta, dtype=torch.float32), 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    tfm.reset_launches()
    x = torch.randn(16, 8)
    w = torch.randn(8, 8)
    got = tfm.fused_matmul_bn(x, w, relu=False)
    want = tfm.fused_matmul_bn_plain(x, w, relu=False)
    for g, v in zip(got, want):
        assert torch.equal(g, v)
    assert all(v == 0 for v in tfm.LAUNCHES.values())


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(16, 8, device="meta")
    w = torch.empty(8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_matmul_bn(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_conv3x3_bn(torch.empty(1, 4, 4, 8, device="meta"),
                             torch.empty(3, 3, 8, 8, device="meta"))


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tfm.fused_matmul_bn(torch.zeros(4, 8), torch.zeros(6, 8))
    with pytest.raises(ValueError):
        tfm.fused_conv3x3_bn(torch.zeros(1, 4, 4, 8),
                             torch.zeros(1, 1, 8, 8))
