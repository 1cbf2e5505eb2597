"""Gradients of the port's fused matmul / 3x3 conv (bigdl_tpu_torch.ops)
against ``jax.grad`` of the JAX package's (bigdl_tpu.ops.pallas.
fused_matmul), and the plain backward versions against autograd.

On CPU tensors the port's autograd backward runs the plain versions of
kernels 2, 3 and 5 (``*_dgrad_plain``, ``*_wgrad_plain``) and the
library wgrad of the conv; the CUDA kernels are held against those plain
versions on the card by ``chip_smoke.py``.  The JAX side runs its XLA
backward (``interpret=None`` on the CPU) and its Pallas backward kernels
in interpret mode (``interpret=True``).  The scalar is
``sum(y * cy) + sum(ssum * cs) + sum(ssq * cq)`` with random cotangents,
as tests/test_fused_block.py builds it, so every cotangent path mixes.

Tolerances: f32 ``rtol=atol=2e-4`` (matmul) and ``5e-4`` (conv), those of
the JAX package's own gradient tests: the same f32 products summed in
another order.  bf16 is held against ``interpret=True`` (the port follows
the Pallas kernels' rounding points); dx and dW are one bf16 rounding
apart where the f32 sum order moves a value across a rounding boundary
(2**-8 relative), so ``rtol=2e-2`` with an absolute floor of 2e-2 of the
largest value; d_ps/d_pb are f32 sums of those products, 1e-2.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.ops.pallas import fused_matmul as jfm
from bigdl_tpu_torch.ops import fused_matmul as tfm

F32 = {"mm": dict(rtol=2e-4, atol=2e-4), "cv": dict(rtol=5e-4, atol=5e-4)}
NAMES = ("dx", "dw", "dps", "dpb")


def _case(kind, rs, prologue, x_shape=None):
    if kind == "mm":
        x_shape = x_shape or (96, 16)
        w_shape = (x_shape[1], 24)
    else:
        x_shape = x_shape or (4, 5, 6, 8)
        w_shape = (3, 3, x_shape[3], 16)
    c, co = x_shape[-1], w_shape[-1]
    x = rs.randn(*x_shape).astype(np.float32)
    w = (rs.randn(*w_shape) * 0.2).astype(np.float32)
    ps = (rs.rand(c) + 0.5).astype(np.float32) if prologue else None
    pb = (rs.randn(c) * 0.3).astype(np.float32) if prologue else None
    cy = rs.randn(*x_shape[:-1], co).astype(np.float32)
    cs = rs.randn(co).astype(np.float32)
    cq = (rs.randn(co) * 0.1).astype(np.float32)
    return (x, w, ps, pb), (cy, cs, cq)


def _jax_grads(kind, args, cots, relu, interpret, dtype=jnp.float32):
    fn = jfm.fused_matmul_bn if kind == "mm" else jfm.fused_conv3x3_bn
    cy, cs, cq = (jnp.asarray(c) for c in cots)
    x, w, ps, pb = args
    diff = [jnp.asarray(x, dtype), jnp.asarray(w, dtype)]
    if ps is not None:
        diff += [jnp.asarray(ps), jnp.asarray(pb)]

    def scalar(*a):
        y, s, q = fn(*a, relu=relu, interpret=interpret)
        return (jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(s * cs)
                + jnp.sum(q * cq))

    g = jax.grad(scalar, argnums=tuple(range(len(diff))))(*diff)
    return [np.asarray(v.astype(jnp.float32)) for v in g]


def _torch_grads(fn, args, cots, relu, dtype=torch.float32):
    x, w, ps, pb = args
    diff = [torch.tensor(x, dtype=dtype, requires_grad=True),
            torch.tensor(w, dtype=dtype, requires_grad=True)]
    if ps is not None:
        diff += [torch.tensor(ps, requires_grad=True),
                 torch.tensor(pb, requires_grad=True)]
    y, s, q = fn(*diff, relu=relu)
    cy, cs, cq = (torch.from_numpy(c) for c in cots)
    loss = (y.float() * cy).sum() + (s * cs).sum() + (q * cq).sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, diff)]


def _port(kind):
    return tfm.fused_matmul_bn if kind == "mm" else tfm.fused_conv3x3_bn


# m = 96 tiles into Pallas row blocks; batch 4 into conv image blocks
@pytest.mark.parametrize("kind", ["mm", "cv"])
@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("prologue,relu", [(False, False), (True, False),
                                           (True, True)])
def test_gradients_match_jax(kind, interpret, prologue, relu):
    rs = np.random.RandomState(11 + prologue + relu)
    args, cots = _case(kind, rs, prologue)
    want = _jax_grads(kind, args, cots, relu, interpret)
    got = _torch_grads(_port(kind), args, cots, relu)
    assert len(got) == len(want) == (4 if prologue else 2)
    for g, w, nm in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, err_msg=nm, **F32[kind])


def test_ragged_rows_match_jax():
    """m = 147 (3 x 7x7) does not tile; both JAX settings take XLA."""
    rs = np.random.RandomState(5)
    args, cots = _case("mm", rs, True, (147, 32))
    want = _jax_grads("mm", args, cots, True, None)
    got = _torch_grads(tfm.fused_matmul_bn, args, cots, True)
    for g, w, nm in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, err_msg=nm, **F32["mm"])


@pytest.mark.parametrize("kind", ["mm", "cv"])
def test_bf16_gradients_match_the_pallas_kernels(kind):
    rs = np.random.RandomState(8)
    args, cots = _case(kind, rs, True, (128, 32) if kind == "mm"
                       else (2, 7, 7, 16))
    want = _jax_grads(kind, args, cots, True, True, jnp.bfloat16)
    got = _torch_grads(_port(kind), args, cots, True, torch.bfloat16)
    for g, w, nm in zip(got, want, NAMES):
        tol = 2e-2 if nm in ("dx", "dw") else 1e-2
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=nm)


def test_conv3x3_dgrad_halo_is_zero_after_ytot():
    """A 1x1 image: only the centre tap reaches a pixel.  A halo padded
    before ytot is formed would add dssum @ w over the 8 border taps."""
    rs = np.random.RandomState(3)
    dy = torch.zeros(1, 1, 1, 8)
    y = torch.zeros(1, 1, 1, 8)
    dssum = torch.from_numpy(rs.rand(8).astype(np.float32) + 1.0)
    w = torch.from_numpy(rs.randn(3, 3, 8, 8).astype(np.float32))
    x = torch.from_numpy(rs.randn(1, 1, 1, 8).astype(np.float32))
    dx, _, _ = tfm.fused_conv3x3_bn_dgrad(dy, y, dssum, torch.zeros(8), w, x)
    want = w[1, 1] @ dssum  # (ci, co) @ (co,)
    np.testing.assert_allclose(dx[0, 0, 0].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["mm", "cv"])
@pytest.mark.parametrize("prologue,relu", [(False, False), (True, False),
                                           (True, True)])
def test_plain_backward_equals_autograd_of_the_plain_forward(kind, prologue,
                                                             relu):
    """f32: the plain backward versions (what the kernels are held to)
    are the derivative of the plain forward."""
    rs = np.random.RandomState(21)
    args, cots = _case(kind, rs, prologue)
    plain = (tfm.fused_matmul_bn_plain if kind == "mm"
             else tfm.fused_conv3x3_bn_plain)
    want = _torch_grads(plain, args, cots, relu)
    got = _torch_grads(_port(kind), args, cots, relu)
    for g, w, nm in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=nm)


def test_wgrad_rounds_once_after_the_f32_sum():
    """bf16: dW is the f32 sum over every row, rounded once at the end."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(512, 8).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rs.randn(512, 8).astype(np.float32)).bfloat16()
    y = torch.zeros_like(dy)
    z = torch.zeros(8)
    dw = tfm.fused_matmul_bn_wgrad(x, None, None, dy, y, z, z)
    want = (x.float().t() @ dy.float()).bfloat16()
    assert dw.dtype == torch.bfloat16
    assert torch.equal(dw, want)


def test_cpu_backward_counts_no_launch():
    tfm.reset_launches()
    x = torch.randn(16, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    y, s, q = tfm.fused_matmul_bn(x, w, relu=False)
    (y.sum() + s.sum() + q.sum()).backward()
    assert x.grad is not None and w.grad is not None
    assert set(tfm.LAUNCHES) == {
        "fused_matmul_bn", "fused_conv3x3_bn", "fused_matmul_bn_dgrad",
        "fused_matmul_bn_wgrad", "fused_conv3x3_bn_dgrad"}
    assert all(v == 0 for v in tfm.LAUNCHES.values())


def test_backward_wrappers_raise_on_other_devices():
    def meta(*shape):
        return torch.empty(*shape, device="meta")

    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_matmul_bn_dgrad(meta(4, 8), meta(4, 8), meta(8), meta(8),
                                  meta(8, 8), meta(4, 8))
    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_matmul_bn_wgrad(meta(4, 8), None, None, meta(4, 8),
                                  meta(4, 8), meta(8), meta(8))
    with pytest.raises(ValueError, match="no kernel"):
        tfm.fused_conv3x3_bn_dgrad(meta(1, 4, 4, 8), meta(1, 4, 4, 8),
                                   meta(8), meta(8), meta(3, 3, 8, 8),
                                   meta(1, 4, 4, 8))
