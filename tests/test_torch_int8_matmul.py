"""The port's int8 dequant matmul (bigdl_tpu_torch.ops.int8_matmul) against
the JAX package's ``int8_matmul_dequant``.

The same int8 operands and f32 scales, made with numpy from a seed, go
through the JAX function on its XLA path (``interpret=None`` on the CPU)
and, where the Pallas kernel takes the shape (K and N multiples of 128),
through the kernel in interpret mode (``interpret=True``), and through the
port's plain version, which is what its wrapper runs for a CPU tensor.
The integer sum is exact on every route and the dequant is the same f32
multiply and one cast, so bf16 and f32 outputs are held bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas.int8_matmul import (
    int8_matmul_dequant as jax_int8_matmul)
from bigdl_tpu_torch.ops import int8_matmul as im

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _operands(m, k, n, seed=0):
    rs = np.random.RandomState(seed)
    xq = rs.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rs.randint(-127, 128, (k, n)).astype(np.int8)
    scale = (rs.rand(n).astype(np.float32) + 0.05) * 1e-3
    return xq, wq, scale


def _jax(xq, wq, scale, dt, interpret):
    y = jax_int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                        out_dtype=DTYPES[dt][0], interpret=interpret)
    return np.asarray(y.astype(jnp.float32))


def _port(xq, wq, scale, dt):
    return im.int8_matmul_dequant(torch.from_numpy(xq), torch.from_numpy(wq),
                                  torch.from_numpy(scale),
                                  out_dtype=DTYPES[dt][1]).float().numpy()


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("m,k,n,interpret", [
    (64, 128, 256, True),    # the Pallas kernel, as tests/test_pallas.py
    (48, 128, 128, True),
    (64, 128, 256, None),    # XLA's integer dot
    (37, 200, 1000, None),   # ragged: the reference routes it to XLA
    (32, 2048, 1000, None),  # ResNet-50's fc at batch 32
    (3, 7, 5, None),
])
def test_plain_matches_jax_bit_for_bit(m, k, n, interpret, dt):
    xq, wq, scale = _operands(m, k, n, seed=m + k + n)
    want = _jax(xq, wq, scale, dt, interpret)
    got = _port(xq, wq, scale, dt)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got, want)


def test_large_sums_round_as_xla_does():
    """Sums past 2**24 are not exact in f32: both sides round the same
    integer once (f64 -> f32 here, s32 -> f32 in XLA)."""
    m, k, n = 8, 4096, 16
    xq = np.full((m, k), 127, np.int8)
    xq[:, ::3] = -127
    wq = np.full((k, n), 127, np.int8)
    wq[::5] = 113
    scale = np.linspace(1e-4, 1e-3, n).astype(np.float32)
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(acc).max() > 2 ** 24
    for dt in DTYPES:
        np.testing.assert_array_equal(_port(xq, wq, scale, dt),
                                      _jax(xq, wq, scale, dt, None))


def test_scale_row_shapes_and_weight_layouts():
    """``scale_row`` as (N,) or (1, N); ``w_q`` as a contiguous (K, N)
    tensor, the transposed view of an (N, K) tensor (the int8 KV score
    product's ``k_q.T``) or a strided slice: one result."""
    xq, wq, scale = _operands(8, 128, 64, seed=3)
    want = _jax(xq, wq, scale, "bf16", None)
    x = torch.from_numpy(xq)
    views = [torch.from_numpy(wq),
             torch.from_numpy(np.ascontiguousarray(wq.T)).t(),
             torch.from_numpy(np.repeat(wq, 2, axis=1))[:, ::2]]
    for w in views:
        for s in (torch.from_numpy(scale), torch.from_numpy(scale[None])):
            got = im.int8_matmul_dequant(x, w, s).float().numpy()
            np.testing.assert_array_equal(got, want)


def test_cpu_route_counts_no_launch_and_records_calls():
    xq, wq, scale = _operands(4, 16, 8)
    im.reset_launches()
    with im.record_calls() as calls:
        im.int8_matmul_dequant(torch.from_numpy(xq), torch.from_numpy(wq),
                               torch.from_numpy(scale))
        im.int8_matmul_dequant_plain(torch.from_numpy(xq),
                                     torch.from_numpy(wq),
                                     torch.from_numpy(scale))
    assert im.LAUNCHES["int8_matmul"] == 0
    assert calls == [(4, 16, 8, (8, 1))]  # the plain version is not a call


def test_wrapper_refuses_what_it_cannot_take():
    x = torch.zeros(4, 16, dtype=torch.int8)
    w = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(TypeError):
        im.int8_matmul_dequant(x.float(), w, s)
    with pytest.raises(ValueError):
        im.int8_matmul_dequant(x, w[:15], s)
    with pytest.raises(ValueError):
        im.int8_matmul_dequant(x, w, s[:7])
    with pytest.raises(TypeError):
        im.int8_matmul_dequant(x, w, s, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no kernel"):
        im.int8_matmul_dequant(x.to("meta"), w.to("meta"), s.to("meta"))
