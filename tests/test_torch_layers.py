"""Parity of the port's layers (bigdl_tpu_torch.nn) with the JAX
package's (bigdl_tpu.nn), eval path, on the CPU.

Weights come from the JAX layer's ``init`` with every BatchNorm leaf
randomised in numpy (``random_variables``), are carried into the port by
``load_jax_variables``, and the same numpy input goes through both.
f32 ``rtol=atol=1e-5`` for single layers (only the summation order of
the convolution or matmul differs), ``2e-4`` for the fused bottleneck
(three convolutions in a row, as tests/test_fused_block.py allows).
"""
import numpy as np
import pytest

import jax
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.utils import load_jax_variables, random_variables

F32 = dict(rtol=1e-5, atol=1e-5)


def _pair(jax_layer, torch_layer, x, seed=0, randomize=True, tol=F32):
    variables = jax.tree_util.tree_map(
        np.asarray, jax_layer.init(jax.random.PRNGKey(seed)))
    if randomize:
        variables = random_variables(variables, seed)
    want, _ = jax_layer.apply(variables["params"], variables["state"], x,
                              training=False)
    load_jax_variables(torch_layer, variables)
    with torch.inference_mode():
        got = torch_layer.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    return got


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_space_to_depth():
    _pair(jnn.SpaceToDepth(2), tnn.SpaceToDepth(2), _x(2, 8, 6, 3))


@pytest.mark.parametrize("hw,k,stride,padding", [
    (8, 3, 1, "SAME"),              # even size, symmetric
    (7, 3, 1, "SAME"),              # odd size
    (8, 3, 2, "SAME"),              # even size, stride 2: pads (0, 1)
    (7, 3, 2, "SAME"),              # odd size, stride 2: pads (1, 1)
    (8, 7, 2, "SAME"),              # the 7x7/s2 stem: pads (2, 3)
    (8, 4, 1, ((1, 2), (1, 2))),    # the space-to-depth stem
    (9, 3, 1, 1),
    (9, 1, 2, "VALID"),
])
def test_spatial_convolution(hw, k, stride, padding):
    for bias in (False, True):
        _pair(jnn.SpatialConvolution(4, 6, k, stride, padding=padding,
                                     with_bias=bias),
              tnn.SpatialConvolution(4, 6, k, stride, padding=padding,
                                     with_bias=bias),
              _x(2, hw, hw + 1, 4))


@pytest.mark.parametrize("hw", [8, 9])
def test_max_pool_same_pads_with_minus_inf(hw):
    # all-negative input: a zero-filled pad would win the max at the
    # bottom/right border; -inf must not
    x = -np.abs(_x(2, hw, hw, 3)) - 1.0
    got = _pair(jnn.SpatialMaxPooling(3, 2, padding="SAME"),
                tnn.SpatialMaxPooling(3, 2, padding="SAME"), x)
    assert (got < 0).all()


def test_batch_norm_eval_randomised():
    _pair(jnn.SpatialBatchNormalization(5), tnn.SpatialBatchNormalization(5),
          _x(2, 4, 4, 5))
    _pair(jnn.BatchNormalization(5), tnn.BatchNormalization(5), _x(6, 5))


def test_batch_norm_bf16_rounds_like_jax():
    import jax.numpy as jnp

    j, t = jnn.SpatialBatchNormalization(8), tnn.SpatialBatchNormalization(8)
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, j.init(jax.random.PRNGKey(0))), 3)
    x = _x(2, 3, 3, 8)
    want, _ = j.apply(v["params"], v["state"], jnp.asarray(x, jnp.bfloat16))
    load_jax_variables(t, v)
    with torch.inference_mode():
        got = t.eval()(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_batch_norm_refuses_training_mode():
    """BatchNorm no longer refuses training mode: its training forward is
    ported (tests/test_torch_train_layers.py holds it against JAX).  A
    training forward normalises with the batch statistics and moves the
    running statistics; an eval forward leaves them alone."""
    bn = tnn.SpatialBatchNormalization(3)
    x = torch.arange(12, dtype=torch.float32).reshape(1, 2, 2, 3)
    y = bn.train()(x)
    assert torch.allclose(y.mean((0, 1, 2)), torch.zeros(3), atol=1e-6)
    assert not torch.equal(bn.running_mean, torch.zeros(3))
    before = bn.running_mean.clone()
    bn.eval()(x)
    assert torch.equal(bn.running_mean, before)


def test_global_average_pooling_linear_relu_cadd():
    _pair(jnn.GlobalAveragePooling2D(), tnn.GlobalAveragePooling2D(),
          _x(2, 5, 5, 7))
    _pair(jnn.Linear(7, 3), tnn.Linear(7, 3), _x(4, 7))
    _pair(jnn.ReLU(), tnn.ReLU(), _x(3, 4))
    a, b = _x(2, 3, seed=1), _x(2, 3, seed=2)
    out = tnn.CAddTable()((torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(out.numpy(), a + b, **F32)


@pytest.mark.parametrize("n_in,planes,stride,hw", [
    (16, 4, 1, 6),   # projection shortcut (16 != 4 * 4), stride 1
    (16, 4, 2, 6),   # strided: library conv2, strided shortcut
    (16, 4, 2, 7),   # odd size, stride 2
    (16, 4, 1, 5),   # identity shortcut (n_in == 4 * planes)
])
def test_fused_bottleneck_eval_matches_jax(n_in, planes, stride, hw):
    got = _pair(jnn.FusedBottleneck(n_in, planes, stride),
                tnn.FusedBottleneck(n_in, planes, stride),
                _x(2, hw, hw, n_in), seed=stride,
                tol=dict(rtol=2e-4, atol=2e-4))
    assert got.shape == (2, -(-hw // stride), -(-hw // stride), 4 * planes)


def test_fused_bottleneck_plain_ops_equal_kernel_route_on_cpu():
    """On CPU tensors both routes run the plain versions: equal bits."""
    block = tnn.FusedBottleneck(16, 4, 2).eval()
    x = torch.from_numpy(_x(2, 6, 6, 16))
    with torch.inference_mode():
        a = block(x)
        b = tnn.use_plain_ops(block)(x)
    assert torch.equal(a, b)


def test_graph_keys_follow_the_jax_rule():
    def build(nn):
        inp = nn.Input()
        x = nn.ReLU().inputs(inp)
        x = nn.ReLU().inputs(x)
        x = nn.Linear(3, 3, name="fc").inputs(x)
        x = nn.ReLU().inputs(x)
        return nn.Graph([inp], [x])

    assert build(tnn).child_keys == build(jnn).child_keys \
        == ["ReLU", "ReLU_1", "fc", "ReLU_2"]


def test_initialize_is_deterministic_in_the_generator():
    def weights(seed):
        m = tnn.Sequential(tnn.SpatialConvolution(3, 4, 3,
                                                  weight_init=tnn.MsraFiller()),
                           tnn.Linear(4, 2))
        m.initialize(torch.Generator().manual_seed(seed))
        return [p.detach().clone() for p in m.parameters()]

    a, b, c = weights(0), weights(0), weights(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
