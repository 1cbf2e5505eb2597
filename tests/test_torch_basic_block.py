"""The fused basic-block family of the port against the JAX package's,
on the CPU: ``FusedBasicBlock`` (bigdl_tpu_torch/nn/fused_block.py), the
fused ResNet-18/34 and CIFAR builds and the fuse/unfuse converters
(models/resnet.py), and BatchNorm with ``affine=False`` (nn/norm.py).

- ``FusedBasicBlock`` at stride 1 without and with a projection and at
  stride 2, remat on and off, in training: output within 2e-4, every
  gradient within rtol 5e-3 / atol 1e-5 (the tolerances
  tests/test_fused_block.py holds JAX's block to against its unfused
  graph), the running statistics within 1e-5; in eval within 2e-4.  The
  bf16 block with a projection at stride 1 and 2 within 5e-2 relative L2
  per leaf, as the bf16 bottleneck test holds it: JAX's XLA backward on
  the CPU rounds differently from the kernels' plain versions.
- The fused CIFAR ResNet-8 (32 px) and ResNet-18 (64 px) eval forwards
  from one randomised tree against JAX's within 1e-3 (the ResNet-50
  parity tolerance): at these sizes no JAX forward reaches a Pallas
  interpret run.
- ``fuse_resnet_params``/``unfuse_resnet_params`` leaf for leaf equal to
  JAX's on ResNet-18, ResNet-34, CIFAR ResNet-20 and ResNet-50 (every
  BatchNorm leaf randomised, running statistics included), and the round
  trip bit for bit.
- BatchNorm(affine=False): no weight or bias, an empty params subtree,
  training and eval against JAX's, and the carry through
  ``load_jax_variables``/``export_variables``.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import (ResNet, fuse_resnet_params,
                                    unfuse_resnet_params)
from bigdl_tpu_torch.utils import (export_variables, flatten,
                                   load_jax_variables, random_variables)

OUT = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=1e-5)


def _variables(jmodule, seed):
    """Random weights in the JAX module's tree (its shapes, no draw)."""
    tree = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0)))
    return random_variables(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), tree), seed)


def _np(tree):
    return flatten(jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree))


BLOCKS = [(8, 8, 1), (8, 16, 1), (8, 16, 2)]


@pytest.mark.parametrize("n_in,n_out,stride", BLOCKS)
@pytest.mark.parametrize("remat", [True, False])
def test_fused_basic_block_training_matches_jax(n_in, n_out, stride, remat):
    seed = n_in + n_out + stride
    rs = np.random.RandomState(seed)
    j = jnn.FusedBasicBlock(n_in, n_out, stride)
    v = _variables(j, seed)
    x = rs.randn(2, 6, 6, n_in).astype(np.float32)
    cot = rs.randn(2, 6 // stride, 6 // stride, n_out).astype(np.float32)

    def scalar(params, xx):
        out, new_state = j.apply(params, v["state"], xx, training=True)
        return jnp.sum(out * cot), (out, new_state)

    (_, (want, want_state)), (gp, gx) = jax.jit(jax.value_and_grad(
        scalar, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))

    t = tnn.FusedBasicBlock(n_in, n_out, stride, remat=remat)
    assert t.project == j.project
    load_jax_variables(t, v)
    xt = torch.tensor(x, requires_grad=True)
    out = t.train()(xt)
    (out * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **OUT)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    grads = _np(gp)
    named = dict(t.named_parameters())
    assert grads.keys() == named.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g, err_msg=k,
                                   **GRAD)
    for k, s in _np(want_state).items():
        np.testing.assert_allclose(dict(t.named_buffers())[k].numpy(), s,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n_in,n_out,stride", BLOCKS)
def test_fused_basic_block_eval_matches_jax(n_in, n_out, stride):
    j = jnn.FusedBasicBlock(n_in, n_out, stride)
    v = _variables(j, 40 + stride)
    x = np.random.RandomState(41).randn(3, 8, 8, n_in).astype(np.float32)
    want, _ = j.apply(v["params"], v["state"], jnp.asarray(x),
                      training=False)
    t = tnn.FusedBasicBlock(n_in, n_out, stride)
    load_jax_variables(t, v)
    with torch.inference_mode():
        got = t.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_basic_block_bf16_training_matches_jax(stride):
    """bf16 block with a projection, every leaf cast to bf16 on both
    sides: output, running statistics and (at stride 1) every gradient
    within 5e-2 relative L2 per leaf.  At stride 2 (the f32 strided
    conv1: its statistics from the f32 output, raw1 rounded once) JAX's
    own backward raises on bf16 (the transpose of its
    ``preferred_element_type=f32`` conv mixes bf16 and f32 operands), so
    there the gradients are held against JAX's f32 block's."""
    rs = np.random.RandomState(7)
    j = jnn.FusedBasicBlock(8, 16, stride)
    v = _variables(j, 7)
    x = rs.randn(2, 8, 8, 8).astype(np.float32)
    cot = rs.randn(2, 8 // stride, 8 // stride, 16).astype(np.float32)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                v["params"])

    def scalar(params, xx):
        out, new_state = j.apply(params, v["state"], xx, training=True)
        return jnp.sum(out.astype(jnp.float32) * cot), (out, new_state)

    grad = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True))
    (_, (want, want_state)), _ = grad(*(
        (bf, jnp.asarray(x, jnp.bfloat16)) if stride == 1
        else (v["params"], jnp.asarray(x))))
    if stride == 2:  # the forward in bf16; the gradients from f32
        want, want_state = jax.jit(
            lambda p, xx: j.apply(p, v["state"], xx, training=True))(
                bf, jnp.asarray(x, jnp.bfloat16))
        _, (gp, gx) = grad(v["params"], jnp.asarray(x))
    else:
        _, (gp, gx) = grad(bf, jnp.asarray(x, jnp.bfloat16))

    t = tnn.FusedBasicBlock(8, 16, stride, remat=False)
    load_jax_variables(t, v)
    t.to(torch.bfloat16).train()
    xt = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    out = t(xt)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(cot)).sum().backward()

    def close(g, w, what):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert np.isfinite(g).all() and err < 5e-2, (what, err)

    close(out.float().detach().numpy(), want.astype(jnp.float32), "out")
    for k, s in _np(want_state).items():
        close(dict(t.named_buffers())[k].float().numpy(), s, k)
    close(xt.grad.float().numpy(), gx.astype(jnp.float32), "dx")
    named = dict(t.named_parameters())
    for k, g in _np(gp).items():
        close(named[k].grad.float().numpy(), g, k)


@pytest.mark.parametrize("depth,dataset,size",
                         [(8, "cifar10", 32), (18, "imagenet", 64)])
def test_fused_resnet_eval_forward_matches_jax(depth, dataset, size):
    jm = jresnet.ResNet(5, depth=depth, dataset=dataset, fused=True)
    v = _variables(jm, depth)
    x = np.random.RandomState(depth).rand(2, size, size, 3).astype(
        np.float32)
    want, _ = jax.jit(functools.partial(jm.apply, training=False))(
        v["params"], v["state"], jnp.asarray(x))
    tm = ResNet(5, depth=depth, dataset=dataset, fused=True, device="cpu")
    assert tm.child_keys == list(jm.child_keys)
    assert sum(k.startswith("fused_") for k in tm.child_keys) == \
        (depth - 2) // 6 * 3 if dataset == "cifar10" else 8
    load_jax_variables(tm, v)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("depth,dataset", [(18, "imagenet"),
                                           (34, "imagenet"),
                                           (20, "cifar10"),
                                           (50, "imagenet")])
def test_fuse_and_unfuse_match_jax_leaf_for_leaf(depth, dataset):
    kw = dict(class_num=7, depth=depth, dataset=dataset)
    unfused = ResNet(7, depth, dataset, device="cpu")
    vu = random_variables(export_variables(unfused), depth)
    vf = fuse_resnet_params(vu, **kw)
    want_f = jresnet.fuse_resnet_params(vu, **kw)
    fused = ResNet(7, depth, dataset, fused=True, device="cpu")
    for part in ("params", "state"):
        assert list(vf[part]) == list(want_f[part]) == fused.child_keys
        got, want = flatten(vf[part]), flatten(want_f[part])
        assert list(got) == list(want)
        for k in want:
            assert got[k] is want[k], k  # the same leaf, moved
    load_jax_variables(fused, vf)  # every fused slot filled, shapes right
    back = unfuse_resnet_params(vf, **kw)
    want_back = jresnet.unfuse_resnet_params(want_f, **kw)
    for part in ("params", "state"):
        assert list(back[part]) == list(want_back[part])
        got, orig = flatten(back[part]), flatten(vu[part])
        assert list(got) == list(orig) == list(flatten(want_back[part]))
        for k in orig:
            np.testing.assert_array_equal(got[k], orig[k], err_msg=k)


def test_fused_resnet18_converted_forward_matches_unfused():
    vu = random_variables(export_variables(
        ResNet(6, 18, device="cpu")), 3)
    models = {}
    for fused in (False, True):
        m = ResNet(6, 18, fused=fused, device="cpu")
        load_jax_variables(m, fuse_resnet_params(vu, 6, 18) if fused
                           else vu)
        models[fused] = m
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 64, 64, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_allclose(models[True](x).numpy(),
                                   models[False](x).numpy(), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_without_affine_matches_jax(training):
    rs = np.random.RandomState(9)
    x = (rs.randn(4, 5, 5, 6) * 2 + 1).astype(np.float32)
    j = jnn.SpatialBatchNormalization(6, affine=False)
    v = _variables(j, 9)
    assert v["params"] == {}
    want, new_state = j.apply(v["params"], v["state"], jnp.asarray(x),
                              training=training)
    t = tnn.SpatialBatchNormalization(6, affine=False)
    assert t.weight is None and t.bias is None
    assert not list(t.parameters())
    load_jax_variables(t, v)
    got = t.train(training)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(new_state[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_batch_norm_without_affine_carries_in_a_graph():
    """A graph holding an affine and a non-affine BatchNorm: the JAX
    tree (an empty params subtree for the second) loads, exports to the
    same tree, and the forward matches JAX's."""
    def build(m):
        inp = m.Input()
        y = m.SpatialConvolution(3, 4, 3, with_bias=False).inputs(inp)
        y = m.SpatialBatchNormalization(4).inputs(y)
        y = m.SpatialBatchNormalization(4, affine=False).inputs(y)
        return m.Graph([inp], [y])

    jg = build(jnn)
    v = _variables(jg, 5)
    assert v["params"]["SpatialBatchNormalization_1"] == {}
    tg = build(tnn)
    got_tree = load_jax_variables(tg, v)
    assert got_tree["params"]["SpatialBatchNormalization_1"] == {}
    for part in ("params", "state"):
        assert flatten(got_tree[part]).keys() == flatten(v[part]).keys()
        for k, a in flatten(v[part]).items():
            np.testing.assert_array_equal(flatten(got_tree[part])[k], a)
    x = np.random.RandomState(6).randn(2, 6, 6, 3).astype(np.float32)
    want, _ = jg.apply(v["params"], v["state"], jnp.asarray(x),
                       training=False)
    with torch.inference_mode():
        got = tg.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
