"""Training modules of the port against the JAX package's: BatchNorm's
training forward, the fused bottleneck in training (stride 1 and 2,
remat on and off), ClassNLLCriterion and SGD.

Every BatchNorm leaf is randomised before the carry (a zero closing
gamma would hide the residual branch).  Tolerances are f32: 1e-5 for a
single layer, 2e-4 for the block's values and gradients (three
convolutions and four BatchNorms summed in other orders), 1e-6 for the
optimizer's elementwise updates.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.utils import (export_opt_state, flatten,
                                   load_jax_opt_state, load_jax_variables,
                                   random_variables)

BLOCK = dict(rtol=2e-4, atol=2e-4)


def _variables(jmodule, seed):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodule.init(jax.random.PRNGKey(0)))
    return random_variables(tree, seed)


def test_batch_norm_training_matches_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 5, 5, 6) * 2 + 1).astype(np.float32)
    j = jnn.SpatialBatchNormalization(6)
    v = _variables(j, 1)
    want, new_state = j.apply(v["params"], v["state"], jnp.asarray(x),
                              training=True)
    t = tnn.SpatialBatchNormalization(6)
    load_jax_variables(t, v)
    got = t.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(new_state[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_batch_norm_bf16_training_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(8, 6).astype(np.float32)
    j = jnn.BatchNormalization(6)
    v = _variables(j, 3)
    want, _ = j.apply(v["params"], v["state"], jnp.asarray(x, jnp.bfloat16),
                      training=True)
    t = tnn.BatchNormalization(6)
    load_jax_variables(t, v)
    got = t.train()(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 constants and product
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("n_in,stride", [(16, 1), (32, 1), (16, 2)])
@pytest.mark.parametrize("remat", [True, False])
def test_fused_bottleneck_training_matches_jax(n_in, stride, remat):
    rs = np.random.RandomState(n_in + stride)
    j = jnn.FusedBottleneck(n_in, 8, stride)
    v = _variables(j, n_in + stride)
    x = rs.randn(2, 6, 6, n_in).astype(np.float32)
    cot = rs.randn(2, 6 // stride, 6 // stride, 32).astype(np.float32)

    def scalar(params, xx):
        out, new_state = j.apply(params, v["state"], xx, training=True)
        return jnp.sum(out * cot), (out, new_state)

    (_, (want, want_state)), (gp, gx) = jax.value_and_grad(
        scalar, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    t = tnn.FusedBottleneck(n_in, 8, stride, remat=remat)
    load_jax_variables(t, v)
    xt = torch.tensor(x, requires_grad=True)
    out = t.train()(xt)
    (out * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **BLOCK)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **BLOCK)
    grads = flatten(jax.tree_util.tree_map(np.asarray, gp))
    named = dict(t.named_parameters())
    assert grads.keys() == named.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g, err_msg=k,
                                   **BLOCK)
    # the running statistics moved once, remat or not
    for k, s in flatten(jax.tree_util.tree_map(np.asarray,
                                               want_state)).items():
        np.testing.assert_allclose(dict(t.named_buffers())[k].numpy(), s,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_fused_bottleneck_bf16_training_matches_jax():
    """bf16 block, as under compute_dtype=bfloat16: every leaf cast to
    bf16 on both sides.  The JAX block takes its XLA backward on the CPU,
    which rounds the conv dgrad to bf16 once more before the ReLU mask
    than the Pallas kernel the port follows, and a ReLU mask can flip
    where x * ps + pb rounds across 0; the BatchNorm constants' gradients
    are bf16 sums over the block's pixels (the transposed broadcast of
    ``a.to(x.dtype)``), taken in another order.  So values and gradients
    are held as relative L2 error per leaf within 5e-2 (measured: dx
    0.018, the BatchNorm leaves 0.018-0.037, the conv weights 0.011-0.020,
    the output exact)."""
    rs = np.random.RandomState(5)
    j = jnn.FusedBottleneck(16, 8, 1)
    v = _variables(j, 5)
    x = rs.randn(2, 6, 6, 16).astype(np.float32)
    cot = rs.randn(2, 6, 6, 32).astype(np.float32)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                v["params"])

    def scalar(params, xx):
        out, new_state = j.apply(params, v["state"], xx, training=True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(
        scalar, argnums=(0, 1), has_aux=True)(
            bf, jnp.asarray(x, jnp.bfloat16))

    t = tnn.FusedBottleneck(16, 8, 1, remat=False)
    load_jax_variables(t, v)
    t.to(torch.bfloat16).train()
    xt = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    out = t(xt)
    (out.float() * torch.from_numpy(cot)).sum().backward()

    def close(g, w, what):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert np.isfinite(g).all() and err < 5e-2, (what, err)

    close(out.float().detach().numpy(), want.astype(jnp.float32), "out")
    close(xt.grad.float().numpy(), gx.astype(jnp.float32), "dx")
    named = dict(t.named_parameters())
    for k, g in flatten(jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), gp)).items():
        close(named[k].grad.float().numpy(), g, k)


@pytest.mark.parametrize("kw", [{}, {"size_average": False},
                                {"weights": [0.5, 1.0, 2.0, 1.5]},
                                {"padding_value": 2}])
def test_class_nll_criterion_matches_jax(kw):
    rs = np.random.RandomState(6)
    logits = rs.randn(5, 4).astype(np.float32)
    target = np.array([0, 3, 2, 1, 2])
    jkw = dict(kw)
    tkw = dict(kw)
    if "weights" in kw:
        jkw["weights"] = jnp.asarray(kw["weights"], jnp.float32)
        tkw["weights"] = torch.tensor(kw["weights"])
    jc = jnn.ClassNLLCriterion(logits=True, **jkw)
    tc = tnn.ClassNLLCriterion(logits=True, **tkw)
    want = jc(jnp.asarray(logits), jnp.asarray(target))
    want_g = jc.backward(jnp.asarray(logits), jnp.asarray(target))
    x = torch.from_numpy(logits)
    got = tc(x, torch.from_numpy(target))
    got_g = tc.backward(x, torch.from_numpy(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)


def _sgd_tree(rs):
    return {"fc": {"weight": rs.randn(3, 2).astype(np.float32),
                   "bias": rs.randn(2).astype(np.float32)},
            "bn": {"weight": rs.randn(2).astype(np.float32)}}


@pytest.mark.parametrize("case", ["default_dampening", "nesterov",
                                  "weight_decay", "carried_velocity"])
def test_sgd_three_steps_match_jax(case):
    kw = {"default_dampening": dict(momentum=0.9),
          "nesterov": dict(momentum=0.9, dampening=0.0, nesterov=True),
          "weight_decay": dict(momentum=0.9, weight_decay=1e-2),
          "carried_velocity": dict(momentum=0.9)}[case]
    rs = np.random.RandomState(9)
    params = _sgd_tree(rs)
    grads = [_sgd_tree(rs) for _ in range(3)]
    jm, tm = JaxSGD(0.1, **kw), SGD(0.1, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jm.init_state(jp)
    tp = {k: torch.from_numpy(v) for k, v in flatten(params).items()}
    ts = tm.init_state(tp)
    if case == "carried_velocity":
        js = {"velocity": jax.tree_util.tree_map(
            lambda a: jnp.asarray(rs.randn(*a.shape), jnp.float32), jp)}
        ts = load_jax_opt_state(
            jax.tree_util.tree_map(np.asarray, js), tp)
    lr = jnp.asarray(0.1, jnp.float32)
    for g in grads:
        jp, js = jm.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           lr)
        tp, ts = tm.update({k: torch.from_numpy(v)
                            for k, v in flatten(g).items()}, ts, tp, 0.1)
    for k, want in flatten(jax.tree_util.tree_map(np.asarray, jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k, want in flatten(jax.tree_util.tree_map(
            np.asarray, js["velocity"])).items():
        np.testing.assert_allclose(ts["velocity"][k].numpy(), want,
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_sgd_first_step_is_the_dampened_gradient():
    """dampening defaults to the momentum and the velocity starts at 0:
    step 1 moves by lr * 0.1 * g (torch.optim.SGD would move by lr * g)."""
    p = {"w": torch.ones(3)}
    g = {"w": torch.full((3,), 2.0)}
    m = SGD(0.1, momentum=0.9)
    new, state = m.update(g, m.init_state(p), p, 0.1)
    np.testing.assert_allclose(state["velocity"]["w"].numpy(), 0.2,
                               rtol=1e-6)
    np.testing.assert_allclose(new["w"].numpy(), 1.0 - 0.02, rtol=1e-6)


def test_opt_state_round_trips_with_the_params_tree_shape():
    model = tnn.Sequential(tnn.Linear(3, 2), tnn.ReLU(),
                           tnn.BatchNormalization(2))
    params = dict(model.named_parameters())
    state = SGD(0.1, momentum=0.9).init_state(params)
    for k, v in state["velocity"].items():
        v.normal_()
    tree = export_opt_state(model, state)
    assert set(tree["velocity"]) == {"0", "1", "2"}
    assert tree["velocity"]["1"] == {}
    back = load_jax_opt_state(tree, params)
    for k in params:
        assert torch.equal(back["velocity"][k], state["velocity"][k])
    del tree["velocity"]["2"]["bias"]
    with pytest.raises(KeyError, match="2.bias"):
        load_jax_opt_state(tree, params)
