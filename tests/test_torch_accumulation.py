"""Gradient accumulation in the port's train step
(``make_train_step(accum_steps=k)``, ``set_gradient_accumulation``)
against the JAX package's (bigdl_tpu/optim/optimizer.py:189-194,
319-356), on the CPU in f32.

- k = 4 against JAX's ``make_train_step(accum_steps=4)``, two steps from
  one tree on each side: the loss, the parameters and the BatchNorm
  state (chained from each micro-batch to the next) within 1e-5, on an
  MLP and on one FusedBottleneck at narrow width with every BatchNorm
  leaf randomised (in the port it runs the kernels' plain versions).
- On a model without BatchNorm the accumulated step is the full batch's
  (the mean of equal micro-batch means), within 1e-6.
- Micro-batch i of a step seeded ``rng`` is seeded ``split_rng(rng, i)``,
  as JAX's ``fold_in(rng, i)``.
- A batch that k does not divide raises ``ValueError``, also through the
  loop.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim.optimizer import make_train_step as jax_make_train_step
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.nn import split_rng
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger, make_train_step
from bigdl_tpu_torch.utils import (flatten, load_jax_variables,
                                   random_variables)

TOL = dict(rtol=1e-5, atol=1e-5)


def _mlp(nn):
    return nn.Sequential(nn.Linear(6, 12), nn.ReLU(), nn.Linear(12, 5))


def _block(nn):
    return nn.Sequential(nn.FusedBottleneck(16, 8, 1),
                         nn.GlobalAveragePooling2D(), nn.Linear(32, 5))


def _run_both(build, x_shape, k, seed, steps=2, lr=0.05):
    jm, tm = build(jnn), build(tnn)
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), seed)
    rs = np.random.RandomState(seed + 1)
    x = rs.randn(*x_shape).astype(np.float32)
    y = rs.randint(0, 5, x_shape[0])

    jstep = jax.jit(jax_make_train_step(
        jm, jnn.ClassNLLCriterion(logits=True),
        {"__all__": JaxSGD(lr, momentum=0.9)}, accum_steps=k))
    jt = (v["params"], v["state"],
          {"__all__": JaxSGD(lr, momentum=0.9).init_state(v["params"])})
    jt = jax.tree_util.tree_map(jnp.asarray, jt)
    load_jax_variables(tm, v)
    tstep = make_train_step(tm, tnn.ClassNLLCriterion(logits=True),
                            {"__all__": SGD(lr, momentum=0.9)},
                            accum_steps=k)
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tt = (params, {n: b.detach().clone() for n, b in tm.named_buffers()},
          {"__all__": SGD(lr, momentum=0.9).init_state(params)})
    for i in range(steps):
        *jt, jl = jstep(*jt, jnp.asarray(i + 1), jax.random.PRNGKey(i),
                        jnp.asarray(x), jnp.asarray(y),
                        [jnp.asarray(lr, jnp.float32)])
        *tt, tl = tstep(*tt, i + 1, i, torch.from_numpy(x),
                        torch.from_numpy(y), [lr])
        assert float(tl) == pytest.approx(float(jl), rel=1e-5, abs=1e-6), i
    for want, got in ((jt[0], tt[0]), (jt[1], tt[1])):
        want = flatten(jax.tree_util.tree_map(np.asarray, want))
        assert want.keys() == got.keys()
        for n, w in want.items():
            np.testing.assert_allclose(got[n].numpy(), w, err_msg=n, **TOL)
    return tt


@pytest.mark.parametrize("case", ["mlp", "fused_bottleneck"])
def test_accum4_matches_jax(case):
    if case == "mlp":
        _run_both(_mlp, (16, 6), 4, seed=3, steps=3)
    else:
        _, state, _ = _run_both(_block, (8, 6, 6, 16), 4, seed=5)
        assert any("running_mean" in n for n in state)


def test_accumulated_step_equals_the_full_batch_without_batch_norm():
    tm = _mlp(tnn)
    tm.initialize(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(12, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 5, 12))
    out = {}
    for k in (1, 3):
        step = make_train_step(tm, tnn.ClassNLLCriterion(logits=True),
                               {"__all__": SGD(0.1, momentum=0.9)},
                               accum_steps=k)
        params = {n: p.detach().clone() for n, p in tm.named_parameters()}
        trees = (params, {}, {"__all__": SGD(0.1, momentum=0.9)
                              .init_state(params)})
        for i in range(2):
            *trees, loss = step(*trees, i + 1, None, x, y, [0.1])
        out[k] = (trees[0], float(loss))
    assert out[3][1] == pytest.approx(out[1][1], rel=1e-6)
    for n, p in out[1][0].items():
        np.testing.assert_allclose(out[3][0][n].numpy(), p.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


class _Seeds(tnn.Sequential):
    """An MLP that records the seed each forward is given."""

    def __init__(self):
        super().__init__(tnn.Linear(6, 5))
        self.seen = []

    def forward(self, x, rng=None):
        self.seen.append(rng)
        return super().forward(x)


def test_micro_batch_seeds_are_split_from_the_step_seed():
    m = _Seeds()
    step = make_train_step(m, tnn.ClassNLLCriterion(logits=True),
                           {"__all__": SGD(0.1)}, accum_steps=4)
    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2])
    step(params, {}, {"__all__": {}}, 1, 123, x, y, [0.1])
    assert m.seen == [split_rng(123, i) for i in range(4)]
    m.seen.clear()
    step(params, {}, {"__all__": {}}, 1, torch.tensor(123), x, y, [0.1])
    assert [int(s) for s in m.seen] == [split_rng(123, i) for i in range(4)]
    m.seen.clear()
    step(params, {}, {"__all__": {}}, 1, None, x, y, [0.1])
    assert m.seen == [None] * 4


def test_a_batch_k_does_not_divide_raises():
    tm = _mlp(tnn)
    step = make_train_step(tm, tnn.ClassNLLCriterion(logits=True),
                           {"__all__": SGD(0.1)}, accum_steps=4)
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    with pytest.raises(ValueError, match="not divisible"):
        step(params, {}, {"__all__": {}}, 1, None, torch.zeros(6, 6),
             torch.zeros(6, dtype=torch.long), [0.1])
    rs = np.random.RandomState(0)
    opt = (Optimizer.apply(tm, DataSet.from_arrays(
        rs.randn(12, 6).astype(np.float32), rs.randint(0, 5, 12),
        batch_size=6), tnn.ClassNLLCriterion(logits=True),
        end_trigger=Trigger.max_iteration(2), device="cpu")
        .set_gradient_accumulation(4))
    with pytest.raises(ValueError, match="not divisible"):
        opt.optimize()
    with pytest.raises(ValueError):
        opt.set_gradient_accumulation(0)
