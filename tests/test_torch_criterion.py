"""The port's criteria (bigdl_tpu_torch/nn/criterion.py) against the JAX
package's (bigdl_tpu/nn/criterion.py), on the CPU.

Every class and both aliases: the loss of ``forward`` and the input
gradient of ``backward`` (the table of gradients, in the input's
container, for the table criteria) from the same seeded numpy inputs,
with ``size_average`` both ways where the constructor takes it, and the
result's dtype equal to JAX's.  f32 is held at rtol 1e-5 / atol 1e-6;
bf16 inputs of the classes that cast to f32 before they reduce (MSE, Abs,
SmoothL1, BCE, BCEWithLogits, MultiLabelSoftMargin) at 1e-2: the
difference is the bf16 rounding of the input gradient.  A
``CriterionAdapter`` stands in a port ``Graph`` as in a JAX one.
"""
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import load_jax_variables

N, C = 4, 5


def _softmax(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _sign(rs, *shape):
    return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _f(a):
    return np.asarray(a, np.float32)


def _labels(rs, *shape, c=C):
    return rs.randint(0, c, shape).astype(np.int64)


def _randn(rs, *shape):
    return _f(rs.randn(*shape))


def _pair(rs, *shape):
    return _randn(rs, *shape), _randn(rs, *shape)


# name -> (factory(m, **kw) building the criterion from nn module m,
#          inputs(rs) -> (input, target) of numpy arrays or tables)
CASES = {
    "ClassNLLCriterion": (
        lambda m, **kw: m.ClassNLLCriterion(logits=True, **kw),
        lambda rs: (_randn(rs, N, C), _labels(rs, N))),
    "CrossEntropyCriterion": (
        lambda m, **kw: m.CrossEntropyCriterion(**kw),
        lambda rs: (_randn(rs, N, C), _labels(rs, N))),
    "MSECriterion": (lambda m, **kw: m.MSECriterion(**kw),
                     lambda rs: _pair(rs, N, 3, 2)),
    "AbsCriterion": (lambda m, **kw: m.AbsCriterion(**kw),
                     lambda rs: _pair(rs, N, 3, 2)),
    "L1Cost": (lambda m, **kw: m.L1Cost(**kw), lambda rs: _pair(rs, N, C)),
    "SmoothL1Criterion": (
        lambda m, **kw: m.SmoothL1Criterion(**kw),
        lambda rs: (_f(rs.randn(N, C) * 2), _randn(rs, N, C))),
    "BCECriterion": (
        lambda m, **kw: m.BCECriterion(**kw),
        lambda rs: (_f(rs.uniform(0.05, 0.95, (N, C))),
                    _f(rs.uniform(0, 1, (N, C))))),
    "BCEWithLogitsCriterion": (
        lambda m, **kw: m.BCEWithLogitsCriterion(**kw),
        lambda rs: (_f(rs.randn(N, C) * 2), _f(rs.rand(N, C) > 0.5))),
    "SigmoidBinaryCrossEntropy": (
        lambda m, **kw: m.SigmoidBinaryCrossEntropy(**kw),
        lambda rs: (_f(rs.randn(N, C) * 2), _f(rs.rand(N, C) > 0.5))),
    "MarginCriterion": (
        lambda m, **kw: m.MarginCriterion(0.7, **kw),
        lambda rs: (_randn(rs, N, C), _sign(rs, N, C))),
    "MarginCriterion_squared": (
        lambda m, **kw: m.MarginCriterion(squared=True, **kw),
        lambda rs: (_randn(rs, N, C), _sign(rs, N, C))),
    "HingeEmbeddingCriterion": (
        lambda m, **kw: m.HingeEmbeddingCriterion(1.5, **kw),
        lambda rs: (_f(np.abs(rs.randn(N, C)) * 1.2), _sign(rs, N, C))),
    "DistKLDivCriterion": (
        lambda m, **kw: m.DistKLDivCriterion(**kw),
        lambda rs: (_f(np.log(_softmax(rs.randn(N, C)))),
                    _f(_softmax(rs.randn(N, C)) * (rs.rand(N, C) > 0.3)))),
    "KLDCriterion": (lambda m, **kw: m.KLDCriterion(**kw),
                     lambda rs: (_pair(rs, N, 3), None)),
    "KLDCriterion_dict": (
        lambda m, **kw: m.KLDCriterion(**kw),
        lambda rs: (dict(zip((1, 2), _pair(rs, N, 3))), None)),
    "CosineEmbeddingCriterion": (
        lambda m, **kw: m.CosineEmbeddingCriterion(0.1, **kw),
        lambda rs: (_pair(rs, N, 6), _sign(rs, N))),
    "MarginRankingCriterion": (
        lambda m, **kw: m.MarginRankingCriterion(0.5, **kw),
        lambda rs: (_pair(rs, N), _sign(rs, N))),
    "MultiLabelSoftMarginCriterion": (
        lambda m, **kw: m.MultiLabelSoftMarginCriterion(**kw),
        lambda rs: (_f(rs.randn(N, C) * 2), _f(rs.rand(N, C) > 0.5))),
    "MultiMarginCriterion": (
        lambda m, **kw: m.MultiMarginCriterion(margin=0.8, **kw),
        lambda rs: (_randn(rs, N, C), _labels(rs, N))),
    "MultiMarginCriterion_p2": (
        lambda m, **kw: m.MultiMarginCriterion(p=2, **kw),
        lambda rs: (_randn(rs, N, C), _labels(rs, N))),
    "SoftMarginCriterion": (
        lambda m, **kw: m.SoftMarginCriterion(**kw),
        lambda rs: (_randn(rs, N, C), _sign(rs, N, C))),
    "MultiCriterion": (
        lambda m: m.MultiCriterion().add(m.MSECriterion(), 0.5)
        .add(m.AbsCriterion(), 2.0),
        lambda rs: _pair(rs, N, C)),
    "ParallelCriterion": (
        lambda m: m.ParallelCriterion().add(m.MSECriterion(), 0.5)
        .add(m.ClassNLLCriterion(logits=True)),
        lambda rs: ((_randn(rs, N, 3), _randn(rs, N, C)),
                    (_randn(rs, N, 3), _labels(rs, N)))),
    "ParallelCriterion_repeat": (
        lambda m: m.ParallelCriterion(repeat_target=True)
        .add(m.MSECriterion(), 0.5).add(m.AbsCriterion(), 1.5),
        lambda rs: ([_randn(rs, N, C), _randn(rs, N, C)],
                    _randn(rs, N, C))),
    "TimeDistributedCriterion": (
        lambda m, **kw: m.TimeDistributedCriterion(
            m.ClassNLLCriterion(logits=True), **kw),
        lambda rs: (_randn(rs, 2, 3, C), _labels(rs, 2, 3))),
    "ClassSimplexCriterion": (lambda m, **kw: m.ClassSimplexCriterion(**kw),
                              lambda rs: _pair(rs, N, C)),
    "DiceCoefficientCriterion": (
        lambda m, **kw: m.DiceCoefficientCriterion(epsilon=0.5, **kw),
        lambda rs: (_f(rs.rand(N, 2, 3)), _f(rs.rand(N, 2, 3) > 0.5))),
    "MeanAbsolutePercentageCriterion": (
        lambda m, **kw: m.MeanAbsolutePercentageCriterion(**kw),
        lambda rs: (_randn(rs, N, C),
                    _f(rs.randn(N, C) + _sign(rs, N, C) * 0.5))),
    "MeanSquaredLogarithmicCriterion": (
        lambda m, **kw: m.MeanSquaredLogarithmicCriterion(**kw),
        lambda rs: (_f(rs.uniform(0.01, 2, (N, C))),
                    _f(rs.uniform(0.01, 2, (N, C))))),
    "KullbackLeiblerDivergenceCriterion": (
        lambda m, **kw: m.KullbackLeiblerDivergenceCriterion(**kw),
        lambda rs: (_f(_softmax(rs.randn(N, C))),
                    _f(_softmax(rs.randn(N, C))))),
    "PoissonCriterion": (
        lambda m, **kw: m.PoissonCriterion(**kw),
        lambda rs: (_f(rs.uniform(0.1, 2, (N, C))),
                    _f(rs.poisson(1.0, (N, C))))),
    "CosineProximityCriterion": (
        lambda m, **kw: m.CosineProximityCriterion(**kw),
        lambda rs: _pair(rs, N, C)),
    "CategoricalCrossEntropy": (
        lambda m, **kw: m.CategoricalCrossEntropy(**kw),
        lambda rs: (_f(_softmax(rs.randn(N, C))),
                    _f(np.eye(C)[_labels(rs, N)]))),
    "CosineDistanceCriterion": (
        lambda m, **kw: m.CosineDistanceCriterion(**kw),
        lambda rs: _pair(rs, N, C)),
    "DotProductCriterion": (lambda m, **kw: m.DotProductCriterion(**kw),
                            lambda rs: _pair(rs, N, C)),
    "PGCriterion": (
        lambda m, **kw: m.PGCriterion(**kw),
        lambda rs: (_f(_softmax(rs.randn(N, C))),
                    _f(np.eye(C)[_labels(rs, N)] * rs.randn(N, 1)))),
    "GaussianCriterion": (lambda m, **kw: m.GaussianCriterion(**kw),
                          lambda rs: (_pair(rs, N, 3), _randn(rs, N, 3))),
    "GaussianCriterion_list": (
        lambda m, **kw: m.GaussianCriterion(**kw),
        lambda rs: (list(_pair(rs, N, 3)), _randn(rs, N, 3))),
    "GaussianCriterion_dict": (
        lambda m, **kw: m.GaussianCriterion(**kw),
        lambda rs: (dict(zip((1, 2), _pair(rs, N, 3))), _randn(rs, N, 3))),
    "L1HingeEmbeddingCriterion": (
        lambda m: m.L1HingeEmbeddingCriterion(2.0),
        lambda rs: (_pair(rs, 6), np.float32(1.0))),
    "L1HingeEmbeddingCriterion_negative": (
        lambda m: m.L1HingeEmbeddingCriterion(9.0),
        lambda rs: (list(_pair(rs, 6)), np.array([-1.0], np.float32))),
    "L1HingeEmbeddingCriterion_dict": (
        lambda m: m.L1HingeEmbeddingCriterion(9.0),
        lambda rs: (dict(zip((1, 2), _pair(rs, 6))), np.float32(-1.0))),
    "MultiLabelMarginCriterion": (
        lambda m, **kw: m.MultiLabelMarginCriterion(**kw),
        lambda rs: (_randn(rs, N, C), np.array(
            [[3, 0, -1, 1, 2], [2, -1, 4, 0, -1], [0, 3, -1, -1, -1],
             [4, 1, 1, 2, -1]], np.int64))),
    "SmoothL1CriterionWithWeights": (
        lambda m: m.SmoothL1CriterionWithWeights(sigma=2.0, num=3),
        lambda rs: (_f(rs.randn(N, C)), (
            _randn(rs, N, C), _f(rs.rand(N, C)), _f(rs.rand(N, C))))),
    "SmoothL1CriterionWithWeights_dict": (
        lambda m: m.SmoothL1CriterionWithWeights(sigma=0.5),
        lambda rs: (_f(rs.randn(N, C) * 3), dict(zip((3, 1, 2), (
            _f(rs.rand(N, C)), _randn(rs, N, C), _f(rs.rand(N, C))))))),
    "SmoothL1CriterionWithWeights_bare": (
        lambda m: m.SmoothL1CriterionWithWeights(),
        lambda rs: (_f(rs.randn(N, C) * 2), _randn(rs, N, C))),
    **{f"SoftmaxWithCriterion_{mode}": (
        lambda m, mode=mode: m.SoftmaxWithCriterion(1, mode),
        lambda rs: (_randn(rs, 2, C, 3, 3), _labels(rs, 2, 3, 3)))
       for mode in ("VALID", "FULL", "BATCH_SIZE", "NONE")},
    "SoftmaxWithCriterion_no_ignore": (
        lambda m: m.SoftmaxWithCriterion(),
        lambda rs: (_randn(rs, 2, C, 3), _labels(rs, 2, 3))),
    "TimeDistributedMaskCriterion": (
        lambda m: m.TimeDistributedMaskCriterion(
            m.ClassNLLCriterion(logits=True)),
        lambda rs: (_randn(rs, 2, 4, C), np.array([[3, 1, 0, 0],
                                                   [2, 4, 1, 0]]))),
    "TimeDistributedMaskCriterion_mse": (
        lambda m: m.TimeDistributedMaskCriterion(m.MSECriterion(), 7),
        lambda rs: (_randn(rs, 2, 3, 2), np.where(
            np.arange(6).reshape(2, 3, 1) % 4 == 1, 7.0,
            rs.randn(2, 3, 2)).astype(np.float32))),
    "TransformerCriterion": (
        lambda m: m.TransformerCriterion(m.MSECriterion(), m.Linear(4, 3),
                                         m.Linear(4, 3)),
        lambda rs: _pair(rs, N, 4)),
    "TransformerCriterion_input_only": (
        lambda m: m.TransformerCriterion(m.AbsCriterion(), m.Linear(4, 4)),
        lambda rs: _pair(rs, N, 4)),
}
# the classes that cast to f32 before they reduce
F32_CASTS = ("MSECriterion", "AbsCriterion", "L1Cost", "SmoothL1Criterion",
             "BCECriterion", "BCEWithLogitsCriterion",
             "SigmoidBinaryCrossEntropy", "MultiLabelSoftMarginCriterion",
             "ClassSimplexCriterion")


def _takes_size_average(name):
    factory = CASES[name][0]
    return "kw" in inspect.signature(factory).parameters


def _convert(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, fn) for v in tree)
    return fn(np.asarray(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _pair_up(name, kw, dtype=None):
    """(JAX criterion, port criterion, JAX (input, target), port (input,
    target)); bf16 ``dtype`` casts the floating inputs on both sides."""
    factory, inputs = CASES[name]
    jc, tc = factory(jnn, **kw), factory(tnn, **kw)
    for attr in ("input_transformer", "target_transformer"):
        jm = getattr(jc, attr, None)
        if jm is not None:
            tv = jc._vars_in if attr == "input_transformer" else jc._vars_tgt
            load_jax_variables(getattr(tc, attr), jax.tree_util.tree_map(
                np.asarray, tv))
    rs = np.random.RandomState(sum(map(ord, name)))
    x, t = inputs(rs)

    def jconv(a):
        if dtype is not None and a.dtype == np.float32:
            return jnp.asarray(a, jnp.bfloat16)
        return jnp.asarray(a)

    def tconv(a):
        out = torch.from_numpy(np.array(a))
        return out.to(dtype) if dtype is not None and \
            out.dtype == torch.float32 else out

    return (jc, tc, (_convert(x, jconv), _convert(t, jconv)),
            (_convert(x, tconv), _convert(t, tconv)))


def _check(name, kw, dtype=None, rtol=1e-5, atol=1e-6):
    jc, tc, (jx, jt), (tx, tt) = _pair_up(name, kw, dtype)
    want = jc.forward(jx, jt)
    got = tc.forward(tx, tt)
    assert str(got.dtype) == f"torch.{jnp.asarray(want).dtype}", \
        (name, got.dtype, want.dtype)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=f"{name} loss")
    want_g = jc.backward(jx, jt)
    got_g = tc.backward(tx, tt)
    if isinstance(want_g, (tuple, list, dict)):
        assert type(got_g) is type(want_g), (name, type(got_g))
    if isinstance(want_g, dict):
        assert list(got_g) == list(want_g)
    for g, w in zip(_leaves(got_g), _leaves(want_g), strict=True):
        assert str(g.dtype) == f"torch.{w.dtype}", (name, g.dtype, w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"{name} gradient")


@pytest.mark.parametrize("name", sorted(CASES))
def test_criterion_matches_jax(name):
    _check(name, {})


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if _takes_size_average(n)))
def test_criterion_size_average_flipped_matches_jax(name):
    default = getattr(CASES[name][0](tnn), "size_average")
    _check(name, {"size_average": not default})


@pytest.mark.parametrize("name", F32_CASTS)
def test_f32_casting_criterion_on_bf16_matches_jax(name):
    _check(name, {}, dtype=torch.bfloat16, rtol=1e-2, atol=1e-2)


def test_every_jax_criterion_has_a_port():
    names = [n for n, v in vars(jnn).items()
             if isinstance(v, type) and issubclass(v, jnn.Criterion)]
    names += ["L1Cost", "SigmoidBinaryCrossEntropy", "CriterionAdapter"]
    assert len(set(names)) >= 40
    for n in names:
        assert n in tnn.__all__ and hasattr(tnn, n), n
        base = n.split("_")[0]
        assert any(c == base or c.startswith(base + "_") for c in CASES) \
            or n in ("Criterion", "CriterionAdapter"), n
    assert tnn.L1Cost is tnn.AbsCriterion
    assert tnn.SigmoidBinaryCrossEntropy is tnn.BCEWithLogitsCriterion


def test_size_average_defaults_follow_jax():
    for name in CASES:
        jc = CASES[name][0](jnn)
        tc = CASES[name][0](tnn)
        assert tc.size_average == jc.size_average, name


def test_time_distributed_mask_restores_the_inner_setting():
    inner = tnn.ClassNLLCriterion(logits=True)
    crit = tnn.TimeDistributedMaskCriterion(inner)
    with pytest.raises(RuntimeError):
        crit(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, 5))  # bad target
    assert inner.size_average is True
    crit(torch.zeros(2, 3, 4), torch.ones(2, 3, dtype=torch.long))
    assert inner.size_average is True


def test_transformer_criterion_holds_no_gradient_on_the_target_branch():
    lin = tnn.Linear(4, 3)
    crit = tnn.TransformerCriterion(tnn.MSECriterion(), None, lin.train())
    x = torch.randn(2, 3, requires_grad=True)
    crit(x, torch.randn(2, 4)).backward()
    assert x.grad is not None and lin.weight.grad is None
    assert lin.training  # applied in eval, its mode restored


def test_criterion_adapter_in_a_graph_matches_jax():
    rs = np.random.RandomState(11)
    x, t = _randn(rs, N, C), _labels(rs, N)
    outs = {}
    for m in (jnn, tnn):
        xi, ti = m.Input(), m.Input()
        node = m.CriterionAdapter(m.CrossEntropyCriterion(),
                                  name="loss").inputs(xi, ti)
        outs[m] = m.Graph([xi, ti], [node])
    g = outs[jnn]
    want, _ = g.apply(g.init_params(jax.random.PRNGKey(0)), g.init_state(),
                      (jnp.asarray(x), jnp.asarray(t)))
    got = outs[tnn]((torch.from_numpy(x), torch.from_numpy(t)))
    assert outs[tnn].child_keys == list(g.child_keys) == ["loss"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
