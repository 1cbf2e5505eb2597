"""The port's sparse embedding path (bigdl_tpu_torch/optim/
sparse_update.py) against the JAX package's, every case of
tests/test_sparse_update.py: duplicate rows summed, SGD and Adagrad over
row-sparse gradients against the dense update and JAX's, untouched rows
left bit for bit, the embedding train step learning and matching JAX's
step for step from the same weights, the padding rows and the refusal of
``max_norm``.  f32 tolerances: 1e-6 against JAX's update (the same
sums in the same order), 1e-5 against the dense reference (as JAX's
test), 1e-5 on the train step's parameters after a few steps."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import sparse_update as jsu
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.optim import sparse_update as tsu
from bigdl_tpu_torch.utils import flatten, load_jax_variables

TOL = dict(rtol=1e-6, atol=1e-6)


def _dense(idx, g, n):
    out = np.zeros((n, g.shape[1]), np.float32)
    for i, v in zip(idx, g):
        out[i] += v
    return out


def _scatter(rows, n):
    """A SparseRows as its dense (n, dim) sum, the padding dropped."""
    out = np.zeros((n + 1, np.asarray(rows.values).shape[1]), np.float32)
    for i, v in zip(np.asarray(rows.indices), np.asarray(rows.values)):
        out[i] += v
    return out[:n]


def test_row_aggregate_sums_duplicates_as_jax():
    idx = np.asarray([3, 1, 3, 7, 1, 3])
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    got = tsu.row_aggregate(torch.from_numpy(idx), torch.from_numpy(vals),
                            10)
    want = jsu.row_aggregate(jnp.asarray(idx), jnp.asarray(vals), 10)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_allclose(_scatter(got, 10), _dense(idx, vals, 10))


def test_sparse_sgd_matches_dense_and_jax():
    rs = np.random.RandomState(0)
    table = rs.rand(20, 4).astype(np.float32)
    idx = rs.randint(0, 20, (9,))
    g = rs.rand(9, 4).astype(np.float32)
    new, _ = tsu.SparseSGD(0.1).update(
        tsu.row_aggregate(torch.from_numpy(idx), torch.from_numpy(g), 20),
        {}, torch.from_numpy(table), 0.1)
    jnew, _ = jsu.SparseSGD(0.1).update(
        jsu.row_aggregate(jnp.asarray(idx), jnp.asarray(g), 20), {},
        jnp.asarray(table), jnp.asarray(0.1))
    np.testing.assert_allclose(new.numpy(), table - 0.1 * _dense(idx, g, 20),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), **TOL)


def test_sparse_adagrad_matches_dense_adagrad_and_jax():
    """Duplicate indices in one batch: aggregation first keeps the
    accumulator exact ((sum g)^2, not the sum of g^2)."""
    rs = np.random.RandomState(1)
    table = rs.rand(15, 3).astype(np.float32)
    m, jm = tsu.SparseAdagrad(0.5, eps=1e-10), jsu.SparseAdagrad(0.5,
                                                                 eps=1e-10)
    cur, state = torch.from_numpy(table.copy()), None
    state = m.init_state(cur)
    cur_j = jnp.asarray(table)
    state_j = jm.init_state(cur_j)
    accum_ref = np.zeros((15, 3), np.float32)
    ref = table.copy()
    for _ in range(3):
        idx = rs.randint(0, 15, (8,))
        g = rs.rand(8, 3).astype(np.float32)
        cur, state = m.update(tsu.row_aggregate(
            torch.from_numpy(idx), torch.from_numpy(g), 15), state, cur, 0.5)
        cur_j, state_j = jm.update(jsu.row_aggregate(
            jnp.asarray(idx), jnp.asarray(g), 15), state_j, cur_j,
            jnp.asarray(0.5))
        dense_g = _dense(idx, g, 15)
        accum_ref += dense_g ** 2
        ref = ref - 0.5 * np.where(
            dense_g != 0, dense_g / np.sqrt(accum_ref + 1e-10), 0.0)
    np.testing.assert_allclose(cur.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cur.numpy(), np.asarray(cur_j), **TOL)
    np.testing.assert_allclose(state["accum"].numpy(),
                               np.asarray(state_j["accum"]), **TOL)


def test_untouched_rows_unchanged():
    rs = np.random.RandomState(3)
    table = rs.rand(30, 4).astype(np.float32)
    idx = np.asarray([2, 5, 2])
    g = rs.rand(3, 4).astype(np.float32)
    new, _ = tsu.SparseSGD(0.1).update(
        tsu.row_aggregate(torch.from_numpy(idx), torch.from_numpy(g), 30),
        {}, torch.from_numpy(table), 0.1)
    for r in range(30):
        if r not in (2, 5):
            np.testing.assert_array_equal(new[r].numpy(), table[r])


def _models(**emb):
    t = tnn.Sequential(tnn.LookupTable(50, 8, **emb), tnn.Mean(1),
                       tnn.Linear(8, 4))
    j = jnn.Sequential(jnn.LookupTable(50, 8, **emb), jnn.Mean(1),
                       jnn.Linear(8, 4))
    v = jax.tree_util.tree_map(np.array, j.init(jax.random.PRNGKey(0)))
    load_jax_variables(t, v)
    return t, j, v


def test_sparse_embedding_train_step_learns_and_matches_jax():
    """Sequential(LookupTable, Mean, Linear) through the sparse path:
    the loss falls over 60 steps, and the first 5 steps' parameters and
    accumulator equal JAX's."""
    rs = np.random.RandomState(2)
    t, j, v = _models()
    crit = tnn.ClassNLLCriterion(logits=True)
    step = tsu.make_sparse_embedding_train_step(
        t, crit, tsu.SparseAdagrad(0.5), SGD(0.2))
    jstep = jax.jit(jsu.make_sparse_embedding_train_step(
        j, jnn.ClassNLLCriterion(logits=True), jsu.SparseAdagrad(0.5),
        JaxSGD(0.2)))
    params = {k: p.detach().clone() for k, p in t.named_parameters()}
    state = {k: b.detach().clone() for k, b in t.named_buffers()}
    opt = {"table": tsu.SparseAdagrad(0.5).init_state(params["0.weight"]),
           "rest": {}}
    jp, js = v["params"], v["state"]
    jopt = {"table": jsu.SparseAdagrad(0.5).init_state(
        jnp.asarray(jp["0"]["weight"])), "rest": {}}
    losses = []
    for i in range(60):
        tok = rs.randint(0, 50, (16, 1))
        idx, y = np.tile(tok, (1, 5)), tok[:, 0] % 4
        params, state, opt, loss = step(
            params, state, opt, i, None, torch.from_numpy(idx),
            torch.from_numpy(y), (0.5, 0.2))
        losses.append(float(loss))
        if i < 5:
            jp, js, jopt, jloss = jstep(
                jp, js, jopt, jnp.asarray(i), jax.random.PRNGKey(i),
                jnp.asarray(idx), jnp.asarray(y),
                (jnp.asarray(0.5), jnp.asarray(0.2)))
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            want = flatten(jax.tree_util.tree_map(np.asarray, jp))
            for k, p in params.items():
                np.testing.assert_allclose(p.numpy(), want[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
            np.testing.assert_allclose(opt["table"]["accum"].numpy(),
                                       np.asarray(jopt["table"]["accum"]),
                                       rtol=1e-5, atol=1e-5)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_sparse_step_respects_padding_value_as_jax():
    """Pad positions embed to zero and get no gradient."""
    t, j, v = _models(padding_value=0)
    step = tsu.make_sparse_embedding_train_step(
        t, tnn.ClassNLLCriterion(logits=True), tsu.SparseSGD(0.5), SGD(0.1))
    jstep = jax.jit(jsu.make_sparse_embedding_train_step(
        j, jnn.ClassNLLCriterion(logits=True), jsu.SparseSGD(0.5),
        JaxSGD(0.1)))
    params = {k: p.detach().clone() for k, p in t.named_parameters()}
    row0 = params["0.weight"][0].clone()
    idx = np.asarray([[0, 3, 0, 5]] * 4)
    y = np.asarray([0, 1, 0, 1])
    params, _, _, _ = step(params, {}, {"table": {}, "rest": {}}, 0, None,
                           torch.from_numpy(idx), torch.from_numpy(y),
                           (0.5, 0.1))
    jp, _, _, _ = jstep(v["params"], v["state"], {"table": {}, "rest": {}},
                        jnp.asarray(0), jax.random.PRNGKey(0),
                        jnp.asarray(idx), jnp.asarray(y),
                        (jnp.asarray(0.5), jnp.asarray(0.1)))
    assert torch.equal(params["0.weight"][0], row0)
    want = flatten(jax.tree_util.tree_map(np.asarray, jp))
    for k, p in params.items():
        np.testing.assert_allclose(p.numpy(), want[k], **TOL, err_msg=k)


def test_sparse_step_rejects_max_norm():
    t = tnn.Sequential(tnn.LookupTable(20, 4, max_norm=1.0), tnn.Mean(1),
                       tnn.Linear(4, 2))
    with pytest.raises(ValueError, match="max_norm"):
        tsu.make_sparse_embedding_train_step(
            t, tnn.ClassNLLCriterion(logits=True), tsu.SparseSGD(0.5),
            SGD(0.1))
