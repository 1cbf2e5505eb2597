"""The port's learning-rate schedules and optimization methods
(bigdl_tpu_torch/optim/schedules.py, optim_method.py) against the JAX
package's (bigdl_tpu/optim/schedules.py:14-241, optim_method.py:34-573),
on the CPU in f32.

- Every schedule's rate on a grid of (step, epoch) equals JAX's;
  ``Plateau`` moves as JAX's under the same ``record`` sequence.
- ``Warmup`` in a ``SequentialSchedule`` rises from the base rate by its
  absolute ``delta``: ``current_rate`` binds the base rate first, and a
  schedule never bound gives another rate.
- Each method's update over three steps (from the same parameters,
  gradients drawn per step) equals JAX's within 1e-6, with the rate and
  step as 0-dim tensors, as the compiled step gives them; bf16
  parameters keep f32 state and come back in bf16.
- LARS's update in closed form; several methods by key in one train step
  against JAX's; the host helpers ``optimize(feval, x)``, ``save`` /
  ``load_state`` and ``get_hyper_parameter``; LBFGS, with and without the
  Wolfe search, on Rosenbrock against JAX's; the loop's validation score
  recorded into ``Plateau`` as JAX's loop records it.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.optim.optimizer import make_train_step as jax_make_train_step
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.utils import (flatten, load_jax_variables, load_pytree,
                                   random_variables)

GRID = [(s, e) for s in (0, 1, 7, 49, 50, 99, 100, 101, 250, 999)
        for e in (0, 1, 3, 4, 9)]


def _schedules(o):
    seq = o.SequentialSchedule(10)
    seq.add(o.Warmup(0.05), 50).add(o.Poly(0.5, 200), 200) \
        .add(o.Exponential(30, 0.5, True), 100)
    return {
        "Default": o.Default(),
        "Poly": o.Poly(2.0, 500),
        "Step": o.Step(30, 0.5),
        "MultiStep": o.MultiStep([100, 10, 250], 0.3),
        "EpochStep": o.EpochStep(2, 0.7),
        "EpochDecay": o.EpochDecay(lambda e: e // 3),
        "Exponential": o.Exponential(40, 0.9),
        "Exponential_stair": o.Exponential(40, 0.9, stair_case=True),
        "NaturalExp": o.NaturalExp(25, 0.2),
        "Warmup": o.Warmup(0.01),
        "SequentialSchedule": seq,
        "EpochDecayWithWarmUp": o.EpochDecayWithWarmUp(
            3, 0.02, lambda e: e // 4),
        "PolyEpochDecay": o.PolyEpochDecay(0.5, 8),
    }


@pytest.mark.parametrize("name", sorted(_schedules(joptim)))
def test_schedule_rates_match_jax(name):
    j, t = _schedules(joptim)[name], _schedules(toptim)[name]
    j.bind(0.1)
    t.bind(0.1)
    for step, epoch in GRID:
        assert t.rate(step, epoch) == j.rate(step, epoch), (step, epoch)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_follows_jax_under_the_same_records(mode):
    kw = dict(factor=0.5, patience=2, mode=mode, epsilon=1e-3, cooldown=1,
              min_lr=0.01)
    j, t = joptim.Plateau(**kw), toptim.Plateau(**kw)
    rs = np.random.RandomState(0)
    scores = list(np.cumsum(rs.randn(40) * 0.1))
    scores[10:20] = [scores[9]] * 10  # a flat stretch: the rate must drop
    rates = []
    for v in scores:
        j.record(float(v), 0.1)
        t.record(float(v), 0.1)
        assert t.rate(0) == j.rate(0)
        rates.append(t.rate(0))
    assert min(rates) < 1.0  # it moved


def test_warmup_in_a_sequential_schedule_needs_bind():
    def method(o):
        seq = o.SequentialSchedule(4)
        seq.add(o.Warmup(0.1), 8).add(o.Poly(1.0, 8), 8)
        return o.SGD(0.2, schedule=seq)

    j, t = method(joptim), method(toptim)
    for n in range(16):
        j.state["neval"] = t.state["neval"] = n
        assert t.current_rate() == j.current_rate()
    # the warmup rises by its absolute delta from the base rate ...
    t.state["neval"] = 5
    assert t.current_rate() == pytest.approx(0.2 + 0.1 * 5)
    # ... which a schedule never bound does not give
    unbound = toptim.SequentialSchedule(4)
    unbound.add(toptim.Warmup(0.1), 8)
    assert 0.2 * unbound.rate(5) != pytest.approx(0.2 + 0.1 * 5)


def _methods(o):
    return {
        "SGD": o.SGD(0.1, momentum=0.9, weight_decay=1e-3),
        "SGD_nesterov": o.SGD(0.1, momentum=0.9, dampening=0.0,
                              nesterov=True),
        "Adam": o.Adam(1e-2, weight_decay=1e-3),
        "AdamW": o.AdamW(1e-2, weight_decay=0.1),
        "Adagrad": o.Adagrad(0.1, learning_rate_decay=0.05,
                             weight_decay=1e-3),
        "Adadelta": o.Adadelta(0.9, 1e-6),
        "Adamax": o.Adamax(2e-2),
        "RMSprop": o.RMSprop(1e-2, 0.9),
        "Ftrl": o.Ftrl(0.1, l1_regularization_strength=0.01,
                       l2_regularization_strength=0.02,
                       l2_shrinkage_regularization_strength=0.03),
        "LarsSGD": o.LarsSGD(0.5, momentum=0.9, weight_decay=1e-3,
                             trust=0.8),
    }


def _leaves(seed):
    rs = np.random.RandomState(seed)
    return {"a.weight": rs.randn(4, 3).astype(np.float32),
            "a.bias": rs.randn(3).astype(np.float32),
            "b.weight": np.zeros((2, 2), np.float32)}  # a zero leaf (LARS)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        a, b = k.split(".")
        out.setdefault(a, {})[b] = v
    return out


@pytest.mark.parametrize("name", sorted(_methods(joptim)))
def test_method_three_steps_match_jax(name):
    jm, tm = _methods(joptim)[name], _methods(toptim)[name]
    params = _leaves(0)
    jp = _nest({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for i in range(3):
        g = _leaves(10 + i)
        g["b.weight"] = np.zeros((2, 2), np.float32)
        lr = 0.1 * (i + 1)
        jp, js = jax.jit(jm.update)(
            _nest({k: jnp.asarray(v) for k, v in g.items()}), js, jp,
            jnp.asarray(lr, jnp.float32), jnp.asarray(i + 1, jnp.int32))
        tp, ts = tm.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                           tp, torch.tensor(lr), torch.tensor(i + 1))
    want = flatten(jax.tree_util.tree_map(np.asarray, jp))
    for k, w in want.items():
        np.testing.assert_allclose(tp[k].numpy(), w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for slot, tree in js.items():
        for k, w in flatten(jax.tree_util.tree_map(np.asarray,
                                                   tree)).items():
            assert ts[slot][k].dtype == torch.float32
            np.testing.assert_allclose(ts[slot][k].numpy(), w, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{slot} {k}")


@pytest.mark.parametrize("name", sorted(_methods(toptim)))
def test_method_keeps_bf16_parameters_with_f32_state(name):
    m = _methods(toptim)[name]
    p = {k: torch.tensor(v).bfloat16() for k, v in _leaves(0).items()}
    st = m.init_state(p)
    g = {k: torch.tensor(v).bfloat16() for k, v in _leaves(1).items()}
    new_p, new_st = m.update(g, st, p, torch.tensor(0.1), torch.tensor(1))
    assert all(t.dtype == torch.bfloat16 for t in new_p.values())
    assert all(t.dtype == torch.float32 for slot in new_st.values()
               for t in slot.values())


def test_lars_in_closed_form():
    m = toptim.LarsSGD(0.5, momentum=0.9, weight_decay=0.01, trust=0.7)
    w = np.array([3.0, 4.0], np.float32)  # ||w|| = 5
    g = np.array([0.0, 2.0], np.float32)  # ||g|| = 2
    v0 = np.array([0.1, -0.2], np.float32)
    new_p, st = m.update({"w": torch.tensor(g)},
                         {"velocity": {"w": torch.tensor(v0)}},
                         {"w": torch.tensor(w)}, 0.5)
    ratio = 0.7 * 5.0 / (2.0 + 0.01 * 5.0 + 1e-12)
    v = 0.9 * v0 + 0.5 * ratio * (g + 0.01 * w)
    np.testing.assert_allclose(st["velocity"]["w"].numpy(), v, rtol=1e-6)
    np.testing.assert_allclose(new_p["w"].numpy(), w - v, rtol=1e-6)
    # a zero leaf or a zero gradient without decay: the ratio is 1
    m0 = toptim.LarsSGD(0.5, momentum=0.0)
    p0, _ = m0.update({"w": torch.tensor(g)},
                      {"velocity": {"w": torch.zeros(2)}},
                      {"w": torch.zeros(2)}, 0.5)
    np.testing.assert_allclose(p0["w"].numpy(), -0.5 * g, rtol=1e-6)


def test_several_methods_by_key_in_one_step_match_jax():
    jm, tm = (o.Sequential(o.Linear(5, 7), o.ReLU(), o.Linear(7, 3))
              for o in (jnn, tnn))
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 2)
    load_jax_variables(tm, v)
    rs = np.random.RandomState(1)
    x, y = rs.randn(6, 5).astype(np.float32), rs.randint(0, 3, 6)

    def methods(o):  # sorted: "0" before "2", so the rates go 0.3, 0.01
        return {"2": o.Adam(1e-2), "0": o.LarsSGD(0.3, weight_decay=1e-3)}

    jmeth, tmeth = methods(joptim), methods(toptim)
    jstate = {n: m.init_state({n: v["params"][n]})
              for n, m in jmeth.items()}
    tp = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tstate = {n: m.init_state({k: t for k, t in tp.items()
                               if k.startswith(n + ".")})
              for n, m in tmeth.items()}
    jstep = jax.jit(jax_make_train_step(
        jm, jnn.ClassNLLCriterion(logits=True), jmeth))
    tstep = toptim.make_train_step(tm, tnn.ClassNLLCriterion(logits=True),
                                   tmeth)
    jt = jax.tree_util.tree_map(jnp.asarray,
                                (v["params"], v["state"], jstate))
    tt = (tp, {}, tstate)
    lrs = [0.3, 0.01]
    for i in range(3):
        *jt, jl = jstep(*jt, jnp.asarray(i + 1), jax.random.PRNGKey(0),
                        jnp.asarray(x), jnp.asarray(y),
                        [jnp.asarray(r, jnp.float32) for r in lrs])
        *tt, tl = tstep(*tt, i + 1, None, torch.from_numpy(x),
                        torch.from_numpy(y), lrs)
        assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    for k, w in flatten(jax.tree_util.tree_map(np.asarray, jt[0])).items():
        np.testing.assert_allclose(tt[0][k].numpy(), w, rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for name in ("0", "2"):
        for slot, tree in jt[2][name].items():
            for k, w in flatten(jax.tree_util.tree_map(np.asarray,
                                                       tree)).items():
                np.testing.assert_allclose(tt[2][name][slot][k].numpy(), w,
                                           rtol=1e-6, atol=1e-6)


def _rosenbrock_np(x):
    x = np.asarray(x, np.float64)
    f = np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    g = np.zeros_like(x)
    g[:-1] = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
    g[1:] += 200.0 * (x[1:] - x[:-1] ** 2)
    return f, g


def _feval(kind):
    if kind == "jax":
        def f(x):
            v, g = _rosenbrock_np(np.asarray(x))
            return jnp.asarray(v, jnp.float32), jnp.asarray(g, jnp.float32)
    else:
        def f(x):
            v, g = _rosenbrock_np(x.numpy())
            return (torch.tensor(v, dtype=torch.float32),
                    torch.tensor(g, dtype=torch.float32))
    return f


@pytest.mark.parametrize("line_search", [None, "wolfe"])
def test_lbfgs_on_rosenbrock_matches_jax(line_search):
    x0 = np.array([-1.2, 1.0, -0.5, 0.8], np.float32)
    lr = 1.0 if line_search else 1e-3
    # f32 on both sides: the two trajectories part by rounding after a
    # dozen iterations, so the comparison stops at ten
    j = joptim.LBFGS(max_iter=10, history_size=10, learning_rate=lr,
                     line_search=line_search)
    t = toptim.LBFGS(max_iter=10, history_size=10, learning_rate=lr,
                     line_search=line_search)
    jx, jl = j.optimize(_feval("jax"), jnp.asarray(x0))
    tx, tl = t.optimize(_feval("torch"), torch.tensor(x0))
    assert len(tl) == len(jl) and t.state["neval"] == 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-5)
    assert tl[-1] < (1e-2 if line_search else 1.0) * tl[0]


def test_wolfe_line_search_matches_jax():
    x = np.array([-1.2, 1.0], np.float32)
    f0, g0 = _rosenbrock_np(x)
    d = (-g0 / np.linalg.norm(g0)).astype(np.float32)
    from bigdl_tpu.optim.optim_method import wolfe_line_search

    ja, jl, _, jn = wolfe_line_search(
        _feval("jax"), jnp.asarray(x), jnp.asarray(d), f0,
        jnp.asarray(g0, jnp.float32))
    ta, tl, _, tn = toptim.wolfe_line_search(
        _feval("torch"), torch.tensor(x), torch.tensor(d), f0,
        torch.tensor(g0, dtype=torch.float32))
    assert (ta, tn) == (ja, jn)
    assert tl == pytest.approx(float(jl), rel=1e-6)


def test_host_helpers(tmp_path):
    sched = toptim.SequentialSchedule(2)
    sched.add(toptim.Warmup(0.05), 4).add(toptim.Poly(1.0, 4), 4)
    t = toptim.Adam(0.1, schedule=sched)
    jsched = joptim.SequentialSchedule(2)
    jsched.add(joptim.Warmup(0.05), 4).add(joptim.Poly(1.0, 4), 4)
    j = joptim.Adam(0.1, schedule=jsched)
    x = np.array([1.0, -2.0, 0.5], np.float32)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    for _ in range(5):  # feval: f = |x|^2, the step at neval + 1
        tx, tloss = t.optimize(lambda v: ((v * v).sum(), 2 * v), tx)
        jx, jloss = j.optimize(lambda v: ((v * v).sum(), 2 * v), jx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6)
        assert float(tloss[0]) == pytest.approx(float(jloss[0]), rel=1e-6)
    assert t.state["neval"] == j.state["neval"] == 5
    assert t.get_hyper_parameter() == j.get_hyper_parameter()
    t.state["epoch"] = 3
    t.save(str(tmp_path / "m"))
    blob = load_pytree(str(tmp_path / "m"))
    assert blob["class"] == "Adam" and float(blob["learning_rate"]) == 0.1
    fresh = toptim.Adam(0.1).load_state(blob)
    assert int(fresh.state["neval"]) == 5 and int(fresh.state["epoch"]) == 3


def test_the_loop_records_each_validation_score_into_plateau():
    """The loop hands every validation's score to a schedule with
    ``record`` (optimizer.py:984-987): Plateau moves as under JAX's loop
    on the same MLP, weights and data."""
    from bigdl_tpu.dataset import DataSet as JaxDataSet
    from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocal
    from bigdl_tpu_torch.dataset import DataSet

    rs = np.random.RandomState(0)
    x = rs.randn(32, 5).astype(np.float32)
    y = rs.randint(0, 3, 32)
    jm, tm = (o.Sequential(o.Linear(5, 7), o.ReLU(), o.Linear(7, 3))
              for o in (jnn, tnn))
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 1)
    kw = dict(patience=1, mode="max", factor=0.5, epsilon=0.0)
    jp, tp = joptim.Plateau(**kw), toptim.Plateau(**kw)
    seen = []
    real = tp.record

    def spy(value, base_lr=1.0):
        seen.append((value, base_lr))
        real(value, base_lr)

    tp.record = spy
    jopt = (JaxLocal(jm, JaxDataSet.from_arrays(x, y, 8),
                     jnn.ClassNLLCriterion(logits=True),
                     joptim.Trigger.max_epoch(4))
            .set_optim_method(joptim.SGD(0.5, schedule=jp))
            .set_validation(joptim.Trigger.every_epoch(),
                            JaxDataSet.from_arrays(x, y, 8),
                            [joptim.Top1Accuracy()])
            .set_initial_variables(v))
    jopt.optimize()
    topt = (toptim.Optimizer.apply(
        tm, DataSet.from_arrays(x, y, 8), tnn.ClassNLLCriterion(logits=True),
        end_trigger=toptim.Trigger.max_epoch(4), device="cpu")
        .set_optim_method(toptim.SGD(0.5, schedule=tp))
        .set_validation(toptim.Trigger.every_epoch(),
                        DataSet.from_arrays(x, y, 8),
                        [toptim.Top1Accuracy()])
        .set_initial_variables(v))
    topt.optimize()
    assert len(seen) == 4 and all(lr == 0.5 for _, lr in seen)
    assert seen[-1][0] == topt._loop_state["score"]
    assert (tp._best, tp._scale, tp._wait) == (jp._best, jp._scale, jp._wait)
