"""Training the port's Transformer LM against the JAX package.

``Transformer(vocab 50, hidden 32, 4 heads, filter 64, 2 layers,
dropout 0)`` on token windows of 32, batch 3, with the trainer's method:
``Adam(1e-3)`` and clipping by the global L2 norm at 1.0 (the norm at
these weights is above 1, so the clip acts).  The tree is the JAX
model's shape with every leaf redrawn in numpy; both packages start from
it and take three steps each, in f32: the loss, every parameter and
Adam's ``m`` and ``v`` agree within 1e-5 relative L2 per leaf after every
step (the LM has no BatchNorm and is well conditioned, so the two
trajectories stay together).  One step with bf16 compute is held to the
tolerances of ``BF16_TOL`` below.  The loop, the validation, the driver
and the text helpers are checked on the CPU.
"""
import logging
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.models.ptb_train import _load_corpus as jax_load_corpus
from bigdl_tpu.optim.optimizer import make_train_step as jax_make_train_step
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset import text as ttext
from bigdl_tpu_torch.models import transformer_train
from bigdl_tpu_torch.utils import (export_opt_state, flatten,
                                   load_jax_opt_state, load_jax_variables)

VOCAB, D, HEADS, FILTER, LAYERS = 50, 32, 4, 64, 2
LR, CLIP = 1e-3, 1.0
# one bf16-compute step, relative to the JAX step: the loss (bf16 logits
# and log-softmax round at other places in the two packages; measured
# equal) and, per leaf, the relative L2 of Adam's m, which is the clipped
# gradient times 0.1 (measured 0.025 median, 0.066 max).  The parameter
# update is not compared: at the first step it is lr * g / |g| per
# element, so it differs only where a near-zero gradient element changes
# sign (0.12 median); it is held to |update| <= lr instead.
BF16_TOL = {"loss": 2e-2, "m": 0.1}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _setup(seed=0, dropout=0.0):
    jm = jnn.Transformer(VOCAB, D, HEADS, FILTER, LAYERS, dropout=dropout)
    tree = _numpy(jm.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)

    def fill(path, a):
        if a.ndim == 2:
            return (rs.randn(*a.shape) / math.sqrt(a.shape[0])
                    ).astype(np.float32)
        scale = 1.0 if getattr(path[-1], "key", "") == "weight" else 0.0
        return (scale + 0.1 * rs.randn(*a.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, tree)
    tm = tnn.Transformer(VOCAB, D, HEADS, FILTER, LAYERS, dropout=dropout)
    load_jax_variables(tm, v)
    rs = np.random.RandomState(seed + 1)
    batches = [(rs.randint(0, VOCAB, (3, 32)), rs.randint(0, VOCAB, (3, 32)))
               for _ in range(3)]
    return jm, tm, v, batches


def _crits():
    return (jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(logits=True)),
            tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(logits=True)))


def _trees(tm):
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    return params, {}, {"__all__": toptim.Adam(LR).init_state(params)}


def _run(compute, steps):
    """Per step: (JAX loss, params, m, v; port loss, params, m, v), both
    packages from the same tree and their own previous step."""
    jm, tm, v, batches = _setup()
    jcrit, tcrit = _crits()
    jstep = jax.jit(jax_make_train_step(
        jm, jcrit, {"__all__": joptim.Adam(LR)}, grad_clip_norm=CLIP,
        compute_dtype=None if compute is None else jnp.bfloat16))
    tstep = toptim.make_train_step(tm, tcrit, {"__all__": toptim.Adam(LR)},
                                   grad_clip_norm=CLIP, compute_dtype=compute)
    jt = (v["params"], v["state"],
          {"__all__": joptim.Adam(LR).init_state(v["params"])})
    tt = _trees(tm)
    out = []
    for i in range(steps):
        x, y = batches[i]
        *jt, jl = jstep(*jt, jnp.asarray(i + 1, jnp.int32), None,
                        jnp.asarray(x), jnp.asarray(y),
                        [jnp.asarray(LR, jnp.float32)])
        *tt, tl = tstep(*tt, i + 1, None, torch.tensor(x), torch.tensor(y),
                        [LR])
        jo = jt[2]["__all__"]
        to = tt[2]["__all__"]
        out.append(((float(jl), flatten(_numpy(jt[0])),
                     flatten(_numpy(jo["m"])), flatten(_numpy(jo["v"]))),
                    (float(tl), {k: a.numpy() for k, a in tt[0].items()},
                     {k: a.numpy() for k, a in to["m"].items()},
                     {k: a.numpy() for k, a in to["v"].items()})))
    return v, out


def test_the_clip_acts_at_these_weights():
    _, tm, _, batches = _setup()
    _, tcrit = _crits()
    x, y = (torch.tensor(a) for a in batches[0])
    loss = tcrit(tm.train()(x), y)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    norm = math.sqrt(sum(float((g * g).sum()) for g in grads))
    assert norm > 1.2 * CLIP, norm


def test_three_adam_steps_with_clipping_match_jax_f32():
    _, out = _run(None, 3)
    for step, ((jl, jp, jmo, jv), (tl, tp, tmo, tv)) in enumerate(out, 1):
        assert abs(tl - jl) < 1e-5 * abs(jl), (step, tl, jl)
        assert tp.keys() == jp.keys()
        for name, got, want in (("param", tp, jp), ("m", tmo, jmo),
                                ("v", tv, jv)):
            for k in want:
                assert _rel(got[k], want[k]) < 1e-5, (step, name, k)


def test_one_bf16_compute_step():
    v, [((jl, jp, jmo, _), (tl, tp, tmo, _))] = _run(torch.bfloat16, 1)
    assert math.isfinite(tl)
    assert abs(tl - jl) < BF16_TOL["loss"] * abs(jl), (tl, jl)
    p0 = flatten(v["params"])
    for k in jp:
        assert tp[k].dtype == np.float32  # f32 masters
        assert _rel(tmo[k], jmo[k]) < BF16_TOL["m"], k
        # plus the f32 rounding of a parameter near 1 (6e-8)
        assert np.abs(tp[k] - p0[k]).max() <= LR + 1e-7, k


def test_constant_clipping_matches_jax():
    jm, tm, v, batches = _setup()
    jcrit, tcrit = _crits()
    x, y = batches[0]
    jstep = jax_make_train_step(jm, jcrit, {"__all__": joptim.SGD(0.5)},
                                grad_clip_const=(-1e-3, 1e-3))
    tstep = toptim.make_train_step(tm, tcrit, {"__all__": toptim.SGD(0.5)},
                                   grad_clip_const=(-1e-3, 1e-3))
    jp, *_ = jstep(v["params"], v["state"], {"__all__": {}}, 1, None,
                   jnp.asarray(x), jnp.asarray(y), [0.5])
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tp, *_ = tstep(params, {}, {"__all__": {}}, 1, None, torch.tensor(x),
                   torch.tensor(y), [0.5])
    jp = flatten(_numpy(jp))
    for k in jp:
        assert _rel(tp[k].numpy(), jp[k]) < 1e-5, k
        # SGD(0.5) moves every element by at most 0.5 * 1e-3
        assert np.abs(tp[k].numpy() - params[k].numpy()).max() <= 5.01e-4


def test_adam_state_carries_across():
    v, [((_, _, jmo, jv), _)] = _run(None, 1)
    _, tm, _, _ = _setup()
    params = dict(tm.named_parameters())
    tree = {"m": _unflatten(jmo, v["params"]),
            "v": _unflatten(jv, v["params"])}
    state = load_jax_opt_state(tree, params)
    assert set(state) == {"m", "v"}
    for k, a in jmo.items():
        np.testing.assert_array_equal(state["m"][k].numpy(), a)
    back = export_opt_state(tm, state)
    assert jax.tree_util.tree_structure(back["v"]) == \
        jax.tree_util.tree_structure(v["params"])


def _unflatten(flat, template, prefix=""):
    return {k: (_unflatten(flat, t, f"{prefix}{k}.") if isinstance(t, dict)
                else flat[f"{prefix}{k}"]) for k, t in template.items()}


def test_rng_reaches_dropout():
    _, tm, v, batches = _setup(dropout=0.3)
    _, tcrit = _crits()
    step = toptim.make_train_step(tm, tcrit, {"__all__": toptim.Adam(LR)})
    x, y = (torch.tensor(a) for a in batches[0])
    losses = [float(step(*_trees(tm), 1, rng, x, y, [LR])[-1])
              for rng in (11, 11, 12)]
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="needs an rng"):
        step(*_trees(tm), 1, None, x, y, [LR])


def test_evaluate_matches_jax():
    jm, tm, v, batches = _setup()
    jcrit, tcrit = _crits()
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    want = joptim.evaluate(jm, v["params"], v["state"],
                           JaxDataSet.from_arrays(xs, ys, batch_size=3),
                           [joptim.Loss(jcrit), joptim.Top1Accuracy()])
    params = {k: p.detach() for k, p in tm.named_parameters()}
    got = toptim.evaluate(tm, params, {},
                          DataSet.from_arrays(xs, ys, batch_size=3),
                          [toptim.Loss(tcrit), toptim.Top1Accuracy()])
    for (_, w), (_, g) in zip(want, got):
        assert g.result()[1] == w.result()[1]
        assert abs(g.result()[0] - w.result()[0]) < 1e-5 * abs(
            w.result()[0]) + 1e-7


def test_local_optimizer_validates(caplog):
    _, tm, _, batches = _setup()
    _, tcrit = _crits()
    xs = np.concatenate([b[0] for b in batches] * 2)
    ys = np.concatenate([b[1] for b in batches] * 2)
    with caplog.at_level(logging.INFO, logger="bigdl_tpu_torch.optim"):
        opt = (toptim.Optimizer.apply(
            tm, DataSet.from_arrays(xs, ys, batch_size=3), tcrit,
            end_trigger=toptim.Trigger.max_epoch(2), device="cpu")
            .set_optim_method(toptim.Adam(LR))
            .set_gradient_clipping_by_l2_norm(CLIP)
            .set_validation(toptim.Trigger.every_epoch(),
                            DataSet.from_arrays(xs[:6], ys[:6], batch_size=3),
                            [toptim.Loss(tcrit)]))
        opt.optimize()
    lines = [r.getMessage() for r in caplog.records]
    val = [m for m in lines if m.startswith("Loss is Loss(")]
    assert len(val) == 2 and val[0].endswith("6 records)"), lines
    assert opt._loop_state["neval"] == 12
    score = opt._loop_state["score"]
    res = toptim.evaluate(tm, opt.final_params, opt.final_state,
                          DataSet.from_arrays(xs[:6], ys[:6], batch_size=3),
                          [toptim.Loss(tcrit)])
    assert res[0][1].result()[0] == pytest.approx(score, rel=1e-6)


def test_transformer_train_main_on_the_cpu():
    out = transformer_train.main([
        "--maxEpoch", "2", "-b", "4", "--seqLen", "32",
        "--vocabSize", "50", "--hiddenSize", "32", "--numHeads", "4",
        "--filterSize", "64", "--numLayers", "1", "--dropout", "0.0",
        "--syntheticSize", "4096", "--device", "cpu",
    ])
    assert np.isfinite(out["val_loss"])
    assert out["perplexity"] < 50


@pytest.mark.parametrize("argv,match", [
    (["--tp", "2"], "parallelism"), (["--moeExperts", "4"], "parallelism"),
    (["--checkpoint", "/nonexistent"], "checkpoint")])
def test_transformer_train_options_not_ported(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        transformer_train.main(argv + [
            "--maxEpoch", "1", "-b", "2", "--seqLen", "8", "--vocabSize",
            "20", "--hiddenSize", "16", "--numHeads", "2", "--filterSize",
            "16", "--numLayers", "1", "--syntheticSize", "256",
            "--device", "cpu"])


def test_text_helpers_match_jax(tmp_path):
    ids = np.random.RandomState(0).randint(0, 100, 1000)
    for got, want in zip(ttext.ptb_batchify(ids, 4, 7),
                         jtext.ptb_batchify(ids, 4, 7)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(transformer_train._load_corpus(None, 60, 3000),
                         jax_load_corpus(None, 60, 3000)):
        np.testing.assert_array_equal(got, want)
    rs = np.random.RandomState(1)
    words = [f"w{i}" for i in range(30)]
    for name in ("ptb.train.txt", "ptb.valid.txt"):
        lines = [" ".join(rs.choice(words, rs.randint(3, 9)))
                 for _ in range(40)]
        (tmp_path / name).write_text("\n".join(lines[:20] + [""]
                                               + lines[20:]) + "\n")
    for got, want in zip(transformer_train._load_corpus(str(tmp_path), 20, 0),
                         jax_load_corpus(str(tmp_path), 20, 0)):
        np.testing.assert_array_equal(got, want)
    sents = ttext.read_sentences(str(tmp_path / "ptb.train.txt"))
    assert sents == jtext.read_sentences(str(tmp_path / "ptb.train.txt"))
    toks = [s.split() for s in sents]
    td = ttext.Dictionary(iter(toks), vocab_size=12)
    jd = jtext.Dictionary(iter(toks), vocab_size=12)
    assert td.idx2word == jd.idx2word and td.vocab_size == 12
    np.testing.assert_array_equal(td.to_indices(["w1", "zz"]),
                                  jd.to_indices(["w1", "zz"]))
