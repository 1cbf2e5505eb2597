"""The port's compiled calls on the CPU: the traced step, learning rate
and seed that a captured train step replays with (bigdl_tpu_torch.utils.
graphs compiles on the card; on the CPU "compiled" is the eager call),
the donated step, the serving engine's compile counter and the copy of
its outputs.

Tolerances: the optimizers' updates with 0-dim tensor ``step``/``lr``
equal the Python-number updates bit for bit (the same ops on the same
values) and JAX's jitted updates (traced ``step``) within 1e-6 relative
in f32 (``1 - b**t`` is the only op whose rounding may differ); the train
step with device scalars and the donated step equal the Python-number,
functional step bit for bit.  Dropout's mask is a function of the seed:
the same seed gives the same mask, another seed another, and the keep
rate lies within 3 sigma of ``1 - p``, as JAX's does.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import SGD as JaxSGD, Adam as JaxAdam
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.dropout import keep_mask
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import int8_matmul
from bigdl_tpu_torch.optim import (SGD, Adam, CompiledTrainStep,
                                   make_train_step)
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.utils import (export_variables, graphs,
                                   load_jax_variables, random_variables)

SHAPES = {"w": (7, 5), "b": (5,), "e": (11, 3)}


def _trees(seed):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    return params, grads


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


OPTIMS = {
    "adam": (lambda: Adam(1e-2, weight_decay=1e-3),
             lambda: JaxAdam(1e-2, weight_decay=1e-3)),
    "sgd": (lambda: SGD(0.1, momentum=0.9, weight_decay=1e-3),
            lambda: JaxSGD(0.1, momentum=0.9, weight_decay=1e-3)),
    "nesterov": (lambda: SGD(0.1, momentum=0.9, dampening=0.0,
                             nesterov=True),
                 lambda: JaxSGD(0.1, momentum=0.9, dampening=0.0,
                                nesterov=True)),
    "dampened": (lambda: SGD(0.05, momentum=0.5, dampening=0.2),
                 lambda: JaxSGD(0.05, momentum=0.5, dampening=0.2)),
}


# ------------------------------------------------------------ traced step
@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_update_with_tensor_step_and_lr(name):
    """Three updates with ``step``/``lr`` as 0-dim tensors equal the
    Python-number updates bit for bit, and JAX's jitted update with a
    traced step within 1e-6."""
    make, make_jax = OPTIMS[name]
    p0, grads = _trees(1)
    lrs = (0.1, 0.05, 0.02)
    runs = []
    for as_tensor in (False, True):
        m = make()
        params = _torch(p0)
        state = m.init_state(params)
        for i, g in enumerate(grads):
            step = torch.tensor(i + 1) if as_tensor else i + 1
            lr = torch.tensor(lrs[i]) if as_tensor else lrs[i]
            params, state = m.update(_torch(g), state, params, lr, step)
        runs.append(params)
    for k in SHAPES:
        assert torch.equal(runs[0][k], runs[1][k]), k

    jm = make_jax()
    update = jax.jit(jm.update)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jm.init_state(jp)
    for i, g in enumerate(grads):
        jp, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                        jnp.asarray(lrs[i], jnp.float32),
                        jnp.asarray(i + 1, jnp.int32))
    for k in SHAPES:
        want = np.asarray(jp[k])
        err = np.abs(runs[1][k].numpy() - want).max() / np.abs(want).max()
        assert err < 1e-6, (k, err)


# ---------------------------------------------------------------- seeds
def _as_int64(seed):
    return seed - (1 << 64) if seed >> 63 else seed


def test_split_rng_tensor_form_matches_int_form():
    rs = np.random.RandomState(0)
    seeds = [int(v) for v in rs.randint(0, 2 ** 62, 600, dtype=np.int64)]
    seeds += [(1 << 63) | s for s in seeds[:300]]  # the top bit set
    seeds += [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1] * 20
    idx = rs.randint(0, 1 << 20, len(seeds))
    t = torch.tensor([_as_int64(s) for s in seeds], dtype=torch.int64)
    for i in sorted(set(int(v) for v in idx[:8])) + [0, 3]:
        got = tnn.split_rng(t, i).tolist()
        assert got == [tnn.split_rng(s, i) for s in seeds], i
    for s, i in zip(seeds, idx):
        i = int(i)
        got = tnn.split_rng(torch.tensor(_as_int64(s)), i)
        assert got.dtype == torch.int64 and got.dim() == 0
        assert got.item() == tnn.split_rng(s, i)
    assert tnn.split_rng(None, 3) is None


def test_dropout_mask_is_a_function_of_the_seed_tensor():
    p, shape = 0.3, (300, 400)
    seeds = [tnn.split_rng(7, step) for step in range(4)]
    masks = [keep_mask(shape, p, torch.tensor(s), "cpu") for s in seeds]
    assert torch.equal(masks[0], keep_mask(shape, p, seeds[0], "cpu"))
    assert torch.equal(masks[0], keep_mask(shape, p, torch.tensor(seeds[0]),
                                           "cpu"))
    n = masks[0].numel()
    sigma = (p * (1 - p) / n) ** 0.5
    for a in masks:
        assert abs(a.float().mean().item() - (1 - p)) < 3 * sigma
    for a, b in zip(masks, masks[1:]):  # two steps: two masks
        assert not torch.equal(a, b)
        # independent draws agree on keep^2 + drop^2 of the elements
        agree = (a == b).float().mean().item()
        want = (1 - p) ** 2 + p ** 2
        s = (want * (1 - want) / n) ** 0.5
        assert abs(agree - want) < 3 * s
    # neighbours within a row are not correlated either
    m = masks[0].float()
    corr = np.corrcoef(m[:, :-1].reshape(-1), m[:, 1:].reshape(-1))[0, 1]
    assert abs(corr) < 3 / n ** 0.5


def test_dropout_distribution_matches_jax():
    """JAX's threefry and the port's hash drop different elements; both
    keep 1 - p of them within 3 sigma and scale the kept ones alike."""
    p, shape = 0.1, (256, 512)
    x = np.ones(shape, np.float32)
    n = x.size
    sigma = (p * (1 - p) / n) ** 0.5
    jd = jnn.Dropout(p)
    drop = tnn.Dropout(p).train()
    for step in range(3):
        jy = np.asarray(jd.apply({}, {}, jnp.asarray(x), training=True,
                                 rng=jax.random.PRNGKey(step))[0])
        ty = drop(torch.from_numpy(x), rng=torch.tensor(
            tnn.split_rng(7, step))).numpy()
        for y in (jy, ty):
            kept = y != 0
            assert abs(kept.mean() - (1 - p)) < 3 * sigma
            np.testing.assert_allclose(y[kept], np.float32(1 / (1 - p)))


# ---------------------------------------------------- train step scalars
VOCAB, D, HEADS, FILTER = 50, 32, 4, 64


def _lm(dropout):
    m = tnn.Transformer(VOCAB, D, HEADS, FILTER, 1, dropout=dropout)
    m.initialize(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randint(0, VOCAB, (3, 16)))
    y = torch.from_numpy(rs.randint(0, VOCAB, (3, 16)))
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(logits=True))
    return m, crit, x, y, Adam(1e-2)


def _resnet_blocks():
    m = tnn.Sequential(tnn.FusedBottleneck(16, 4, 1),
                       tnn.FusedBottleneck(16, 8, 2),
                       tnn.GlobalAveragePooling2D(), tnn.Linear(32, 10))
    load_jax_variables(m, random_variables(export_variables(m), 3))
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(4, 8, 8, 16).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4))
    return m, tnn.ClassNLLCriterion(logits=True), x, y, \
        SGD(0.1, momentum=0.9)


CASES = {"lm": lambda: _lm(0.0), "lm_dropout": lambda: _lm(0.2),
         "fused_resnet": _resnet_blocks}


def _fresh(model, method):
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    return params, state, {"__all__": method.init_state(params)}


def _equal_trees(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_with_tensor_scalars_equals_numbers(case):
    model, crit, x, y, method = CASES[case]()
    step = make_train_step(model, crit, {"__all__": method},
                           grad_clip_norm=1.0)
    runs = []
    for as_tensor in (False, True):
        trees = _fresh(model, method)
        losses = []
        for i in range(3):
            seed = tnn.split_rng(7, i)
            args = ((torch.tensor(i + 1), torch.tensor(seed),
                     [torch.tensor(0.05)]) if as_tensor
                    else (i + 1, seed, [0.05]))
            *trees, loss = step(*trees, args[0], args[1], x, y, args[2])
            losses.append(loss)
        runs.append((trees, losses))
    assert _equal_trees(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_donated_step_equals_functional_step(case):
    """The compiled step (eager on the CPU) updates the trees it is given
    in place and returns them; after three steps they equal the
    functional step's new trees, and the losses are equal."""
    model, crit, x, y, method = CASES[case]()
    step = make_train_step(model, crit, {"__all__": method})
    donated = CompiledTrainStep(step)
    functional = _fresh(model, method)
    trees = _fresh(model, method)
    for i in range(3):
        seed = tnn.split_rng(7, i)
        *functional, want = step(*functional, i + 1, seed, x, y, [0.05])
        out = donated(*trees, i + 1, seed, x, y, [0.05])
        assert all(a is b for a, b in zip(out[:3], trees))
        assert torch.equal(out[3], want)
    assert _equal_trees(trees, functional)
    # one signature, one "compile"; the CPU has no graphs to replay
    assert len(donated.graphs) == 1 and donated.captures == 0


def test_donated_step_compiles_per_batch_shape():
    model, crit, x, y, method = _resnet_blocks()
    donated = CompiledTrainStep(make_train_step(model, crit,
                                                {"__all__": method}))
    trees = _fresh(model, method)
    donated(*trees, 1, None, x, y, [0.1])
    donated(*trees, 2, None, x[:3], y[:3], [0.1])  # a last, partial batch
    donated(*trees, 3, None, x, y, [0.1])
    assert len(donated.graphs) == 2


# ------------------------------------------------------- compile helpers
def test_compile_is_the_eager_call_on_the_cpu():
    def fn(a, b):
        return a + b
    x = torch.ones(3)
    assert graphs.compile(fn, (x, x)) is fn
    assert graphs.signature((x, [x, 2])) == graphs.signature(
        (torch.zeros(3), [torch.zeros(3), 2]))
    assert graphs.signature(x) != graphs.signature(torch.ones(4))
    assert graphs.signature(x) != graphs.signature(x.double())
    tree = {"a": x, "b": [x, None]}
    c = graphs.clone(tree)
    assert c["a"] is not x and torch.equal(c["a"], x) and c["b"][1] is None
    assert graphs.leaves(tree) == [x, x, None]


class _Replays:
    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def test_compiled_call_copies_into_its_static_inputs():
    """A compiled call copies each tensor argument into its static input
    (cast to its type), skips one that is that input, replays once and
    returns the static outputs; a shape or constant that differs from
    the capture's raises.  (The graph is a stand-in: the CPU has none.)"""
    x, w = torch.zeros(2, 3, dtype=torch.bfloat16), torch.ones(3)
    c = graphs.Compiled.__new__(graphs.Compiled)
    c._static, c.graph, c.outputs, c.replays = [x, w, 4], _Replays(), "out", 0
    before = graphs.COUNTS["replays"]
    assert c(torch.full((2, 3), 1.5), w, 4) == "out"
    assert x.dtype == torch.bfloat16 and torch.equal(
        x, torch.full((2, 3), 1.5, dtype=torch.bfloat16))
    assert c.graph.n == c.replays == 1
    assert graphs.COUNTS["replays"] - before == 1
    with pytest.raises(ValueError, match="capture had"):
        c(torch.zeros(3, 2), w, 4)
    with pytest.raises(ValueError, match="constant 5"):
        c(x, w, 5)
    with pytest.raises(ValueError, match="argument leaves"):
        c(x, w)
    assert c.graph.n == 1


def test_kernel_build_and_workspace_refuse_a_capture(monkeypatch):
    """nvcc cannot run inside a capture, and memory first allocated
    inside one belongs to the graph: both raise, naming the cure."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="before capturing"):
        _build.load("int8_matmul")
    monkeypatch.setattr(int8_matmul, "_workspaces", {})
    with pytest.raises(RuntimeError, match="before capturing"):
        int8_matmul._workspace(torch.device("cuda", 0))


def test_evaluate_caches_one_forward_per_shape():
    """One compiled forward per input shape, cached on the model (not
    copied with it), giving the eager forward's answers."""
    import copy

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Top1Accuracy, evaluate

    model, crit, x, y, method = _resnet_blocks()
    params, state, _ = _fresh(model, method)
    model.eval()
    with torch.no_grad():
        correct = float((model(x).argmax(-1) == y).sum())
    for batch in (4, 2, 4):
        ds = DataSet.from_arrays(x.numpy(), y.numpy(), batch_size=batch)
        (_, res), = evaluate(model, params, state, ds, [Top1Accuracy()])
        assert (res.correct, res.count) == (correct, 4)
    assert len(model._compiled_eval) == 2
    assert len(copy.deepcopy(model)._compiled_eval) == 0


# ------------------------------------------------------------- serving
FEAT = 16


def _engine(model, **kw):
    kw.setdefault("buckets", [(8, FEAT), (16, FEAT)])
    kw.setdefault("batch_sizes", (1, 4))
    kw.setdefault("device", "cpu")
    return ServingEngine(model, **kw)


def test_engine_counts_compiles():
    torch.manual_seed(0)
    model = tnn.Sequential(tnn.Linear(FEAT, 8)).eval()
    engine = _engine(model)
    declared = len(engine.declared_buckets)
    assert engine.recompiles == engine.metrics.recompiles == declared == 4
    assert engine.metrics.first_sights == declared
    assert engine.warmup() == 0 and engine.recompiles == declared
    engine.predict(np.ones((5, FEAT), np.float32), timeout=30)
    assert engine.recompiles == declared  # a declared bucket: no compile
    engine.predict(np.ones((20, FEAT), np.float32), timeout=30)
    assert engine.recompiles == declared + 1  # undeclared: once
    engine.predict(np.ones((20, FEAT), np.float32), timeout=30)
    assert engine.recompiles == declared + 1
    assert "recompiles=5" in engine.log_line()
    assert engine.metrics.snapshot()["recompile_seconds"] >= 0.0
    engine.close()


class _ReusedBuffer(torch.nn.Module):
    """A forward that returns one f32 buffer, rewritten every call, as a
    compiled forward returns its graph's static output."""

    def __init__(self):
        super().__init__()
        self.register_buffer("out", torch.zeros(4, 3))

    def forward(self, x):
        self.out.copy_(x.sum(-1, keepdim=True).expand(-1, 3))
        return self.out


def test_engine_results_do_not_alias_the_forward_output():
    engine = _engine(_ReusedBuffer(), buckets=[(FEAT,)], batch_sizes=(4,),
                     start=False)
    xa = np.ones((4, FEAT), np.float32)
    ya = engine._run(xa)
    yb = engine._run(2 * xa)
    assert ya.data_ptr() != yb.data_ptr()
    assert torch.equal(ya, torch.full((4, 3), float(FEAT)))
    assert torch.equal(yb, torch.full((4, 3), 2.0 * FEAT))
    engine.close()
