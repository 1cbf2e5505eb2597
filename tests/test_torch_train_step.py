"""The port's ResNet-50 train step against the JAX package's jitted one.

``ResNet50(class_num=10, stem="space_to_depth")`` at 32x32, batch 4,
``SGD(0.1, momentum=0.9)``, ``ClassNLLCriterion(logits=True)``: the
bench's step (bench.py:215-234) at a CPU size.  The JAX model's ``init``
gives the tree; every leaf is redrawn in numpy with BatchNorm randomised;
both packages get that tree.

Two steps are taken, and each starts from the same trees in both
packages: the port's second step starts from the JAX step's outputs
(params, BatchNorm state and the SGD velocity, carried with
``load_jax_opt_state``).  The trajectory itself cannot be compared over
two steps: with batch statistics over 4 images this network is chaotic
in f32, and the port's own f32 and f64 runs already give second-step
losses 28% apart (1.264 vs 1.618, the unfused model).

Per step, f32: the loss and every running statistic within 1e-3
relative (relative L2 per leaf).  The velocity is the gradient (the
previous velocity is the same in both packages) and the parameter update
is the learning rate times it, so both are held to ``VEL_TOL`` relative
L2 per leaf: the f32 gradient of this network is itself that noisy.  The
port's f32 gradients differ from its own f64 gradients by up to 9% per
leaf (unfused, this size), growing from 5e-5 at the fc layer to 2e-3 at
the last block's BatchNorm and on through the 16 blocks; with the
BatchNorms in eval mode the same comparison gives 1.4e-6, so the
batch-statistics backward over 4 images is the amplifier.  Two f32
implementations then differ by about twice that: measured per-leaf
maxima at the first step of 0.22 (fused) and 0.17 (unfused) with seed 7,
0.038 and 0.12 with seed 3; 0.032 and 0.047 at 64x64 and batch 8.  The
bound is a guard against gross faults (a missing gradient gives 1, a
sign error 2, torch.optim's undampened first step 9); the gradients are
held to 2e-4 block by block in tests/test_torch_train_layers.py.

bf16 (``compute_dtype=bfloat16`` and bf16 features, as bench.py:109):
the same amplifier applied to bf16's 2**-8 rounding leaves the two
packages' gradients uncorrelated at this size (relative L2 near 1 in
every leaf; at 64x64 and batch 8 too, where the losses agree exactly),
so the bf16 case holds what is not noise-dominated: the loss within 0.1
relative (measured 0.049 and 0.027 over the two steps), the running
statistics within 0.25 (measured 0.10), and every output finite.  The
bf16 gradients are held per block in tests/test_torch_train_layers.py
and per kernel in tests/test_torch_train_kernels.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.resnet import ResNet50 as JaxResNet50
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim.optimizer import make_train_step as jax_make_train_step
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import ResNet50
from bigdl_tpu_torch.optim import SGD, make_train_step
from bigdl_tpu_torch.utils import (flatten, load_jax_opt_state,
                                   load_jax_variables, random_variables)

VEL_TOL = 0.3  # relative L2 per leaf of the gradient and the update


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def run_both(fused, compute_dtype, feature_dtype, steps=2, seed=7, res=32,
             batch=4):
    """Per step: (jax outputs, port outputs) as flat numpy dicts, each
    step starting from the JAX step's previous outputs."""
    jm = JaxResNet50(10, stem="space_to_depth", fused=fused)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    v = random_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), template), seed)
    rs = np.random.RandomState(seed + 1)
    x = rs.randn(batch, res, res, 3).astype(np.float32)
    t = rs.randint(0, 10, batch)

    jstep = jax.jit(jax_make_train_step(
        jm, jnn.ClassNLLCriterion(logits=True),
        {"__all__": JaxSGD(0.1, momentum=0.9)},
        compute_dtype=None if compute_dtype is None else jnp.bfloat16))
    model = ResNet50(10, stem="space_to_depth", fused=fused, device="cpu")
    load_jax_variables(model, v)
    tstep = make_train_step(
        model, tnn.ClassNLLCriterion(logits=True),
        {"__all__": SGD(0.1, momentum=0.9)}, compute_dtype=compute_dtype)

    jdt = jnp.bfloat16 if feature_dtype == torch.bfloat16 else jnp.float32
    trees = (v["params"], v["state"],
             {"__all__": JaxSGD(0.1, momentum=0.9).init_state(
                 v["params"])})
    out = []
    for i in range(steps):
        params, state, opt = trees
        jp, js, jo, jl = jstep(
            *jax.tree_util.tree_map(jnp.asarray, (params, state, opt)),
            jnp.asarray(i + 1), jax.random.PRNGKey(i), jnp.asarray(x, jdt),
            jnp.asarray(t), [jnp.asarray(0.1, jnp.float32)])
        tp = {k: torch.tensor(a) for k, a in flatten(params).items()}
        ts = {k: torch.tensor(a) for k, a in flatten(state).items()}
        to = {"__all__": load_jax_opt_state(_numpy(opt["__all__"]), tp)}
        tp, ts, to, tl = tstep(tp, ts, to, i + 1, None,
                               torch.from_numpy(x).to(feature_dtype),
                               torch.from_numpy(t), [0.1])
        trees = _numpy((jp, js, jo))
        want = {"loss": float(jl), "prev": flatten(params),
                "params": flatten(trees[0]),
                "state": flatten(trees[1]),
                "velocity": flatten(trees[2]["__all__"]["velocity"])}
        got = {"loss": float(tl),
               "params": {k: a.numpy() for k, a in tp.items()},
               "state": {k: a.numpy() for k, a in ts.items()},
               "velocity": {k: a.numpy()
                            for k, a in to["__all__"]["velocity"].items()}}
        out.append((want, got))
    return out


def check(steps, loss_tol, leaf_tol, vel_tol=None):
    for i, (want, got) in enumerate(steps):
        assert np.isfinite(got["loss"])
        assert abs(got["loss"] - want["loss"]) <= loss_tol * abs(
            want["loss"]), (i, got["loss"], want["loss"])
        for kind, tol in (("params", vel_tol), ("state", leaf_tol),
                          ("velocity", vel_tol)):
            assert got[kind].keys() == want[kind].keys()
            for k, w in want[kind].items():
                g = got[kind][k]
                assert np.isfinite(g).all(), (i, kind, k)
                if tol is None:
                    continue
                if kind == "params":  # the update
                    g, w = g - want["prev"][k], w - want["prev"][k]
                assert _rel(g, w) <= tol, (i, kind, k, _rel(g, w))


@pytest.mark.parametrize("fused", [True, False])
def test_f32_train_step_matches_jax(fused):
    check(run_both(fused, None, torch.float32), 1e-3, 1e-3, VEL_TOL)


def test_bf16_train_step_matches_jax():
    check(run_both(True, torch.bfloat16, torch.bfloat16), 0.1, 0.25)
