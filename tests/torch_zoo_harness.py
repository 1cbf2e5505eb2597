"""Holds a case of tests/torch_zoo_cases.py against the JAX package on
the CPU: seeded numpy variables shaped as the JAX module's (see
:func:`variables`) are carried into the port's module by
``load_jax_variables``; the same seeded inputs go through JAX's ``apply``
under ``jax.vjp`` and through the port's forward and ``backward``, with
one seeded cotangent per output.  The output (values and dtype), the
gradient of every float input and of every parameter, and in training
mode the new state, are compared: f32 to the case's ``tol`` (rtol and
atol relative to the largest |value|, 1e-5 by default: sum order only),
bf16 inputs to ``BF16`` of the largest |value| (a few bf16 steps: the
two packages round the same bf16 values in different orders).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils import load_jax_variables
from bigdl_tpu_torch.utils.convert import flatten
from bigdl_tpu_torch.utils.table import Table as TTable

from torch_zoo_cases import (CASES, build, is_float, leaves as _leaves,
                             out_leaves as _out_leaves)

BF16 = 3e-2


def variables(jm, seed=0):
    """Seeded numpy values shaped as JAX's ``init`` of ``jm`` (its
    shapes from ``jax.eval_shape``: no random op runs): params
    0.5 * N(0, 1), running means 0.1 * N(0, 1), running variances
    U(0.5, 1.5)."""
    key = jax.random.PRNGKey(seed)
    try:
        shapes = jax.eval_shape(jm.init, key)
    except jax.errors.ConcretizationTypeError:  # an init that reads values
        shapes = jm.init(key)
    rs = np.random.RandomState(seed + 100)

    def fill(tree):
        out = {}
        for k, a in tree.items():
            if isinstance(a, dict):
                out[k] = fill(a)
            elif not np.issubdtype(a.dtype, np.floating):
                out[k] = np.zeros(a.shape, a.dtype)
            elif k == "running_var":
                out[k] = rs.uniform(0.5, 1.5, a.shape).astype(a.dtype)
            elif k == "running_mean":
                out[k] = np.asarray(0.1 * rs.randn(*a.shape), a.dtype)
            else:
                out[k] = np.asarray(0.5 * rs.randn(*a.shape), a.dtype)
        return out

    return {"params": fill(shapes.get("params", {})),
            "state": fill(shapes.get("state", {}))}


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def run(name: str, dtype: str = "float32", training: bool = False,
        seed: int = 0):
    """One case in one mode; raises AssertionError on a mismatch."""
    case = CASES[name]
    rs = np.random.RandomState(seed)
    act = case.inputs(rs)
    leaves = _leaves(act)
    jm, tm = case.build(jnn), case.build(tnn)
    v = variables(jm, seed)
    load_jax_variables(tm, v)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tol = BF16 if dtype == "bfloat16" else case.tol
    fidx = [i for i, a in enumerate(leaves) if is_float(a)]

    def jax_fwd(params, floats):
        ls = list(leaves)
        for i, f in zip(fidx, floats):
            ls[i] = f
        x = build(act, [jnp.asarray(a) for a in ls], JTable,
                   lambda a: a)
        return jm.apply(params, v["state"], x, training=training)

    jfloats = [jnp.asarray(leaves[i], jdt) for i in fidx]
    # the forward and its vjp in one compiled call (cheaper than JAX's
    # op-by-op dispatch); a data-dependent output shape runs eagerly
    eager = name == "MaskedSelect"
    shapes = (jax_fwd(v["params"], jfloats) if eager
              else jax.eval_shape(jax_fwd, v["params"], jfloats))[0]
    outs = _out_leaves(shapes)
    cots = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in outs]
    jcot = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)])

    def both(params, floats, cot):
        out, vjp = jax.vjp(jax_fwd, params, floats)
        return out, vjp((cot, jax.tree_util.tree_map(jnp.zeros_like,
                                                     out[1])))

    (jout, jstate), (jg_params, jg_x) = (both if eager else jax.jit(both))(
        v["params"], jfloats, jcot)
    jouts = _out_leaves(jout)

    # the port
    tleaves = [torch.tensor(a, dtype=tdt, requires_grad=True)
               if is_float(a) else torch.from_numpy(np.asarray(a))
               for a in leaves]
    x = build(act, list(tleaves), TTable, lambda t: t)
    tm.train(training)
    tout = tm(x)
    touts = _out_leaves(tout)
    assert len(touts) == len(jouts), (name, len(touts), len(jouts))
    pairs = [(o, torch.from_numpy(c).to(o.dtype))
             for o, c in zip(touts, cots) if o.requires_grad]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])

    for i, (got, want) in enumerate(zip(touts, jouts)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), (
            name, "output dtype", got.dtype, want.dtype)
        _close(got.detach().float().numpy(), np.asarray(want, np.float32),
               tol, f"{name} output {i}")
    for k, i in enumerate(fidx):
        g = tleaves[i].grad
        g = np.zeros(leaves[i].shape) if g is None else g.float().numpy()
        _close(g, np.asarray(jg_x[k], np.float32), tol,
               f"{name} input grad {i}")
    jflat = flatten(jg_params)
    tparams = dict(tm.named_parameters())
    assert sorted(jflat) == sorted(tparams), (name, sorted(jflat),
                                              sorted(tparams))
    for k, p in tparams.items():
        g = (np.zeros(tuple(p.shape)) if p.grad is None
             else p.grad.float().numpy())
        _close(g, np.asarray(jflat[k], np.float32), tol,
               f"{name} grad {k}")
    if training:
        jst = flatten(jax.tree_util.tree_map(np.asarray, jstate))
        for k, b in tm.named_buffers():
            _close(b.numpy(), jst[k], tol, f"{name} state {k}")
    return tout
