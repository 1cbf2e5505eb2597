"""The JAX package's references of the port's LM parallelism tests (not
a test module): the unsharded models' logits, loss, gradients and one
clipped Adam step, at the sizes of ``torch_lm_worker.SIZE``, and the
comparisons the four ``test_torch_{tensor,sequence,expert}_parallel``/
``test_torch_pipeline`` files share.

Tolerances (f32): the loss to 1e-5 relative, every gathered gradient leaf
and Adam's first moment to 1e-4 relative L2, the logits and the updated
parameters to 1e-4 of each leaf's largest magnitude (one Adam step moves
an element by about the learning rate, 1e-2: a wrong update is 100
times past the limit).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu_torch.utils import flatten

import torch_lm_worker as LW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
B, T = 8, 16


def batch(vocab: int, seed: int):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (B, T)).astype(np.int64),
            rs.randint(0, vocab, (B, T)).astype(np.int64))


def jax_model(vocab: int, moe: int = 0):
    return jnn.Transformer(vocab, causal=True, dropout=0.0, use_flash=False,
                           moe_experts=moe, **LW.SIZE)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def variables(vocab: int, moe: int = 0, seed: int = 0) -> dict:
    """The JAX model's initial variables as numpy, the LayerNorms' and
    biases' zeros and ones moved off by N(0, 0.1^2) so their gradients
    are not special."""
    v = _np(jax_model(vocab, moe).init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 100)

    def jitter(tree):
        out = {}
        for k, a in tree.items():
            if isinstance(a, dict):
                out[k] = jitter(a)
            elif a.ndim == 1:
                out[k] = (a + 0.1 * rs.randn(*a.shape)).astype(np.float32)
            else:
                out[k] = a
        return out

    return {"params": jitter(v["params"]), "state": v["state"]}


def reference(model, variables, x, y) -> dict:
    """``{"logits", "loss", "grads", "params", "m", "step_loss"}`` of the
    JAX model, flat (dotted keys, the port's names)."""
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(logits=True))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax.tree_util.tree_map(jnp.asarray, variables["state"])
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out, new_state = model.apply(p, state, x, training=True, rng=key)
        loss = crit.forward(out, y).astype(jnp.float32)
        for aux in jax.tree_util.tree_leaves(
                {k: v for k, v in flatten(new_state).items()
                 if k.split(".")[-1] == "aux_loss"}):
            loss = loss + 0.01 * aux
        return loss, out

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    method = joptim.Adam(LW.LR)
    step = jax.jit(jax_train_step(model, crit, {"__all__": method},
                                  grad_clip_norm=LW.CLIP))
    opt = {"__all__": method.init_state(params)}
    new, _, opt, step_loss = step(params, state, opt, jnp.asarray(1), key,
                                  x, y, [jnp.asarray(LW.LR, jnp.float32)])
    return {"logits": np.asarray(logits), "loss": float(loss),
            "grads": flatten(_np(grads)), "params": flatten(_np(new)),
            "m": flatten(_np(opt["__all__"]["m"])),
            "step_loss": float(step_loss),
            "grad_norm": float(np.sqrt(sum(
                np.sum(np.square(g)) for g in flatten(_np(grads)).values())))}


def sub(results, prefix):
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in results.items()
            if k.startswith(pre)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def check(results, name, ref, key_map=lambda k: [(k, None)],
          logits=True, grads=True):
    """Hold plan ``name``'s results against the JAX reference; a port
    leaf maps to the reference's leaves (and a stage index of a stacked
    trunk leaf) by ``key_map``."""
    if logits:
        assert scaled(results[f"{name}.logits"], ref["logits"]) \
            <= LEAF_RTOL, name
    if grads:
        assert abs(float(results[f"{name}.loss"]) - ref["loss"]) \
            <= LOSS_RTOL * abs(ref["loss"]), (name, results[f"{name}.loss"],
                                              ref["loss"])
    assert abs(float(results[f"{name}.step_loss"]) - ref["step_loss"]) \
        <= LOSS_RTOL * abs(ref["step_loss"]), name
    seen = set()
    for what, check_fn in (("grads", rel), ("m", rel), ("params", scaled)):
        if what == "grads" and not grads:
            continue
        got = sub(results, f"{name}.{what}")
        assert got, (name, what)
        for k, v in got.items():
            for rk, s in key_map(k):
                g = v if s is None else v[s]
                err = check_fn(g, ref[what][rk])
                assert err <= LEAF_RTOL, (name, what, k, rk, err)
                seen.add(rk)
    assert seen == set(ref["params"]), (name, set(ref["params"]) - seen)


def pipelined_keys(num_stages: int, num_layers: int):
    """A pipelined LM's leaf -> the plain Transformer's leaves (with the
    stage index of a stacked trunk leaf)."""
    per = num_layers // num_stages

    def key_map(k):
        if k.startswith("head."):
            return [(k[len("head."):], None)]
        if k.startswith("tail."):
            return [("ln_f." + k[len("tail."):], None)]
        block, leaf = k[len("trunk.block"):].split(".", 1)
        return [(f"layer{s * per + int(block)}.{leaf}", s)
                for s in range(num_stages)]

    return key_map


def driver_runs(tmp_path, flags: dict, one_rank: dict = None,
                timeout: float = 240):
    """``python -m bigdl_tpu_torch.models.transformer_train`` on one rank
    (``"dp"``, and each of ``one_rank``'s argument lists) and each of
    ``flags``'s under ``torchrun --standalone --nproc_per_node 2``, all at
    once, at JAX's driver test sizes: ``{name: (validation loss, log)}``
    from the log lines."""
    import re

    common = ["-m", "bigdl_tpu_torch.models.transformer_train", "--device",
              "cpu", "--syntheticSize", "4096", "-b", "8", "--maxEpoch", "1",
              "--seqLen", "16", "--hiddenSize", "16", "--numHeads", "2",
              "--filterSize", "32", "--numLayers", "2", "--vocabSize", "50",
              "--dropout", "0.0"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    cmds = {"dp": [sys.executable] + common}
    for name, argv in (one_rank or {}).items():
        cmds[name] = [sys.executable] + common + argv
    for name, argv in flags.items():
        cmds[name] = [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2"] + common + argv
    runs = {}
    for d, cmd in cmds.items():
        (tmp_path / d).mkdir()
        with open(tmp_path / d / "stderr.txt", "w") as err:
            runs[d] = subprocess.Popen(cmd, env=env, cwd=str(tmp_path / d),
                                       stdout=subprocess.DEVNULL, stderr=err)
    try:
        for r in runs.values():
            r.wait(timeout=timeout)
    finally:
        for r in runs.values():
            if r.poll() is None:
                r.kill()
                r.wait()
    out = {}
    for d in cmds:
        text = (tmp_path / d / "stderr.txt").read_text()
        assert runs[d].returncode == 0, (d, text[-3000:])
        found = re.findall(r"validation loss (\d+\.\d+) perplexity", text)
        assert found, (d, text[-3000:])
        out[d] = (float(found[-1]), text)
    shutil.rmtree(tmp_path, ignore_errors=True)
    return out
