"""The port's tensor parallelism against the JAX package, on the CPU.

The port runs gloo worlds of 2 and 4 ranks (``tests/torch_lm_worker.py``,
spawned once, every plan inside them); the JAX package runs the unsharded
``nn.Transformer`` of the same configuration in this process, from the
same numpy weights and batch (hidden 16, 4 heads, filter 32, 2 layers, T
16, batch 8).  Vocab 50 shards the embedding over ``model`` at tp 2 (a
masked lookup and the gathered logits); vocab 51, and 50 at tp 4, keep
it replicated (the rules' divisibility fallback).  Each plan holds the
logits, the loss, every gathered gradient, one clipped Adam step's
parameters and first moment (tolerances in ``tests/torch_lm_jax.py``).
A tp-2 step with dropout 0.1 is held against the one-rank port step:
the sharded FFN activation draws its part of the one-rank mask.
"""
import numpy as np
import pytest
import torch

import jax

import torch_dist_worker as W
import torch_lm_jax as LJ
import torch_lm_worker as LW
from bigdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from bigdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bigdl_tpu.parallel.tensor_parallel import \
    make_param_shardings as jax_shardings
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.parallel import mesh as tmesh
from bigdl_tpu_torch.parallel import tensor_parallel as ttp
from bigdl_tpu_torch.utils.serialization import load_pytree

PLANS = {
    2: [dict(name="tp2_v50", mesh={"model": 2}, config="v50", vocab=50),
        dict(name="tp2_v51", mesh={"model": 2}, config="v51", vocab=51),
        dict(name="tp2_dropout", mesh={"model": 2}, config="v50", vocab=50,
             dropout=0.1, one_rank=True)],
    4: [dict(name="tp4_v50", mesh={"model": 4}, config="v50", vocab=50),
        dict(name="tp2_dp2_v50", mesh={"model": 2}, config="v50",
             vocab=50),
        dict(name="tp2_dp2_v51", mesh={"model": 2}, config="v51",
             vocab=51)],
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp")
    inputs = {"vars_v50": LJ.variables(50), "vars_v51": LJ.variables(51)}
    inputs["x"], inputs["y"] = LJ.batch(50, 0)
    inputs["x51"], inputs["y51"] = LJ.batch(51, 1)
    for w, plans in PLANS.items():
        LW.write_world(str(base / f"world{w}"), inputs, plans)
    W.run_worlds(tuple(PLANS), lambda w: base / f"world{w}", LW.lm_world)
    results = {}
    for w in PLANS:
        results.update(load_pytree(str(base / f"world{w}" / "results")))
    refs = {v: LJ.reference(LJ.jax_model(v), inputs[f"vars_v{v}"],
                            *((inputs["x"], inputs["y"]) if v == 50
                              else (inputs["x51"], inputs["y51"])))
            for v in (50, 51)}
    return results, refs


CASES = [p for plans in PLANS.values() for p in plans if not p.get("dropout")]


@pytest.mark.parametrize("plan", CASES, ids=[p["name"] for p in CASES])
def test_tensor_parallel_step_matches_jax(setup, plan):
    results, refs = setup
    LJ.check(results, plan["name"], refs[plan["vocab"]])


def test_clipping_norm_is_active(setup):
    """The clip scales this step (so a wrong norm over the shards moves
    Adam's first moment past its limit)."""
    _, refs = setup
    assert refs[50]["grad_norm"] > LW.CLIP and refs[51]["grad_norm"] > LW.CLIP


def test_tp_dropout_step_equals_one_rank(setup):
    results, _ = setup
    got = LJ.sub(results, "tp2_dropout.params")
    want = LJ.sub(results, "tp2_dropout.one.params")
    assert set(got) == set(want)
    assert abs(float(results["tp2_dropout.step_loss"])
               - float(results["tp2_dropout.one.step_loss"])) <= 1e-5 * abs(
        float(results["tp2_dropout.one.step_loss"]))
    for k in want:
        assert LJ.scaled(got[k], want[k]) <= LJ.LEAF_RTOL, k


class _Ranks:
    """Rank ``r`` of every axis, without a process group."""

    def __init__(self, r):
        self.r = r

    def get_local_rank(self, axis):
        return self.r

    def get_group(self, axis):
        raise AssertionError("no collective here")


def _fake_mesh(model, rank=1):
    return tmesh.Mesh(_Ranks(rank), dict(zip(tmesh.AXES,
                                             (8 // model, model, 1, 1, 1))),
                      torch.device("cpu"), "gloo")


@pytest.mark.parametrize("model,vocab", [(2, 50), (2, 51), (4, 50), (4, 52)])
def test_param_shardings_match_jax(model, vocab):
    """Every leaf splits where JAX's rules split it (the divisibility
    fallback included), from a flat or a nested tree, and this rank's
    part is its slice."""
    from bigdl_tpu.parallel.tensor_parallel import \
        map_with_paths as jax_paths

    jm = jax_make_mesh(JaxMeshConfig(data=-1, model=model))
    jmodel = LJ.jax_model(vocab)
    tpl = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0)))
    want = {}
    jax_paths(jax_shardings(jm, tpl),
              lambda path, s: want.__setitem__(path, tuple(s.spec)))
    port = tnn.Transformer(vocab, dropout=0.0, **LW.SIZE)
    lay = ttp.make_param_shardings(_fake_mesh(model),
                                   dict(port.named_parameters()))
    got = {"/" + k.replace(".", "/"): tuple(v.spec) for k, v in lay.items()}
    assert got == want
    nested = ttp.make_param_shardings(
        _fake_mesh(model), LJ.variables(vocab)["params"])
    assert ttp.describe_shardings(nested) == ttp.describe_shardings(lay)
    wq = lay["layer0.mha.wq"]
    full = torch.arange(16 * 16.0).reshape(16, 16)
    assert torch.equal(wq.local(full), full[:, 16 // model:2 * 16 // model])


def test_shard_variables_cuts_each_leaf():
    port = tnn.Transformer(50, dropout=0.0, **LW.SIZE)
    params = {k: p.detach() for k, p in port.named_parameters()}
    lay = ttp.make_param_shardings(_fake_mesh(2, rank=1), params)
    cut = ttp.shard_variables(params, _fake_mesh(2, rank=1), lay)
    assert cut["layer0.ffn.w2"].shape == (16, 16)
    assert torch.equal(cut["layer0.ffn.w2"], params["layer0.ffn.w2"][16:])
    assert torch.equal(cut["embed.weight"], params["embed.weight"][25:])
    assert torch.equal(cut["layer0.ln1.weight"],
                       params["layer0.ln1.weight"])


def test_sharded_dropout_mask_is_the_global_masks_part():
    from bigdl_tpu_torch.nn.dropout import keep_mask

    whole = keep_mask((4, 6, 8), 0.1, 77, "cpu")
    for r in range(2):
        for s in range(2):
            part = keep_mask((4, 3, 4), 0.1, 77, "cpu",
                             [(1, s, 2), (2, r, 2)])
            assert torch.equal(part, whole[:, 3 * s:3 * s + 3,
                                           4 * r:4 * r + 4])


def test_driver_tp_under_torchrun(tmp_path):
    """``--tp 2`` under ``torchrun --nproc_per_node 2``: the validation
    loss lands in JAX's band around the one-rank run
    (tests/test_pp_ep.py::test_transformer_train_driver_tp_sp)."""
    runs = LJ.driver_runs(tmp_path, {"tp": ["--tp", "2"]})
    dp, tp = runs["dp"][0], runs["tp"][0]
    assert np.isfinite(tp)
    assert abs(tp - dp) < 0.3 * dp
    assert "process group: gloo, rank 1 of 2" in runs["tp"][1]
