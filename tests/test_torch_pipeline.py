"""The port's pipeline parallelism against the JAX package, on the CPU.

Gloo worlds of 2 and 4 ranks (``tests/torch_lm_worker.py``, spawned once)
run ``pipeline_apply`` and ``build_pipeline_train_step`` on a small stage
(held against JAX's on a ``pipe`` mesh of 2 virtual devices, remat on and
off), and ``pipelined_transformer_lm`` under pp 2, pp 2 x dp 2 and
pp 2 x tp 2 (vocab 50 and 51) against JAX's unsharded ``nn.Transformer``
with the same weights (layer ``s * per + i`` is block ``i`` of stage
``s``), and pp 2 x ep 2 against JAX's ``PipelinedLM`` (its MoE capacity
and load-balance loss follow the microbatch).  The trunk's gradient is
held like every other leaf, so an S-fold gradient (each stage handed its
cotangent once per stage) fails by a factor of 2.  A pp 2 x tp 2 world
writes a sharded checkpoint, which a pp 2 world of another layout
restores bit for bit and JAX's ``restore_checkpoint`` reads, and the
blob, which JAX's ``load_pytree`` reads.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import torch_dist_worker as W
import torch_lm_jax as LJ
import torch_lm_worker as LW
from bigdl_tpu import nn as jnn
from bigdl_tpu.distributed.checkpoint import \
    restore_checkpoint as jax_restore
from bigdl_tpu.optim import Adam as JaxAdam
from bigdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from bigdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bigdl_tpu.parallel.pipeline import \
    build_pipeline_train_step as jax_pipe_step
from bigdl_tpu.parallel.pipeline import init_stacked_params as jax_stacked
from bigdl_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from bigdl_tpu.parallel.pipeline import \
    pipelined_transformer_lm as jax_pipelined_lm
from bigdl_tpu.utils.serialization import load_pytree as jax_load_pytree
from bigdl_tpu_torch.distributed.checkpoint import latest_committed
from bigdl_tpu_torch.utils import flatten
from bigdl_tpu_torch.utils.serialization import load_pytree

FN = [dict(name=f"fn_remat_{r}", kind="pipe_fn", mesh={"pipe": 2}, pp_M=3,
           remat=r) for r in (False, True)]


def _plans(root):
    lm = dict(config="v50", vocab=50, zero1=False)
    return {
        2: FN + [dict(lm, name="pp2_v50", mesh={"pipe": 2}, pp_M=4),
                 dict(lm, name="pp2_v51", mesh={"pipe": 2}, pp_M=4,
                      config="v51", vocab=51),
                 dict(lm, name="ckpt_read", kind="ckpt_read",
                      mesh={"pipe": 2}, pp_M=4, root=root)],
        4: [dict(lm, name="ckpt_write", kind="ckpt_write",
                 mesh={"pipe": 2, "model": 2}, pp_M=4, root=root),
            dict(lm, name="pp2_dp2_v50", mesh={"pipe": 2}, pp_M=2),
            dict(lm, name="pp2_tp2_v50", mesh={"pipe": 2, "model": 2},
                 pp_M=4),
            dict(lm, name="pp2_tp2_v51", mesh={"pipe": 2, "model": 2},
                 pp_M=4, config="v51", vocab=51),
            dict(lm, name="pp2_ep2_v50", mesh={"pipe": 2, "expert": 2},
                 pp_M=2, config="moe_v50", moe=4)],
    }


LM_CASES = ["pp2_v50", "pp2_v51", "pp2_dp2_v50", "pp2_tp2_v50",
            "pp2_tp2_v51"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("pp")
    root = str(base / "ckpt")
    inputs = {"vars_v50": LJ.variables(50), "vars_v51": LJ.variables(51),
              "vars_moe_v50": LJ.variables(50, moe=4)}
    inputs["x"], inputs["y"] = LJ.batch(50, 0)
    inputs["x51"], inputs["y51"] = LJ.batch(51, 1)
    stage = jnn.Sequential(jnn.Linear(8, 8), jnn.ReLU())
    stacked = jax.tree_util.tree_map(
        np.asarray, jax_stacked(stage, 2, jax.random.PRNGKey(2)))
    for k, v in flatten(stacked).items():
        inputs[f"pipe_{k}"] = v
    rs = np.random.RandomState(3)
    inputs["pipe_x"] = rs.rand(6, 8).astype(np.float32)
    inputs["pipe_t"] = rs.rand(6, 8).astype(np.float32)
    plans = _plans(root)
    for w, ps in plans.items():
        LW.write_world(str(base / f"world{w}"), inputs, ps)
    W.run_worlds(tuple(plans), lambda w: base / f"world{w}", LW.lm_world,
                 timeout=300)
    results = {}
    for w in plans:
        results.update(load_pytree(str(base / f"world{w}" / "results")))
    refs = {v: LJ.reference(LJ.jax_model(v), inputs[f"vars_v{v}"],
                            *((inputs["x"], inputs["y"]) if v == 50
                              else (inputs["x51"], inputs["y51"])))
            for v in (50, 51)}
    return {"results": results, "refs": refs, "inputs": inputs,
            "stage": stage, "stacked": stacked, "base": base, "root": root}


@pytest.mark.parametrize("plan", FN, ids=[p["name"] for p in FN])
def test_pipeline_apply_and_step_match_jax(setup, plan):
    r, name = setup["results"], plan["name"]
    inputs, stage = setup["inputs"], setup["stage"]
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("pipe",))
    fwd = jax_pipeline(stage, mesh, 3, remat=plan["remat"])
    stacked = jax.tree_util.tree_map(jnp.asarray, setup["stacked"])
    x, t = jnp.asarray(inputs["pipe_x"]), jnp.asarray(inputs["pipe_t"])

    def mse(y, t):
        return jnp.mean((y - t) ** 2)

    y = fwd(stacked, x)
    grads = jax.grad(lambda p: mse(fwd(p, x), t))(stacked)
    assert LJ.scaled(r[f"{name}.y"], np.asarray(y)) <= 1e-5
    for k, g in flatten(jax.tree_util.tree_map(np.asarray, grads)).items():
        assert LJ.rel(r[f"{name}.grads.{k}"], g) <= LJ.LEAF_RTOL, k
    step, init = jax_pipe_step(stage, mesh, 3, mse,
                               optim_method=JaxAdam(0.05))
    params, _, loss = jax.jit(step)(stacked, init(stacked), x, t,
                                    jnp.asarray(1, jnp.int32),
                                    jnp.asarray(0.05, jnp.float32))
    assert abs(float(r[f"{name}.step_loss"]) - float(loss)) <= 1e-5 * float(
        loss)
    for k, p in flatten(jax.tree_util.tree_map(np.asarray, params)).items():
        assert LJ.scaled(r[f"{name}.params.{k}"], p) <= LJ.LEAF_RTOL, k


@pytest.mark.parametrize("name", LM_CASES)
def test_pipelined_lm_step_matches_plain_jax_transformer(setup, name):
    vocab = 51 if name.endswith("v51") else 50
    LJ.check(setup["results"], name, setup["refs"][vocab],
             key_map=LJ.pipelined_keys(2, LW.SIZE["num_layers"]))


def test_trunk_gradient_is_not_s_fold(setup):
    """Each stage's gradient is the plain model's layer's, not S times
    it: the norms' ratio is 1 to the leaves' tolerance."""
    r, ref = setup["results"], setup["refs"][50]
    key_map = LJ.pipelined_keys(2, LW.SIZE["num_layers"])
    for k, g in LJ.sub(r, "pp2_v50.grads").items():
        if not k.startswith("trunk."):
            continue
        for rk, s in key_map(k):
            ratio = np.linalg.norm(g[s]) / np.linalg.norm(ref["grads"][rk])
            assert abs(ratio - 1.0) <= LJ.LEAF_RTOL, (k, s, ratio)


def test_pipelined_moe_matches_jax_pipelined_lm(setup):
    """pp 2 x ep 2 against JAX's PipelinedLM on a pipe mesh of 2 (its
    body manual over data and pipe, so capacity and aux follow the
    microbatch)."""
    inputs = setup["inputs"]
    mesh = jax_make_mesh(JaxMeshConfig(data=1, pipe=2), jax.devices()[:2])
    pmodel = jax_pipelined_lm(50, 16, 4, 32, 2, mesh, num_microbatches=2,
                              dropout=0.0, causal=True, use_flash=False,
                              data_axis="data", moe_experts=4)
    pv = LW.to_pipelined(inputs["vars_moe_v50"], 2, 2)
    ref = LJ.reference(pmodel, {"params": pv["params"],
                                "state": pmodel.init_state()},
                       inputs["x"], inputs["y"])
    LJ.check(setup["results"], "pp2_ep2_v50", ref)


def test_sharded_checkpoint_restores_in_another_layout(setup):
    """The pp 2 x tp 2 commit restores under pp 2 (world 2) bit for bit;
    the port's and JAX's readers assemble the same whole leaves, and
    JAX's ``load_pytree`` reads the blob."""
    r, root = setup["results"], setup["root"]
    wrote = LJ.sub(r, "ckpt_write.final")
    read = LJ.sub(r, "ckpt_read.final")
    assert wrote and set(wrote) == set(read)
    for k in wrote:
        np.testing.assert_array_equal(read[k], wrote[k])
    it, path = latest_committed(root)
    assert it == 2
    tree, _, _ = jax_restore(path)
    got = flatten(jax.tree_util.tree_map(np.asarray, tree["params"]))
    assert set(got) == set(wrote)
    for k in wrote:
        np.testing.assert_array_equal(got[k], wrote[k])
    blob = jax_load_pytree(root + "_blob/model")
    for k, v in flatten(blob["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), wrote[k])


def test_driver_pp_under_torchrun(tmp_path):
    """``--pp 2`` under ``torchrun --nproc_per_node 2`` lands in JAX's
    band around the one-rank run (tests/test_pp_ep.py)."""
    runs = LJ.driver_runs(tmp_path, {"pp": ["--pp", "2"]})
    dp, pp = runs["dp"][0], runs["pp"][0]
    assert np.isfinite(pp)
    assert abs(pp - dp) < 0.5 * dp
