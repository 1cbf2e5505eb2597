"""The port's expert parallelism (Switch MoE) against the JAX package, on
the CPU.

Gloo worlds of 2 and 4 ranks (``tests/torch_lm_worker.py``, spawned once)
run one ``MoE`` layer with its banks over ``expert`` (ep 2, and ep 2 x dp
2, where capacity, queue positions and the load-balance loss are the
global batch's) at capacity factor 4 (no token overflows) and 0.5
(tokens dropped), held against JAX's ``MoE`` on the whole batch: output,
``aux_loss`` and gradients to 1e-5 / 1e-4; and the LM with
``moe_experts=4`` (``--ep 2``, vocab 50 and 51; ep 2 x dp 2; MoE under
dp 4) against JAX's unsharded ``nn.Transformer(moe_experts=4)``, its
``aux_loss`` times 0.01 in the loss (tolerances in
``tests/torch_lm_jax.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as W
import torch_lm_jax as LJ
import torch_lm_worker as LW
from bigdl_tpu.parallel.expert import MoE as JaxMoE
from bigdl_tpu.parallel.expert import \
    expert_param_shardings as jax_expert_shardings
from bigdl_tpu.parallel.expert import \
    transformer_expert_shardings as jax_transformer_expert
from bigdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from bigdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.parallel import expert as texpert
from bigdl_tpu_torch.parallel import mesh as tmesh
from bigdl_tpu_torch.utils import flatten
from bigdl_tpu_torch.utils.serialization import load_pytree

CAPACITY = (4.0, 0.5)  # no overflow, overflow
MOE = {2: [dict(name=f"moe_ep2_cf{c}", kind="moe", mesh={"expert": 2},
                moe=4, capacity=c) for c in CAPACITY],
       4: [dict(name=f"moe_ep2_dp2_cf{c}", kind="moe", mesh={"expert": 2},
                moe=4, capacity=c) for c in CAPACITY]}
LM = {2: [dict(name=f"ep2_v{v}", mesh={"expert": 2}, config=f"moe_v{v}",
               vocab=v, moe=4) for v in (50, 51)],
      4: [dict(name="ep2_dp2_v50", mesh={"expert": 2}, config="moe_v50",
               vocab=50, moe=4),
          dict(name="moe_dp4_v50", mesh={}, config="moe_v50", vocab=50,
               moe=4)]}
MOE_CASES = [p for w in MOE for p in MOE[w]]
LM_CASES = [p for w in LM for p in LM[w]]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("ep")
    inputs = {"vars_moe_v50": LJ.variables(50, moe=4),
              "vars_moe_v51": LJ.variables(51, moe=4)}
    inputs["x"], inputs["y"] = LJ.batch(50, 0)
    inputs["x51"], inputs["y51"] = LJ.batch(51, 1)
    moe = JaxMoE(16, 32, 4)
    inputs["moe_params"] = jax.tree_util.tree_map(
        np.asarray, moe.init_params(jax.random.PRNGKey(5)))
    inputs["x_moe"] = np.random.RandomState(6).randn(8, 4, 16).astype(
        np.float32)
    for w in (2, 4):
        LW.write_world(str(base / f"world{w}"), inputs, MOE[w] + LM[w])
    W.run_worlds((2, 4), lambda w: base / f"world{w}", LW.lm_world)
    results = {}
    for w in (2, 4):
        results.update(load_pytree(str(base / f"world{w}" / "results")))
    refs = {v: LJ.reference(LJ.jax_model(v, moe=4), inputs[f"vars_moe_v{v}"],
                            *((inputs["x"], inputs["y"]) if v == 50
                              else (inputs["x51"], inputs["y51"])))
            for v in (50, 51)}
    return results, refs, inputs


@pytest.mark.parametrize("plan", MOE_CASES, ids=[p["name"] for p in
                                                  MOE_CASES])
def test_moe_layer_matches_jax(setup, plan):
    results, _, inputs = setup
    moe = JaxMoE(16, 32, 4, capacity_factor=plan["capacity"])
    params = jax.tree_util.tree_map(jnp.asarray, inputs["moe_params"])
    x = jnp.asarray(inputs["x_moe"])

    def loss(p):
        y, st = moe.apply(p, moe.init_state(), x, training=True)
        return jnp.mean(y ** 2) + st["aux_loss"], (y, st["aux_loss"])

    (_, (y, aux)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    name = plan["name"]
    dropped = int(np.sum(np.all(np.asarray(y) == 0, axis=-1)))
    assert (dropped > 0) == (plan["capacity"] < 1.0), dropped
    assert LJ.scaled(results[f"{name}.y"].reshape(y.shape), np.asarray(y)) \
        <= 1e-5
    assert abs(float(results[f"{name}.aux"]) - float(aux)) <= 1e-5 * float(
        aux)
    for k, g in grads.items():
        assert LJ.rel(results[f"{name}.grads.{k}"], np.asarray(g)) \
            <= LJ.LEAF_RTOL, (name, k)


@pytest.mark.parametrize("plan", LM_CASES, ids=[p["name"] for p in LM_CASES])
def test_moe_lm_step_matches_jax(setup, plan):
    results, refs, _ = setup
    LJ.check(results, plan["name"], refs[plan["vocab"]])


class _Ranks:
    def get_local_rank(self, axis):
        return 1

    def get_group(self, axis):
        raise AssertionError("no collective here")


def _fake_mesh(expert):
    return tmesh.Mesh(_Ranks(), dict(zip(tmesh.AXES,
                                         (8 // expert, 1, 1, expert, 1))),
                      torch.device("cpu"), "gloo")


def test_expert_shardings_match_jax():
    jm = jax_make_mesh(JaxMeshConfig(data=-1, expert=2))
    params = LJ.variables(50, moe=4)["params"]
    want = {k: tuple(s.spec) for k, s in flatten(jax_transformer_expert(
        jm, params)).items()}
    port = tnn.Transformer(50, dropout=0.0, moe_experts=4, **LW.SIZE)
    got = texpert.transformer_expert_shardings(
        _fake_mesh(2), dict(port.named_parameters()))
    assert {k: tuple(v.spec) for k, v in got.items()} == want
    one = {k: tuple(s.spec) for k, s in jax_expert_shardings(
        jm, params["layer0"]["ffn"]).items()}
    assert {k: tuple(v.spec) for k, v in texpert.expert_param_shardings(
        _fake_mesh(2), dict(port.layer0.ffn.named_parameters())).items()} \
        == one


def test_indivisible_experts_refused_as_jax():
    port = tnn.Transformer(50, dropout=0.0, moe_experts=3, **LW.SIZE)
    with pytest.raises(ValueError, match="do not divide"):
        texpert.transformer_expert_shardings(
            _fake_mesh(2), dict(port.named_parameters()))
    with pytest.raises(ValueError, match="do not divide"):
        jax_transformer_expert(
            jax_make_mesh(JaxMeshConfig(data=-1, expert=2)),
            LJ.variables(50, moe=3)["params"])


@pytest.mark.parametrize("capacity", CAPACITY)
def test_moe_dispatch_has_fixed_shapes(capacity):
    """Every op of the MoE's forward and backward has a shape fixed by
    the input's (meta tensors carry no values, so an op whose output size
    depends on the data raises), as a CUDA graph capture of the step
    needs."""
    moe = texpert.MoE(16, 32, 4, capacity_factor=capacity).to("meta")
    x = torch.empty(8, 4, 16, device="meta", requires_grad=True)
    y = moe(x)
    y.sum().backward()
    assert y.shape == x.shape and x.grad.shape == x.shape
    assert moe.w_in.grad.shape == moe.w_in.shape


def test_aux_loss_sits_at_jax_state_path():
    port = tnn.Transformer(50, dropout=0.0, moe_experts=4, **LW.SIZE)
    jstate = flatten(LJ.jax_model(50, moe=4).init_state())
    assert {k for k, _ in port.named_buffers()} == set(jstate)


def test_driver_ep_under_torchrun(tmp_path):
    """``--moeExperts 4`` on one CPU rank and ``--ep 2`` under ``torchrun
    --nproc_per_node 2`` land in JAX's band around the dense run; the
    driver's refusals are JAX's."""
    from bigdl_tpu_torch.models import transformer_train

    for argv, match in ((["--tp", "2", "--ep", "2"], "tp x ep"),
                        (["--ep", "2", "--moeExperts", "3"], "must divide")):
        with pytest.raises(SystemExit, match=match):
            transformer_train.main(argv + ["--device", "cpu"])
    runs = LJ.driver_runs(tmp_path, {"ep": ["--ep", "2"]},
                          one_rank={"moe": ["--moeExperts", "4"]})
    dp = runs["dp"][0]
    for name in ("ep", "moe"):
        assert np.isfinite(runs[name][0])
        assert abs(runs[name][0] - dp) < 0.7 * dp, (name, runs[name][0], dp)
