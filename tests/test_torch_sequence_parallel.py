"""The port's sequence parallelism against the JAX package, on the CPU.

Gloo worlds of 2 and 4 ranks (``tests/torch_lm_worker.py``, spawned once)
run ``ring_attention`` and ``ulysses_attention`` on their sequence blocks
(held against JAX's functions on a ``seq`` mesh of the 8 virtual
devices, forward and gradients, causal and not, to 1e-5 of the largest
value), and the LM with ``seq_mesh`` in both modes, alone (sp 2, sp 2 x
dp 2) and under tensor parallelism (tp 2 x sp 2, vocab 50 and 51),
against JAX's unsharded ``nn.Transformer`` (tolerances in
``tests/torch_lm_jax.py``): each rank encodes its global positions, the
ring's causal mask comes from global positions, its targets are the
part matching its logits, and the loss is the global tokens' mean.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as W
import torch_lm_jax as LJ
import torch_lm_worker as LW
from bigdl_tpu.nn.attention import PositionEncode as JaxPositionEncode
from bigdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from bigdl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bigdl_tpu.parallel.sequence import ring_attention as jax_ring
from bigdl_tpu.parallel.sequence import ulysses_attention as jax_ulysses
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.ops.partition import kernel_mesh_scope
from bigdl_tpu_torch.parallel import mesh as tmesh
from bigdl_tpu_torch.utils.serialization import load_pytree

ATTN = [dict(name=f"attn_{mode}_{'causal' if c else 'full'}_w{w}",
             kind="attn", mesh={"seq": 2}, sp_mode=mode, causal=c)
        for w in (2,) for mode in ("ring", "ulysses") for c in (True, False)]
PLANS = {
    2: ATTN + [dict(name=f"sp2_{mode}_v{v}", mesh={"seq": 2},
                    config=f"v{v}", vocab=v, sp_mode=mode)
               for mode in ("ring", "ulysses") for v in (50, 51)],
    4: [dict(name=f"tp2_sp2_{mode}_v{v}", mesh={"model": 2, "seq": 2},
             config=f"v{v}", vocab=v, sp_mode=mode)
        for mode in ("ring", "ulysses") for v in (50, 51)]
    + [dict(name="sp2_dp2_ring_v50", mesh={"seq": 2}, config="v50",
            vocab=50, sp_mode="ring")],
}
LM_CASES = [p for plans in PLANS.values() for p in plans
            if p.get("kind") is None]
ATTN_TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("sp")
    inputs = {"vars_v50": LJ.variables(50), "vars_v51": LJ.variables(51)}
    inputs["x"], inputs["y"] = LJ.batch(50, 0)
    inputs["x51"], inputs["y51"] = LJ.batch(51, 1)
    rs = np.random.RandomState(7)
    for n in "qkvw":
        inputs[f"attn_{n}"] = rs.randn(4, 4, 16, 8).astype(np.float32)
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
    return results, refs, inputs


@pytest.mark.parametrize("plan", ATTN, ids=[p["name"] for p in ATTN])
def test_attention_functions_match_jax(setup, plan):
    results, _, inputs = setup
    mesh = jax_make_mesh(JaxMeshConfig(data=-1, seq=2))
    fn = jax_ring if plan["sp_mode"] == "ring" else jax_ulysses
    q, k, v, w = (jnp.asarray(inputs[f"attn_{n}"]) for n in "qkvw")

    def loss(q, k, v):
        o = fn(q, k, v, mesh, causal=plan["causal"])
        return jnp.sum(o * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    want = [o] + list(grads)
    for n, ref in zip(("o", "dq", "dk", "dv"), want):
        got = results[f"{plan['name']}.{n}"]
        assert LJ.scaled(got, np.asarray(ref)) <= ATTN_TOL, (plan["name"], n)


@pytest.mark.parametrize("plan", LM_CASES, ids=[p["name"] for p in LM_CASES])
def test_sequence_parallel_step_matches_jax(setup, plan):
    results, refs, _ = setup
    LJ.check(results, plan["name"], refs[plan["vocab"]])


class _Ranks:
    def __init__(self, r):
        self.r = r

    def get_local_rank(self, axis):
        return self.r

    def get_group(self, axis):
        raise AssertionError("no collective here")


def _seq_mesh(rank=1, seq=2):
    return tmesh.Mesh(_Ranks(rank), dict(zip(tmesh.AXES, (1, 1, seq, 1, 1))),
                      torch.device("cpu"), "gloo")


def test_position_encode_takes_global_positions():
    """Rank 1 of a sequence split in two encodes positions T/2..T-1."""
    x = np.random.RandomState(0).randn(2, 16, 8).astype(np.float32)
    want, _ = JaxPositionEncode().apply({}, {}, jnp.asarray(x))
    with kernel_mesh_scope(_seq_mesh(1), seq_dim=1):
        got = tnn.PositionEncode()(torch.from_numpy(x[:, 8:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 8:],
                               rtol=1e-6, atol=1e-6)


def test_seq_mesh_refusals_as_jax():
    """JAX's refusals: self-attention only, no explicit mask, no cached
    decode, a known mode; and a sequence-split batch needs seq_mesh."""
    mesh = _seq_mesh()
    with pytest.raises(ValueError, match="unknown seq_mode"):
        tnn.MultiHeadAttention(16, 4, seq_mesh=mesh, seq_mode="tree")
    mha = tnn.MultiHeadAttention(16, 4, seq_mesh=mesh)
    x = torch.randn(2, 8, 16)
    with pytest.raises(ValueError, match="self-attention only"):
        mha((x, x.clone()))
    with pytest.raises(ValueError, match="explicit mask"):
        mha((x, x, torch.ones(2, 1, 8, 8, dtype=torch.bool)))
    for call in (lambda: mha.init_cache(2, 8),
                 lambda: mha.init_paged_cache(5, 4, 2)):
        with pytest.raises(ValueError, match="does not compose with "
                                             "seq_mesh"):
            call()
    with kernel_mesh_scope(mesh, seq_dim=1), \
            pytest.raises(ValueError, match="needs seq_mesh attention"):
        tnn.MultiHeadAttention(16, 4)(x)


def test_driver_sp_under_torchrun(tmp_path):
    """``--sp 2`` under ``torchrun --nproc_per_node 2`` lands in JAX's
    band around the one-rank run; the driver's refusals are JAX's."""
    from bigdl_tpu_torch.models import transformer_train

    for argv, match in ((["--sp", "2", "--pp", "2"], "composes with"),
                        (["--sp", "3", "--seqLen", "16"], "must divide")):
        with pytest.raises(SystemExit, match=match):
            transformer_train.main(argv + ["--device", "cpu"])
    runs = LJ.driver_runs(tmp_path, {"sp": ["--sp", "2"]})
    dp, sp = runs["dp"][0], runs["sp"][0]
    assert np.isfinite(sp)
    assert abs(sp - dp) < 0.3 * dp
