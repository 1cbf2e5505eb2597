"""The port's data-parallel engine against the JAX package's, on the CPU.

The port runs 2 and 4 gloo ranks (``tests/torch_dist_worker.py``, one
spawned world per size, every case in it); the JAX package runs the
same steps on ``data_parallel_mesh(2)`` and ``(4)`` of conftest's 8
virtual CPU devices, from the same numpy weights (every BatchNorm leaf
randomised) and batch.  The model holds an unfused conv + BatchNorm, a
``FusedBottleneck`` and a strided ``FusedBasicBlock``, so the kernels'
statistics (their plain versions here) and the unfused layer's means
are both reduced over the data axis.

Tolerances (f32):
- parameters, running statistics and optimizer state after two steps,
  SGD with momentum and LARS, with and without ZeRO-1: rtol 1e-4, atol
  1e-5 against JAX's dp step (JAX's own dp-vs-single-device test,
  tests/test_parallel.py:51-93, holds rtol 1e-4 / atol 1e-6) and 1e-5
  against the port's single-device step on the global batch;
- the dp gradients: relative L2 per leaf 2e-4 against JAX's dp
  gradients and the single-device global batch's (the parity
  discipline's per-block tolerance); per-replica statistics move some
  leaf by more than 1e-2, so the check sees sync-BN;
- the compressed step at the bf16 and fp8 wires: 1e-6 absolute on the
  parameters and running statistics against JAX's compressed step (the
  wire sums round alike: 7.5e-8 and 4.7e-10 at most, measured), whose
  BatchNorm is per replica (ROADMAP's reference quirks): its parameters
  are over 100 times further than that from JAX's own sync-BN dp step;
- sharded checkpoints across world sizes: 1e-6 against the
  uninterrupted world-1 run; stop/resume at one world: bit for bit.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.distributed.checkpoint import \
    restore_checkpoint as jax_restore
from bigdl_tpu.distributed.compression import \
    build_compressed_dp_train_step as jax_compressed
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JaxDistri
from bigdl_tpu.parallel.data_parallel import \
    build_dp_train_step as jax_dp_step
from bigdl_tpu.parallel.mesh import data_parallel_mesh as jax_mesh
from bigdl_tpu.parallel.mesh import put_batch as jax_put
from bigdl_tpu.parallel.mesh import shard_leading_dim as jax_shard
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.distributed.checkpoint import (latest_committed,
                                                    restore_checkpoint)
from bigdl_tpu_torch.optim import SGD, make_train_step
from bigdl_tpu_torch.parallel import mesh as tmesh
from bigdl_tpu_torch.utils import (export_variables, flatten,
                                   load_jax_variables, random_variables)
from bigdl_tpu_torch.utils.serialization import load_pytree, save_pytree

import torch_dist_worker as W

WORLDS = (2, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_model():
    return jnn.Sequential(
        jnn.SpatialConvolution(3, 8, 3, padding="SAME", with_bias=False),
        jnn.SpatialBatchNormalization(8), jnn.ReLU(),
        jnn.FusedBottleneck(8, 4, 1), jnn.FusedBasicBlock(16, 16, 2),
        jnn.GlobalAveragePooling2D(), jnn.Linear(16, 3))


def _jax_method(name):
    if name == "lars":
        return joptim.LarsSGD(0.1, momentum=0.9, weight_decay=1e-4)
    return joptim.SGD(0.1, momentum=0.9)


def _np(tree):
    return flatten(jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree))


def _sub(results, prefix):
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in results.items()
            if k.startswith(pre)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, a world-1 sharded commit, the uninterrupted world-1
    MLP run, and each world's results."""
    import torch.distributed as dist

    template = jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0)))
    variables = random_variables(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), template), SEED)
    rs = np.random.RandomState(SEED)
    x = rs.randn(8, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 3, 8).astype(np.int64)
    base = tmp_path_factory.mktemp("dp")
    ck1 = str(base / "ck1")
    try:
        # world 1 in this process (an in-process store)
        straight = W.mlp_run(10)
        W.mlp_run(6, ck1)
        assert latest_committed(ck1)[0] == 6
        for w in WORLDS:
            tmp = base / f"world{w}"
            tmp.mkdir()
            save_pytree(str(tmp / "inputs"),
                        {"variables": variables, "x": x, "y": y})
            shutil.copytree(ck1, str(tmp / "ck1"))
        W.run_worlds(WORLDS, lambda w: base / f"world{w}", W.dp_world)
        worlds = {w: (str(base / f"world{w}"),
                      load_pytree(str(base / f"world{w}" / "results")))
                  for w in WORLDS}
        # each world's commit of iteration 6, resumed at world 1
        from_world = {}
        for w, (tmp, _) in worlds.items():
            root = str(base / f"resume{w}")
            shutil.copytree(f"{tmp}/ckw", root)
            from_world[w] = W.mlp_run(10, root, resume=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"variables": variables, "x": x, "y": y, "worlds": worlds,
            "straight": straight, "from_world": from_world}


_JAX = {}


def _jax_dp(setup, w, name, zero1):
    """JAX's dp step, two steps, on data_parallel_mesh(w)."""
    key = (w, name, zero1)
    if key not in _JAX:
        jm = _jax_model()
        m = _jax_method(name)
        mesh = jax_mesh(w)
        step, pl = jax_dp_step(jm, jnn.ClassNLLCriterion(logits=True),
                               {"__all__": m}, mesh, zero1=zero1)
        v = setup["variables"]
        p = jax.device_put(jax.tree_util.tree_map(jnp.asarray, v["params"]),
                           pl["params"])
        s = jax.device_put(jax.tree_util.tree_map(jnp.asarray, v["state"]),
                           pl["model_state"])
        o = jax.device_put({"__all__": m.init_state(p)}, pl["opt_states"])
        losses = []
        for i in range(2):
            p, s, o, loss = step(
                p, s, o, jnp.asarray(i + 1, jnp.int32),
                jax.random.PRNGKey(i), jax_put(mesh, setup["x"]),
                jax_put(mesh, setup["y"]), [jnp.asarray(0.1, jnp.float32)])
            losses.append(float(loss))
        _JAX[key] = {"params": _np(p), "state": _np(s),
                     "opt": _np(o["__all__"]), "losses": losses}
    return _JAX[key]


CASES = [(w, name, zero1) for w in WORLDS
         for name, zero1 in (("sgd", False), ("sgd", True), ("lars", True))]


@pytest.mark.parametrize("w,name,zero1", CASES)
def test_dp_step_matches_jax(setup, w, name, zero1):
    got = setup["worlds"][w][1]
    tag = f"dp_{name}_{'zero1' if zero1 else 'replicated'}"
    want = _jax_dp(setup, w, name, zero1)
    for kind in ("params", "state", "opt"):
        g = _sub(got, f"{tag}.{kind}")
        assert set(g) == set(want[kind]), kind
        for k in g:
            np.testing.assert_allclose(g[k], want[kind][k], **STEP_TOL,
                                       err_msg=f"{kind} {k}")
    np.testing.assert_allclose(got[f"{tag}.losses"], want["losses"],
                               rtol=1e-5)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", ["sgd", "lars"])
def test_dp_step_matches_one_device_on_the_global_batch(setup, w, name):
    """ZeRO-1 on and off against the port's own single-device step on the
    global batch (LARS's trust ratio from whole leaves)."""
    model = W.build_model()
    load_jax_variables(model, setup["variables"])
    m = W.method(name)
    step = make_train_step(model, tnn.ClassNLLCriterion(logits=True),
                           {"__all__": m})
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    opt = {"__all__": m.init_state(params)}
    x, y = torch.from_numpy(setup["x"]), torch.from_numpy(setup["y"])
    for i in range(2):
        params, state, opt, _ = step(params, state, opt, i + 1, None, x, y,
                                     [0.1])
    want = export_variables(model, params, state)
    for zero1 in ("zero1", "replicated"):
        got = _sub(setup["worlds"][w][1], f"dp_{name}_{zero1}.params")
        for k, v in flatten(want["params"]).items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{zero1} {k}")


@pytest.mark.parametrize("w", WORLDS)
def test_sync_bn_gradients_match_jax_and_the_global_batch(setup, w):
    jm = _jax_model()
    v = setup["variables"]
    crit = jnn.ClassNLLCriterion(logits=True)

    def loss_fn(params, x, y):
        out, _ = jm.apply(params, v["state"], x, training=True)
        return crit.forward(out, y)

    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    single = _np(jax.jit(jax.grad(loss_fn))(params, jnp.asarray(setup["x"]),
                                             jnp.asarray(setup["y"])))
    mesh = jax_mesh(w)
    from bigdl_tpu.ops.pallas.partition import kernel_mesh_scope

    def scoped(params, x, y):
        with kernel_mesh_scope(mesh):
            return jax.grad(loss_fn)(params, x, y)

    dp = _np(jax.jit(scoped)(params, jax_put(mesh, setup["x"]),
                             jax_put(mesh, setup["y"])))
    got = setup["worlds"][w][1]
    sync = _sub(got, "grads.sync")
    replica = _sub(got, "grads.replica")
    assert set(sync) == set(dp) == set(single)
    worst_replica = 0.0
    for k in sync:
        assert _rel(sync[k], dp[k]) < 2e-4, k
        assert _rel(sync[k], single[k]) < 2e-4, k
        worst_replica = max(worst_replica, _rel(replica[k], single[k]))
    # per-replica statistics would be a different gradient
    assert worst_replica > 1e-2, worst_replica


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("wire", ["bf16", "fp8"])
def test_compressed_step_matches_jax_with_per_replica_bn(setup, w, wire):
    tol = 1e-6
    jm = _jax_model()
    m = joptim.SGD(0.1, momentum=0.9)
    mesh = jax_mesh(w)
    step, pl = jax_compressed(jm, jnn.ClassNLLCriterion(logits=True),
                              {"__all__": m}, mesh, wire_dtype=wire)
    v = setup["variables"]
    p = jax.tree_util.tree_map(jnp.asarray, v["params"])
    s = jax.tree_util.tree_map(jnp.asarray, v["state"])
    o = {"__all__": m.init_state(p)}
    for i in range(2):
        p, s, o, loss = step(p, s, o, jnp.asarray(i + 1, jnp.int32),
                             jax.random.PRNGKey(i),
                             jax.device_put(setup["x"], pl["batch"]),
                             jax.device_put(setup["y"], pl["target"]),
                             [jnp.asarray(0.1, jnp.float32)])
    got = setup["worlds"][w][1]
    assert str(got[f"wire_{wire}.name"]) == pl["wire_dtype"]
    want, sync_bn = _np(p), _jax_dp(setup, w, "sgd", False)["params"]
    gp = _sub(got, f"wire_{wire}.params")
    far = 0.0
    for k in want:
        np.testing.assert_allclose(gp[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
        far = max(far, float(np.abs(want[k] - sync_bn[k]).max()))
    # JAX's compressed step normalises per replica: sync-BN moves it
    assert far > 100 * tol, far
    # and its numerics stats come out of the compressed step too
    assert int(got["wire_numerics.leaves"]) > 0
    assert bool(got["wire_numerics.finite"])
    gs = _sub(got, f"wire_{wire}.state")
    for k, a in _np(s).items():
        np.testing.assert_allclose(gs[k], a, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("w", WORLDS)
def test_optimizer_apply_dispatches_as_jax(setup, w, monkeypatch):
    """``Optimizer.apply`` picks DistriOptimizer where JAX's does with as
    many devices as the port has ranks (optimizer.py:211-237)."""
    monkeypatch.setattr(jax, "devices",
                        lambda *a, _d=jax.devices()[:w]: list(_d))
    feats = np.zeros((64, 8), np.float32)
    labels = np.zeros((64,), np.int64)
    model = jnn.Sequential(jnn.Linear(8, 2))
    cases = {"even": dict(dataset=JaxDataSet.from_arrays(feats, labels,
                                                         4 * w)),
             "uneven": dict(dataset=JaxDataSet.from_arrays(feats, labels,
                                                           4 * w + 1)),
             "mesh": dict(dataset=JaxDataSet.from_arrays(feats, labels,
                                                         4 * w + 1),
                          mesh=jax_mesh(w)),
             "wrapped": dict(dataset=JaxDataSet.sharded(feats, labels,
                                                        4 * w, 0, w))}
    got = setup["worlds"][w][1]
    for name, kw in cases.items():
        want = type(joptim.Optimizer.apply(
            model, kw.pop("dataset"), jnn.ClassNLLCriterion(logits=True),
            **kw)).__name__
        want = "DistriOptimizer" if want == JaxDistri.__name__ else want
        assert str(got[f"dispatch.{name}"]) == want, name


def test_optimizer_apply_is_local_on_one_rank():
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer, Optimizer

    feats, labels = W.mlp_data()
    opt = Optimizer.apply(W.build_mlp(), DataSet.from_arrays(feats, labels,
                                                             16),
                          tnn.ClassNLLCriterion(logits=True), device="cpu")
    assert type(opt) is LocalOptimizer


@pytest.mark.parametrize("w", WORLDS)
def test_allreduce_gauge_and_sharded_validation(setup, w):
    got = setup["worlds"][w][1]
    assert str(got["gauge.sync.class"]) == "DistriOptimizer"
    assert bool(got["gauge.sync.calibrated"])
    assert bool(got["gauge.sync.in_summary"])
    assert not bool(got["gauge.async.calibrated"])
    assert not bool(got["gauge.async.in_summary"])
    # the sharded validation (rows per rank, outputs gathered) scores as
    # one process over the whole set
    for loop in ("sync", "async"):
        score, local = got[f"validation.{loop}"]
        assert score == local, (loop, score, local)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_checkpoints_cross_world_sizes(setup, w):
    """A world-1 commit resumed at world w, and a world-w commit resumed
    at world 1, both end where the uninterrupted world-1 run does."""
    straight = setup["straight"]
    resumed = _sub(setup["worlds"][w][1], "ckpt.resumed")
    for k, v in straight.items():
        np.testing.assert_allclose(resumed[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(setup["from_world"][w][k], v, rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("w", WORLDS)
def test_each_rank_writes_its_own_shards_and_jax_reads_them(setup, w):
    import json

    tmp = setup["worlds"][w][0]
    it, path = latest_committed(f"{tmp}/ckw")
    assert it == 6
    frags = sorted(f for f in os.listdir(path) if f.startswith("fragment"))
    assert len(frags) == w
    for f in frags[1:]:  # the replicated leaves are rank 0's alone
        keys = json.load(open(os.path.join(path, f)))["chunks"]
        assert keys and all(k.startswith("/opt_states/") for k in keys)
    mine, host_state, _ = restore_checkpoint(path)
    theirs, jax_host, _ = jax_restore(path)
    assert host_state == jax_host
    assert host_state["driver_state"]["neval"] == 6
    a, b = flatten(mine), flatten(theirs)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("w", WORLDS)
def test_reshard_step_and_accumulation_layout(setup, w):
    got = setup["worlds"][w][1]
    np.testing.assert_array_equal(
        got["reshard.gathered"],
        np.arange(8 * w * 3, dtype=np.float32).reshape(8 * w, 3))
    assert bool(got["reshard.cut_ok"])
    # rank 0's rows of each of the 2 micro-batches of the global batch
    x = np.arange(4 * w * 2)
    micro = len(x) // 2
    want = np.concatenate([x[i * micro:i * micro + micro // w]
                           for i in range(2)])
    np.testing.assert_array_equal(got["put_batch.accum2"], want)


def test_zero1_layout_matches_jax():
    """``shard_leading_dim``: a leaf splits where JAX's does."""
    mesh8 = jax_mesh(8)
    tree = {"w": jnp.zeros((16, 3)), "b": jnp.zeros((5,)),
            "s": jnp.zeros(()), "e": jnp.zeros((0, 2))}
    want = {k: bool(s.spec) for k, s in jax_shard(mesh8, tree).items()}
    fake = tmesh.Mesh(_FakeDeviceMesh(), dict(zip(tmesh.AXES,
                                                  (8, 1, 1, 1, 1))),
                      torch.device("cpu"), "gloo")
    got = tmesh.shard_leading_dim(fake, {k: np.zeros(v.shape)
                                         for k, v in tree.items()})
    assert {k: isinstance(v, tmesh.RowShard) for k, v in got.items()} \
        == want
    assert got["w"].rows(16) == (6, 8)


class _FakeDeviceMesh:
    """Rank 3 of a data axis of 8, without a process group."""

    def get_local_rank(self, axis):
        return 3

    def get_group(self, axis):
        raise AssertionError("no collective here")


@pytest.mark.parametrize("cfg,n", [((-1, 2, 1, 1, 1), 8), ((4, 1, 2, 1, 1), 8),
                                   ((-1, 1, 1, 1, 1), 3)])
def test_mesh_config_resolves_as_jax(cfg, n):
    from bigdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    assert tmesh.MeshConfig(*cfg).resolve(n) == \
        JaxMeshConfig(*cfg).resolve(n)


def test_slice_20_names_raise():
    """Every name of ``bigdl_tpu.parallel`` imports from the port (they
    raised ``NotImplementedError`` until tensor, sequence, pipeline and
    expert parallelism were ported: tests/test_torch_tensor_parallel.py,
    test_torch_sequence_parallel.py, test_torch_expert.py,
    test_torch_pipeline.py); what the JAX package refuses, the port
    refuses alike."""
    import torch.distributed as dist

    import bigdl_tpu.parallel as jpar
    import bigdl_tpu_torch.parallel as par
    from bigdl_tpu_torch.models import transformer_train

    for name in jpar.__all__:
        assert getattr(par, name) is not None, name
    assert set(jpar.__all__) <= set(par.__all__)
    fake = tmesh.Mesh(_FakeDeviceMesh(), dict(zip(tmesh.AXES,
                                                  (2, 2, 1, 1, 1))),
                      torch.device("cpu"), "gloo")
    from bigdl_tpu_torch.distributed.compression import \
        build_compressed_dp_train_step
    from bigdl_tpu_torch.parallel.data_parallel import DataParallel

    with pytest.raises(ValueError, match="data-parallel"):
        build_compressed_dp_train_step(
            W.build_mlp(), tnn.ClassNLLCriterion(logits=True),
            {"__all__": SGD(0.1)}, fake, wire_dtype="bf16")
    assert DataParallel(fake).n == 2  # the data axis's ranks average
    try:  # one rank cannot hold a tensor-parallel degree of 2
        with pytest.raises(ValueError, match="not divisible"):
            transformer_train.main(["--tp", "2", "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_backend_rule():
    cpu = torch.device("cpu")
    assert tmesh.choose_backend(cpu, 1) == "gloo"
    assert tmesh.choose_backend(cpu, 4) == "gloo"


def _losses(text):
    """``{iteration: loss}`` from the loop's log lines."""
    return {int(i): float(v) for i, v in re.findall(
        r"\[Iteration (\d+)\].*?Loss is (-?\d+\.\d+)", text)}


def test_resnet_train_under_torchrun_matches_world_one(tmp_path):
    """``torchrun --nproc_per_node 2 -m bigdl_tpu_torch.models.resnet_train``
    on gloo: Optimizer.apply picks DistriOptimizer with no new flag, and
    the two steps' losses are the world-1 run's on the same global
    batches (the log line's 4 decimals)."""
    argv = ["-m", "bigdl_tpu_torch.models.resnet_train", "--device", "cpu",
            "--fused", "--dataset", "cifar10", "--depth", "8", "-b", "8",
            "--syntheticSize", "16", "--maxEpoch", "1", "--classNum", "4"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    cmds = {"one": [sys.executable] + argv,
            "two": [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc_per_node", "2"] + argv}
    runs = {}
    for d, cmd in cmds.items():  # both at once, each in its own directory
        (tmp_path / d).mkdir()
        with open(tmp_path / d / "stderr.txt", "w") as err:
            runs[d] = subprocess.Popen(cmd, env=env, cwd=str(tmp_path / d),
                                       stdout=subprocess.DEVNULL,
                                       stderr=err)
    try:
        for r in runs.values():
            r.wait(timeout=240)
    finally:
        for r in runs.values():
            if r.poll() is None:
                r.kill()
                r.wait()
    one, two = (subprocess.CompletedProcess(
        cmds[d], runs[d].returncode, "",
        (tmp_path / d / "stderr.txt").read_text()) for d in cmds)
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.returncode == 0, two.stderr[-3000:]
    assert "process group" not in one.stderr
    assert "process group: gloo, rank 1 of 2" in two.stderr
    want, got = _losses(one.stderr), _losses(two.stderr)
    assert sorted(want) == [1, 2] and sorted(got) == [1, 2], (want, got)
    for i in want:
        assert abs(got[i] - want[i]) <= 2e-4 * abs(want[i]) + 1e-4, (got,
                                                                     want)
