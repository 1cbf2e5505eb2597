"""The port's sharded checkpoints, data cursors and stop/resume against
the JAX package's, on the CPU (tests/test_elastic.py:52-266,
tests/test_checkpoint_io.py:120).

- the same files: a tree written by either package (f32 rows split over
  writers, a replicated bf16 leaf, scalars, numpy and meta leaves)
  restores in the other leaf for leaf; bf16 leaves come back as the
  port's bfloat16 tensors;
- each writer's fragment records only the chunks it wrote; a replicated
  leaf is written once;
- a restore reassembles any rows whatever wrote them (world 4 -> 2 and
  1, params and optimizer slots and the host state);
- the background writer and its pruning, the crash mid-commit;
- ``DistributedDataSet``'s cursor across a world resize and the local
  cursor's replay, each against JAX's batches bit for bit;
- a stop at iteration 6 and a resume in a fresh ``DistriOptimizer`` end
  bit-equal to the uninterrupted run (world 1, sharded checkpoints).
"""
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.dataset.dataset import DataSet as JaxDataSet
from bigdl_tpu.distributed import checkpoint as jck
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.distributed import checkpoint as tck
from bigdl_tpu_torch.parallel.mesh import Replicated, RowShard
from bigdl_tpu_torch.utils import flatten

import torch_dist_worker as W


def _mixed_port_tree(rank, world):
    """Rank ``rank``'s view of the mixed tree: ``w`` split on dim 0."""
    whole = np.arange(32, dtype=np.float32).reshape(8, 4)
    lo, hi = RowShard(rank, world).rows(8)
    return {
        "w": tck.ShardedLeaf(torch.from_numpy(whole[lo:hi]), (8, 4), lo),
        "b": torch.ones(4, dtype=torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
        "host": np.arange(3, dtype=np.int64),
        "meta": {"name": "m", "flag": True, "none": None, "lr": 0.1},
    }


def _write_world(root, world, it, host_state):
    """Every rank's write of the mixed tree, rank 0 (which commits) last."""
    for r in reversed(range(world)):
        tck.write_checkpoint(root, _mixed_port_tree(r, world), host_state,
                             it, process_index=r, process_count=world)


def test_port_written_tree_restores_in_both_packages(tmp_path):
    root = str(tmp_path / "ck")
    _write_world(root, 2, 11, {"driver_state": {"epoch": 2}})
    it, path = tck.latest_committed(root)
    assert it == 11 and jck.latest_committed(root) == (it, path)
    mine, host, manifest = tck.restore_checkpoint(path)
    theirs, jhost, _ = jck.restore_checkpoint(path)
    assert host == jhost == {"driver_state": {"epoch": 2}}
    assert manifest["iteration"] == 11 and manifest["world"] == 2
    np.testing.assert_array_equal(
        mine["w"], np.arange(32, dtype=np.float32).reshape(8, 4))
    np.testing.assert_array_equal(mine["w"], np.asarray(theirs["w"]))
    assert mine["b"].dtype == torch.bfloat16
    assert str(np.asarray(theirs["b"]).dtype) == "bfloat16"
    np.testing.assert_array_equal(mine["b"].float().numpy(),
                                  np.asarray(theirs["b"], np.float32))
    assert int(mine["step"]) == int(theirs["step"]) == 7
    np.testing.assert_array_equal(mine["host"], np.arange(3))
    assert mine["meta"] == theirs["meta"] == \
        {"name": "m", "flag": True, "none": None, "lr": 0.1}
    # each rank's fragment holds only what it wrote; replicated once
    f0 = json.load(open(os.path.join(path, "fragment-00000.json")))
    f1 = json.load(open(os.path.join(path, "fragment-00001.json")))
    assert set(f1["chunks"]) == {"/w"}
    assert f1["chunks"]["/w"][0]["bounds"] == [[4, 8], [0, 4]]
    assert set(f0["chunks"]) == {"/w", "/b", "/step", "/host", "/meta/lr"}
    assert len(f0["chunks"]["/b"]) == 1


def test_jax_written_tree_restores_in_the_port(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bigdl_tpu.parallel.mesh import data_parallel_mesh

    mesh = data_parallel_mesh(4)
    tree = {
        "w": jax.device_put(jnp.arange(32, dtype=jnp.float32).reshape(8, 4),
                            NamedSharding(mesh, P("data"))),
        "b": jax.device_put(jnp.ones((4,), jnp.bfloat16),
                            NamedSharding(mesh, P())),
        "step": jnp.asarray(7, jnp.int32),
        "meta": {"name": "m", "flag": False},
    }
    root = str(tmp_path / "ck")
    jck.write_checkpoint(root, tree, {"driver_state": {"neval": 5}}, 5)
    _, path = tck.latest_committed(root)
    # rows of a part, whatever the writers' layout (4 chunks here)
    for parts in (1, 2, 4):
        for r in range(parts):
            got, host, _ = tck.restore_checkpoint(
                path, {"w": RowShard(r, parts), "b": Replicated()})
            lo, hi = RowShard(r, parts).rows(8)
            np.testing.assert_array_equal(
                got["w"], np.asarray(tree["w"])[lo:hi])
            assert got["b"].dtype == torch.bfloat16
            assert got["b"].shape == (4,)
    assert host == {"driver_state": {"neval": 5}}
    assert int(got["step"]) == 7 and got["meta"] == tree["meta"]


def test_reshard_restore_params_and_optimizer_slots(tmp_path):
    """A world-4 write of params, SGD velocity and Adam moments restores
    at 2 and at 1 (rows reassembled), with the host state
    (tests/test_elastic.py:101-155)."""
    rs = np.random.RandomState(0)
    whole = {"params": rs.rand(8, 6).astype(np.float32),
             "velocity": rs.rand(8, 6).astype(np.float32),
             "m": rs.rand(8, 6).astype(np.float32),
             "v": rs.rand(8, 6).astype(np.float32),
             "bias": rs.rand(3).astype(np.float32)}
    root = str(tmp_path / "ck")
    host = {"driver_state": {"epoch": 3, "neval": 40},
            "optim_methods": {"__all__": {"neval": 40}}}
    for r in reversed(range(4)):
        lo, hi = RowShard(r, 4).rows(8)
        tree = {"params": {"w": tck.ShardedLeaf(
                    torch.from_numpy(whole["params"][lo:hi]), (8, 6), lo),
                    "b": torch.from_numpy(whole["bias"])},
                "opt_states": {
                    "sgd": {"velocity": tck.ShardedLeaf(
                        torch.from_numpy(whole["velocity"][lo:hi]), (8, 6),
                        lo)},
                    "adam": {k: tck.ShardedLeaf(
                        torch.from_numpy(whole[k][lo:hi]), (8, 6), lo)
                        for k in ("m", "v")}}}
        tck.write_checkpoint(root, tree, host, 40, process_index=r,
                             process_count=4)
    _, path = tck.latest_committed(root)
    for parts in (2, 1):
        for r in range(parts):
            got, got_host, _ = tck.restore_checkpoint(
                path, {"params": {"w": RowShard(r, parts)},
                       "opt_states": RowShard(r, parts)})
            lo, hi = RowShard(r, parts).rows(8)
            np.testing.assert_array_equal(got["params"]["w"],
                                          whole["params"][lo:hi])
            np.testing.assert_array_equal(got["params"]["b"], whole["bias"])
            np.testing.assert_array_equal(
                got["opt_states"]["sgd"]["velocity"],
                whole["velocity"][lo:hi])
            for k in ("m", "v"):
                np.testing.assert_array_equal(got["opt_states"]["adam"][k],
                                              whole[k][lo:hi])
            assert got_host == host
    theirs, _, _ = jck.restore_checkpoint(path)
    for k, v in flatten(got).items():
        np.testing.assert_array_equal(v, np.asarray(flatten(theirs)[k]))


def test_checkpointer_background_writer_and_prune(tmp_path):
    root = str(tmp_path / "ck")
    ck = tck.ShardedCheckpointer(root, process_index=0, process_count=1,
                                 keep=2)
    try:
        for it in (3, 6, 9, 12):
            ck.save({"w": torch.full((4,), float(it))}, {"it": it}, it)
        ck.wait()
    finally:
        ck.finish()
    assert ck.last_committed == 12
    kept = sorted(d for d in os.listdir(root) if d.startswith("ckpt-"))
    assert kept == ["ckpt-00000009", "ckpt-00000012"]
    it, tree, host = tck.ShardedCheckpointer(
        root, process_index=0, process_count=1).restore_latest()
    assert it == 12 and host == {"it": 12}
    np.testing.assert_array_equal(tree["w"], np.full(4, 12.0, np.float32))


def test_commit_protocol_survives_a_crash_mid_write(tmp_path):
    """A writer killed before COMMIT leaves a directory restore ignores
    (tests/test_checkpoint_io.py:120-152)."""
    root = str(tmp_path / "ck")
    tck.write_checkpoint(root, {"w": torch.arange(8, dtype=torch.float32)},
                         {"driver_state": {"neval": 3}}, 3,
                         process_index=0, process_count=1)
    tck.write_checkpoint(root, {"w": torch.ones(8) * 9}, {}, 6,
                         process_index=0, process_count=1)
    crashed = os.path.join(root, "ckpt-00000006")
    os.remove(os.path.join(crashed, "COMMIT"))
    it, path = tck.latest_committed(root)
    assert it == 3
    restored, host, _ = tck.restore_checkpoint(path)
    np.testing.assert_array_equal(restored["w"],
                                  np.arange(8, dtype=np.float32))
    assert host["driver_state"]["neval"] == 3
    with pytest.raises(ValueError, match="no COMMIT"):
        tck.restore_checkpoint(crashed)
    shutil.rmtree(crashed)
    os.makedirs(os.path.join(root, "ckpt-00000009.tmp"))
    assert tck.latest_committed(root)[0] == 3
    # a commit waits for every writer's fragment, then gives up
    with pytest.raises(TimeoutError, match="1/2 fragments"):
        tck.write_checkpoint(root, {"w": torch.ones(2)}, {}, 12,
                             process_index=0, process_count=2,
                             commit_timeout_s=0.2)
    assert tck.latest_committed(root)[0] == 3


def _stream(ds, n):
    it = ds.data(train=True)
    return [np.array(next(it).features) for _ in range(n)]


def test_local_cursor_replay_matches_jax():
    feats = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    ref = _stream(DataSet.from_arrays(feats, None, 4, seed=5), 13)
    jref = _stream(JaxDataSet.from_arrays(feats, None, 4, seed=5), 13)
    for a, b in zip(ref, jref):
        np.testing.assert_array_equal(a, b)
    for epoch, batch, start in ((1, 3, 8), (2, 0, 10)):
        ds = DataSet.from_arrays(feats, None, 4, seed=5)
        ds.restore_cursor(epoch, batch)
        for a, b in zip(ref[start:], _stream(ds, 13 - start)):
            np.testing.assert_array_equal(a, b)


def test_distributed_cursor_survives_a_world_resize():
    """After restore_cursor, 2 ranks' slices concatenated are the 4
    ranks' global batches, and JAX's DistributedDataSet's."""
    rs = np.random.RandomState(1)
    feats = rs.rand(32, 2).astype(np.float32)
    labels = np.arange(32, dtype=np.int64)

    def world(factory, nproc, epoch=1, batch=2):
        streams = []
        for pid in range(nproc):
            ds = factory(feats, labels, 8, process_id=pid,
                         num_processes=nproc, seed=2)
            ds.restore_cursor(epoch, batch)
            streams.append(_stream(ds, 6))
        return [np.concatenate([s[i] for s in streams]) for i in range(6)]

    four, two = world(DataSet.sharded, 4), world(DataSet.sharded, 2)
    jax_two = world(JaxDataSet.sharded, 2)
    for a, b, c in zip(four, two, jax_two):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="divisible"):
        DataSet.sharded(feats, labels, 6, 0, 4)


def test_stop_and_resume_bit_equal(tmp_path):
    """Stop at 6 (committed), resume in a fresh DistriOptimizer to 10:
    bit-equal to an uninterrupted 10-iteration run
    (tests/test_elastic.py:266-300)."""
    import torch.distributed as dist

    root = str(tmp_path / "ck")
    try:
        straight = W.mlp_run(10)
        W.mlp_run(6, root)
        assert tck.latest_committed(root)[0] == 6
        resumed = W.mlp_run(10, root, resume=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for k in straight:
        np.testing.assert_array_equal(straight[k], resumed[k])
    assert tck.latest_committed(root)[0] == 9


def test_compressed_steps_write_and_resume_sharded_checkpoints(tmp_path):
    """The bf16-wire DistriOptimizer (replicated optimizer state) writes
    and resumes sharded commits as the plain one does: bit for bit."""
    import torch.distributed as dist

    root = str(tmp_path / "ck")
    try:
        straight = W.mlp_run(8, grad_compression="bf16")
        W.mlp_run(6, root, grad_compression="bf16")
        resumed = W.mlp_run(8, root, resume=True, grad_compression="bf16")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for k in straight:
        np.testing.assert_array_equal(straight[k], resumed[k])
