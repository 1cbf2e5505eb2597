"""Checkpoints, retry-from-checkpoint and resume in the port's
LocalOptimizer (bigdl_tpu_torch/optim/optimizer.py) against the JAX
package's synchronous loop (bigdl_tpu/optim/optimizer.py:476-581,
630-676, 989-1050, ``BIGDL_TPU_SYNC_LOOP=1``), on the CPU in f32.

- A run stopped at a checkpoint and resumed in a new LocalOptimizer on a
  new dataset ends with trees (parameters, BatchNorm statistics,
  velocity or Adam moments) bit-equal to the uninterrupted run's: the
  small conv net of tests/test_torch_train_loop.py with SGD and momentum,
  and a 1-layer Transformer LM with dropout 0.1 and Adam (the loop's
  seeds and Adam's step count come back).  The resume crosses an epoch
  boundary, so the dataset's cursor is rewound.
- The format is the JAX package's: a checkpoint the JAX Optimizer wrote
  resumes in the port with trees equal to the blob, and the two runs
  go on to agree within 1e-5; a port checkpoint reads back through the
  JAX package's ``load_pytree`` with its names and shapes and resumes
  there.
- A non-finite loss restores the latest checkpoint (every tree, the
  optimizer state included) and the run goes on; with no checkpoint, or
  once ``max_retry`` is used up, the error is raised again.
- ``_latest_ckpt`` ignores a leftover ``model.npz.tmp``; without
  overwrite each run writes into a timestamped directory; ``request_stop``
  writes the iteration it stopped at; ``restore_cursor`` gives the JAX
  dataset's batches; the LM driver's ``--checkpoint``/``--overwrite``/
  ``--resume``.
"""
import os

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.optim import SGD as JaxSGD, Trigger as JaxTrigger
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.utils.serialization import load_pytree as jax_load_pytree
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import transformer_train
from bigdl_tpu_torch.optim import SGD, Adam, Optimizer, Trigger
from bigdl_tpu_torch.utils import flatten, load_pytree, random_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _conv(nn):
    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, padding="SAME"),
        nn.SpatialBatchNormalization(8), nn.ReLU(),
        nn.GlobalAveragePooling2D(), nn.Linear(8, 5))


def _conv_data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(12, 8, 8, 3).astype(np.float32),
            rs.randint(0, 5, 12))


def _conv_variables():
    return random_variables(jax.tree_util.tree_map(
        np.asarray, _conv(jnn).init(jax.random.PRNGKey(0))), 4)


def _setup(kind):
    """(model, dataset, criterion, method, initial variables) of a fresh
    run: a new model with the run's weights and a new dataset, as a new
    process has them."""
    if kind == "conv_sgd":
        x, y = _conv_data()
        return (_conv(tnn), DataSet.from_arrays(x, y, batch_size=4),
                tnn.ClassNLLCriterion(logits=True),
                SGD(0.1, momentum=0.9), _conv_variables())
    # a 1-layer LM, dropout 0.1, Adam: the seeds and the step count
    rs = np.random.RandomState(0)
    x, y = rs.randint(0, 20, (12, 6)), rs.randint(0, 20, (12, 6))
    model = tnn.Transformer(20, 16, 2, 32, 1, dropout=0.1)
    model.initialize(torch.Generator().manual_seed(3))
    return (model, DataSet.from_arrays(x, y, batch_size=4, seed=2),
            tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(logits=True)),
            Adam(1e-2), None)


def _run(kind, end, ckpt=None, trigger=None, resume=None):
    model, ds, crit, method, v = _setup(kind)
    opt = (Optimizer.apply(model, ds, crit, end_trigger=Trigger.max_iteration(
        end), device="cpu").set_optim_method(method))
    if v is not None:
        opt.set_initial_variables(v)
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), trigger or Trigger.several_iteration(1))
    if resume is not None:
        opt.resume_from(str(resume))
    opt.optimize()
    return opt


def _leaves(tree):
    return {k: np.asarray(v) for k, v in flatten(tree).items()}


def _bit_equal(a, b):
    a, b = _leaves(a), _leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["conv_sgd", "lm_adam_dropout"])
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, kind):
    full = _run(kind, 7, tmp_path / "full")
    # stopped at iteration 4 (epoch 1, one batch into it), resumed to 7
    _run(kind, 4, tmp_path / "part")
    part = load_pytree(str(tmp_path / "part" / "model"))
    assert part["driver_state"]["neval"] == 4
    assert part["driver_state"]["epoch"] == 1
    assert part["driver_state"]["batch_in_epoch"] == 1
    assert "epoch_finished" not in part["driver_state"]
    resumed = _run(kind, 7, tmp_path / "resumed",
                   resume=tmp_path / "part" / "model")
    assert resumed._loop_state["neval"] == full._loop_state["neval"] == 7
    assert resumed._loop_state["loss"] == full._loop_state["loss"]
    want = load_pytree(str(tmp_path / "full" / "model"))
    got = load_pytree(str(tmp_path / "resumed" / "model"))
    for key in ("params", "model_state", "opt_states"):
        _bit_equal(got[key], want[key])
    for k, t in resumed.final_params.items():
        np.testing.assert_array_equal(t.numpy(), full.final_params[k].numpy())


def test_checkpoints_cross_between_the_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP", "1")
    x, y = _conv_data()
    v = _conv_variables()

    def jax_run(end, ckpt=None, resume=None):
        opt = (JaxLocalOptimizer(_conv(jnn),
                                 JaxDataSet.from_arrays(x, y, batch_size=4),
                                 jnn.ClassNLLCriterion(logits=True),
                                 JaxTrigger.max_iteration(end))
               .set_optim_method(JaxSGD(0.1, momentum=0.9))
               .set_initial_variables(v))
        if ckpt is not None:
            opt.set_checkpoint(str(ckpt), JaxTrigger.several_iteration(2))
        if resume is not None:
            opt.resume_from(str(resume))
        opt.optimize()
        return opt

    # JAX -> port: the restored trees are the blob's
    jax_run(4, tmp_path / "jax")
    blob = jax_load_pytree(str(tmp_path / "jax" / "model"))
    port = _run("conv_sgd", 4, resume=tmp_path / "jax" / "model")
    assert port._loop_state["neval"] == 4
    _bit_equal({k: t.numpy() for k, t in port.final_params.items()},
               blob["params"])
    _bit_equal({k: t.numpy() for k, t in port.final_state.items()},
               blob["model_state"])
    # ... with the velocity too: two more steps agree with JAX's
    jfull = jax_run(6)
    port = _run("conv_sgd", 6, tmp_path / "port",
                resume=tmp_path / "jax" / "model")
    for k, w in _leaves(jax.tree_util.tree_map(np.asarray,
                                               jfull.final_params)).items():
        np.testing.assert_allclose(port.final_params[k].numpy(), w,
                                   err_msg=k, **TOL)

    # port -> JAX: JAX's reader sees its own names and shapes
    pblob = jax_load_pytree(str(tmp_path / "port" / "model"))
    for key in ("params", "model_state", "opt_states", "driver_state"):
        want = blob[key]
        assert jax.tree_util.tree_structure(pblob[key]) == \
            jax.tree_util.tree_structure(want), key
        for a, b in zip(jax.tree_util.tree_leaves(pblob[key]),
                        jax.tree_util.tree_leaves(want)):
            assert np.shape(a) == np.shape(b), key
    # and JAX resumes from it (iteration 6) to agree at iteration 8
    jres = jax_run(8, resume=tmp_path / "port" / "model")
    port8 = _run("conv_sgd", 8)
    for k, w in _leaves(jax.tree_util.tree_map(np.asarray,
                                               jres.final_params)).items():
        np.testing.assert_allclose(port8.final_params[k].numpy(), w,
                                   err_msg=k, **TOL)


class _NanAt(tnn.ClassNLLCriterion):
    """ClassNLL whose loss is NaN at the given (1-based) calls: the step
    runs eagerly on the CPU, so each call is one iteration."""

    def __init__(self, calls):
        super().__init__(logits=True)
        self.calls, self.n = set(calls), 0

    def forward(self, out, target):
        self.n += 1
        loss = super().forward(out, target)
        return loss * float("nan") if self.n in self.calls else loss


def _nan_run(tmp_path, calls, ckpt=True, max_retry=5):
    x, y = _conv_data()
    opt = (Optimizer.apply(_conv(tnn), DataSet.from_arrays(x, y,
                                                           batch_size=4),
                           _NanAt(calls), end_trigger=Trigger.max_iteration(6),
                           device="cpu")
           .set_optim_method(SGD(0.1, momentum=0.9))
           .set_initial_variables(_conv_variables()))
    opt.max_retry = max_retry
    if ckpt:
        opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(2))
    return opt


def test_a_nan_step_retries_from_the_latest_checkpoint(tmp_path, caplog):
    opt = _nan_run(tmp_path, [4])  # the step after the iteration-2 write
    with caplog.at_level("WARNING", logger="bigdl_tpu_torch.optim"):
        opt.optimize()
    assert opt._retries == 1
    assert any("retry 1 from checkpoint at iteration 2" in r.getMessage()
               for r in caplog.records)
    assert opt._loop_state["neval"] == 6
    assert np.isfinite(opt._loop_state["loss"])
    # every tree was overwritten: nothing of the NaN step is left
    blob = load_pytree(str(tmp_path / "model"))
    for tree in ("params", "model_state", "opt_states"):
        assert all(np.isfinite(a).all() for a in _leaves(blob[tree]).values())


def test_a_nan_step_raises_without_a_checkpoint_or_retries(tmp_path):
    with pytest.raises(FloatingPointError):
        _nan_run(tmp_path / "none", [4], ckpt=False).optimize()
    with pytest.raises(FloatingPointError):  # before the first checkpoint
        _nan_run(tmp_path / "early", [1]).optimize()
    # two failures in the window, one retry allowed
    with pytest.raises(FloatingPointError):
        _nan_run(tmp_path / "used_up", [4, 5], max_retry=1).optimize()


def test_latest_ckpt_and_timestamped_directories(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    from bigdl_tpu_torch.optim import LocalOptimizer
    assert LocalOptimizer._latest_ckpt(str(d)) is None
    for name in ("model.2.npz", "model.10.npz", "model.npz.tmp",
                 "model.11.npz.tmp", "other.npz"):
        (d / name).write_bytes(b"")
    assert LocalOptimizer._latest_ckpt(str(d)) == str(d / "model.10")
    (d / "model.npz").write_bytes(b"")
    assert LocalOptimizer._latest_ckpt(str(d)) == str(d / "model")

    x, y = _conv_data()
    opt = (Optimizer.apply(_conv(tnn), DataSet.from_arrays(x, y,
                                                           batch_size=4),
                           tnn.ClassNLLCriterion(logits=True),
                           end_trigger=Trigger.max_iteration(4),
                           device="cpu")
           .set_checkpoint(str(tmp_path / "ts"), Trigger.several_iteration(2))
           .over_write_checkpoint(False))
    opt.optimize()
    (sub,) = os.listdir(tmp_path / "ts")
    assert len(sub) == len("20260101_000000") and sub[8] == "_"
    assert sorted(os.listdir(tmp_path / "ts" / sub)) == [
        "model.2.npz", "model.4.npz"]


def test_request_stop_writes_the_iteration_it_stopped_at(tmp_path):
    x, y = _conv_data()
    opt = Optimizer.apply(_conv(tnn), DataSet.from_arrays(x, y, batch_size=4),
                          tnn.ClassNLLCriterion(logits=True),
                          end_trigger=Trigger.max_iteration(10),
                          device="cpu")

    def stop_at_3(state):  # never fires: only the stop writes
        if state["neval"] == 3:
            opt.request_stop()
        return False

    opt.set_checkpoint(str(tmp_path), Trigger(stop_at_3))
    opt.optimize()
    assert opt._loop_state["neval"] == 3
    blob = load_pytree(str(tmp_path / "model"))
    assert blob["driver_state"]["neval"] == 3
    assert blob["driver_state"]["epoch"] == 1


def test_restore_cursor_gives_the_jax_batches():
    x, y = _conv_data(1)
    jd = JaxDataSet.from_arrays(x, y, batch_size=5, seed=3)
    td = DataSet.from_arrays(x, y, batch_size=5, seed=3)
    for epoch, batch in ((0, 1), (2, 1), (3, 0)):
        jd.restore_cursor(epoch, batch)
        td.restore_cursor(epoch, batch)
        assert td.state_dict() == jd.state_dict()
        ji, ti = jd.data(train=True), td.data(train=True)
        for _ in range(5):
            jb, tb = next(ji), next(ti)
            np.testing.assert_array_equal(tb.get_input(), jb.get_input())
            np.testing.assert_array_equal(tb.get_target(), jb.get_target())


LM_ARGS = ["-b", "4", "--seqLen", "8", "--vocabSize", "30",
           "--hiddenSize", "16", "--numHeads", "2", "--filterSize", "32",
           "--numLayers", "1", "--syntheticSize", "512", "--device", "cpu"]


def test_lm_driver_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "lm")
    full = transformer_train.main(LM_ARGS + ["--maxEpoch", "2"])
    transformer_train.main(LM_ARGS + ["--checkpoint", d, "--overwrite",
                                      "--maxEpoch", "1"])
    assert os.listdir(d) == ["model.npz"]
    resumed = transformer_train.main(LM_ARGS + ["--resume", f"{d}/model",
                                                "--maxEpoch", "2"])
    assert resumed == full
    # without --overwrite: a timestamped directory of model.<iter>.npz
    transformer_train.main(LM_ARGS + ["--checkpoint", str(tmp_path / "ts"),
                                      "--maxEpoch", "1"])
    (sub,) = os.listdir(tmp_path / "ts")
    (name,) = os.listdir(tmp_path / "ts" / sub)
    assert name.startswith("model.") and name.endswith(".npz")
