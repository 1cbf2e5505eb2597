"""TensorBoard summaries of the port (bigdl_tpu_torch/visualization/
tensorboard.py and summary.py, the optimizer's summary hooks) against the
JAX package's, on the CPU.

- Event records are JAX's byte for byte (fixed wall time); each package
  reads the other's event files.
- The ``Parameters`` histogram: the port's ``subsample_tree`` over the
  flat ``named_parameters`` dict equals JAX's over the nested tree of the
  same weights (a depth-8 cifar ResNet and an unfused depth-18 imagenet
  ResNet), and so does the histogram record.
- The loop's scalars: the same run through the port's and JAX's
  ``LocalOptimizer`` (async and ``BIGDL_TPU_SYNC_LOOP=1``) writes the
  same tags at the same steps: ``Loss`` at iterations 1..N exactly once
  each (the async loop writes it when it reads it, against its own
  iteration), within 1e-5 of JAX's; ``LearningRate`` equal;
  ``Throughput``; the ``Parameters`` histogram at its trigger; each
  validation method's score at every epoch.
- The drivers: ``transformer_train --summary`` writes its scalars.
"""
import os

import numpy as np
import pytest

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.telemetry.numerics import subsample_tree as jax_subsample
from bigdl_tpu.visualization import summary as jsummary
from bigdl_tpu.visualization import tensorboard as jtb
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import ResNet, transformer_train
from bigdl_tpu_torch.utils import load_jax_variables, random_variables
from bigdl_tpu_torch.visualization import summary as tsummary
from bigdl_tpu_torch.visualization import tensorboard as ttb


@pytest.fixture(params=["async", "sync"])
def loop(request, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP",
                       "1" if request.param == "sync" else "0")
    return request.param


def test_event_records_equal_jax():
    values = np.random.RandomState(0).randn(500)
    for enc in ("encode_scalar_summary", "encode_histogram_summary"):
        arg = 0.125 if enc == "encode_scalar_summary" else values
        assert getattr(ttb, enc)("Loss", arg) == getattr(jtb, enc)("Loss", arg)
    s = ttb.encode_scalar_summary("LearningRate", 3.2)
    for kw in ({"summary": s, "step": 7, "wall_time": 1.5},
               {"file_version": "brain.Event:2", "wall_time": 2.0},
               {"summary": s, "step": 0, "wall_time": 3.0}):
        assert ttb.encode_event(**kw) == jtb.encode_event(**kw)
    assert ttb.encode_histogram_summary("h", []) == \
        jtb.encode_histogram_summary("h", [])


def test_event_files_read_by_either_package(tmp_path):
    writers = {"port": ttb.FileWriter(str(tmp_path / "port")),
               "jax": jtb.FileWriter(str(tmp_path / "jax"))}
    for w in writers.values():
        for step in range(1, 4):
            w.add_scalar("Loss", 1.0 / step, step)
        w.add_histogram("Parameters/subsample", np.arange(10.0), 3)
        w.close()
    for w in writers.values():
        got, want = ttb.read_events(w.path), jtb.read_events(w.path)
        strip = [{k: r[k] for k in ("tag", "step", "value")} for r in got]
        assert strip == [{k: r[k] for k in ("tag", "step", "value")}
                         for r in want]
        assert [(r["tag"], r["step"]) for r in got] == \
            [("Loss", 1), ("Loss", 2), ("Loss", 3),
             ("Parameters/subsample", 3)]
        assert got[1]["value"] == pytest.approx(0.5)
    # the framing is TFRecord's: both packages' readers take it
    from bigdl_tpu_torch.dataset.record_io import read_tfrecords
    assert len(list(read_tfrecords(writers["jax"].path))) == 5


def _models(kind):
    if kind == "cifar8":
        jm = JaxResNet(10, depth=8, dataset="cifar10")
        tm = ResNet(10, depth=8, dataset="cifar10", device="cpu")
    else:
        jm = JaxResNet(10, depth=18, dataset="imagenet")
        tm = ResNet(10, depth=18, dataset="imagenet", device="cpu")
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 5)
    load_jax_variables(tm, v)
    return v, tm


@pytest.mark.parametrize("kind", ["cifar8", "imagenet18"])
def test_parameters_histogram_equals_jax(tmp_path, kind):
    v, tm = _models(kind)
    params = {k: p.detach() for k, p in tm.named_parameters()}
    for budget in (tsummary.DEFAULT_HIST, 100, 10 ** 9):
        want = np.asarray(jax_subsample(v["params"], budget))
        got = tsummary.subsample_tree(params, budget)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # nested trees and numpy leaves take the same path
    np.testing.assert_array_equal(tsummary.subsample_tree(v["params"]),
                                  np.asarray(jax_subsample(v["params"])))
    assert ttb.encode_histogram_summary(
        "Parameters/subsample", tsummary.subsample_tree(params)) == \
        jtb.encode_histogram_summary(
            "Parameters/subsample", np.asarray(jax_subsample(v["params"])))
    tsum = tsummary.TrainSummary(str(tmp_path), "t")
    jsum = jsummary.TrainSummary(str(tmp_path), "j")
    for s, p in ((tsum, params), (jsum, v["params"])):
        s.set_summary_trigger("Parameters", 2)
        for step in (1, 2, 3, 4):
            s.maybe_add_parameters(p, step)
    rows = [[(r["tag"], r["step"]) for f in sorted(os.listdir(s.log_dir))
             for r in ttb.read_events(os.path.join(s.log_dir, f))]
            for s in (tsum, jsum)]
    assert rows[0] == rows[1] == [("Parameters/subsample", 2),
                                  ("Parameters/subsample", 4)]
    assert tsummary.subsample_tree({}).shape == (0,)


def _conv(nn):
    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, padding="SAME"),
        nn.SpatialBatchNormalization(8), nn.ReLU(),
        nn.GlobalAveragePooling2D(), nn.Linear(8, 5))


def _loop_run(pkg, log_dir, end=14):
    rs = np.random.RandomState(0)
    x, y = rs.randn(24, 8, 8, 3).astype(np.float32), rs.randint(0, 5, 24)
    xv, yv = rs.randn(8, 8, 8, 3).astype(np.float32), rs.randint(0, 5, 8)
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, _conv(jnn).init(jax.random.PRNGKey(0))), 4)
    if pkg == "port":
        opt = toptim.Optimizer.apply(
            _conv(tnn), DataSet.from_arrays(x, y, batch_size=4),
            tnn.ClassNLLCriterion(logits=True),
            end_trigger=toptim.Trigger.max_iteration(end), device="cpu")
        opt.set_optim_method(toptim.SGD(0.1, momentum=0.9,
                                        schedule=toptim.Step(4, 0.5)))
        opt.set_validation(toptim.Trigger.every_epoch(),
                           DataSet.from_arrays(xv, yv, batch_size=4),
                           [toptim.Top1Accuracy(),
                            toptim.Loss(tnn.ClassNLLCriterion(logits=True))])
        mod = tsummary
    else:
        opt = JaxLocalOptimizer(
            _conv(jnn), JaxDataSet.from_arrays(x, y, batch_size=4),
            jnn.ClassNLLCriterion(logits=True),
            joptim.Trigger.max_iteration(end))
        opt.set_optim_method(joptim.SGD(0.1, momentum=0.9,
                                        schedule=joptim.Step(4, 0.5)))
        opt.set_validation(joptim.Trigger.every_epoch(),
                           JaxDataSet.from_arrays(xv, yv, batch_size=4),
                           [joptim.Top1Accuracy(),
                            joptim.Loss(jnn.ClassNLLCriterion(logits=True))])
    opt.set_initial_variables(v)
    mod = tsummary if pkg == "port" else jsummary
    train = mod.TrainSummary(str(log_dir), pkg)
    train.set_summary_trigger("Parameters", 5)
    val = mod.ValidationSummary(str(log_dir), pkg)
    opt.set_train_summary(train).set_val_summary(val)
    opt.optimize()
    return train, val


def _tags(summary):
    rows = {}
    for f in sorted(os.listdir(summary.log_dir)):
        for r in ttb.read_events(os.path.join(summary.log_dir, f)):
            if r["tag"] is not None:
                rows.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return rows


def test_loop_scalars_equal_jax(tmp_path, loop):
    t_train, t_val = _loop_run("port", tmp_path)
    j_train, j_val = _loop_run("jax", tmp_path)
    got, want = _tags(t_train), _tags(j_train)
    assert set(got) == set(want) == {"Loss", "Throughput", "LearningRate",
                                     "Parameters/subsample"}
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
    steps = list(range(1, 15))
    # each iteration's loss exactly once, against its own iteration
    assert [s for s, _ in got["Loss"]] == steps
    assert [s for s, _ in t_train.read_scalar("Loss")] == steps
    for (_, g), (_, w) in zip(got["Loss"], want["Loss"]):
        assert g == pytest.approx(w, rel=1e-5, abs=1e-6)
    assert got["LearningRate"] == want["LearningRate"]
    assert [s for s, _ in got["Parameters/subsample"]] == [5, 10]
    assert all(v >= 0 for _, v in got["Throughput"])
    gv, wv = _tags(t_val), _tags(j_val)
    assert set(gv) == set(wv) == {"Top1Accuracy", "Loss"}
    for tag in wv:
        assert [s for s, _ in gv[tag]] == [s for s, _ in wv[tag]] == \
            [6, 12], tag
        for (_, g), (_, w) in zip(gv[tag], wv[tag]):
            assert g == pytest.approx(w, rel=1e-5, abs=1e-6), tag


def test_summary_triggers_and_read_scalar(tmp_path):
    s = tsummary.ValidationSummary(str(tmp_path), "app")
    assert s.log_dir == os.path.join(str(tmp_path), "app", "validation")
    assert not s.trigger_fires("Parameters", 4)
    s.set_summary_trigger("Parameters", 4)
    assert s.trigger_fires("Parameters", 8) and \
        not s.trigger_fires("Parameters", 6)
    s.add_scalar("Top1Accuracy", 0.25, 3).add_scalar("Top1Accuracy", 0.5, 6)
    assert s.read_scalar("Top1Accuracy") == [(3, 0.25), (6, 0.5)]
    assert s.read_scalar("none") == []
    js = jsummary.ValidationSummary(str(tmp_path), "app")
    assert js.read_scalar("Top1Accuracy") == [(3, 0.25), (6, 0.5)]
    for cls, tag in ((tsummary.ServingSummary, "serving"),
                     (tsummary.TelemetrySummary, "telemetry"),
                     (tsummary.TrainSummary, "train")):
        assert cls(str(tmp_path), "x").log_dir.endswith(tag)
    s.close()


def test_transformer_train_summary(tmp_path):
    transformer_train.main([
        "--maxEpoch", "1", "-b", "2", "--seqLen", "8", "--vocabSize", "20",
        "--hiddenSize", "16", "--numHeads", "2", "--filterSize", "16",
        "--numLayers", "1", "--syntheticSize", "256", "--device", "cpu",
        "--summary", str(tmp_path)])
    s = tsummary.TrainSummary(str(tmp_path), "transformer_train")
    loss = s.read_scalar("Loss")
    n = len(loss)
    assert n > 0 and [st for st, _ in loss] == list(range(1, n + 1))
    assert all(np.isfinite(v) for _, v in loss)
    assert [st for st, _ in s.read_scalar("LearningRate")] == \
        list(range(1, n + 1))
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "transformer_train",
                                           "validation"))
