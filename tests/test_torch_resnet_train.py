"""The ResNet recipe driver of the port (bigdl_tpu_torch/models/
resnet_train.py, train_utils.py and the cifar10 branch of
models/resnet.py) against the JAX package's, on the CPU.

- ResNet-8 for CIFAR-10 carries JAX's weights key for key and gives
  JAX's eval forward within 1e-4, unfused and fused (FusedBasicBlock); a
  bad depth raises.
- ``make_recipe_optim``'s rate at every step of a run (warmup, then
  poly from maxLr) equals JAX's, for LARS and SGD.
- ``main`` on JAX's tiny recipe run (tests/test_train_drivers.py:20-31,
  ``--device cpu``) trains on the async loop and reports Top1 and Top5,
  and so does its fused CIFAR form (``--fused --dataset cifar10 --depth
  8``);
  with ``--folder`` (CIFAR-10 binary batches), ``--streaming`` (TFRecord
  shards of an unfused depth-18 imagenet ResNet) and ``--summary`` it
  trains from the files and writes the scalars.
- ``synthetic_imagenet`` gives JAX's arrays; ``predict`` yields JAX's
  ``predict`` outputs batch by batch.
"""
import re

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.models import resnet_train as jax_resnet_train
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.models.train_utils import \
    synthetic_imagenet as jax_synthetic_imagenet
from bigdl_tpu.optim.optimizer import predict as jax_predict
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import ResNet, resnet_train
from bigdl_tpu_torch.models.train_utils import synthetic_imagenet
from bigdl_tpu_torch.optim import predict
from bigdl_tpu_torch.utils import (export_variables, flatten,
                                   load_jax_variables, random_variables)

RECIPE = ["--maxEpoch", "2", "-b", "32", "--syntheticSize", "128",
          "--depth", "8", "--classNum", "4", "--dataset", "cifar10",
          "--imageSize", "32", "--learningRate", "0.1", "--maxLr", "0.4",
          "--warmupEpoch", "1", "--optim", "lars"]


def _cifar8():
    jm = JaxResNet(4, depth=8, dataset="cifar10")
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 3)
    tm = ResNet(4, depth=8, dataset="cifar10", device="cpu")
    load_jax_variables(tm, v)
    return jm, tm, v


def test_cifar_resnet8_forward_matches_jax():
    jm, tm, v = _cifar8()
    assert flatten(export_variables(tm)["params"]).keys() == \
        flatten(v["params"]).keys()
    assert "fc.weight" in dict(tm.named_parameters())
    x = np.random.RandomState(4).rand(5, 32, 32, 3).astype(np.float32)
    want, _ = jm.apply(v["params"], v["state"], x, training=False)
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    # the fused form builds and gives JAX's fused forward
    jf = JaxResNet(4, depth=8, dataset="cifar10", fused=True)
    vf = random_variables(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), jax.eval_shape(
            lambda: jf.init(jax.random.PRNGKey(0)))), 5)
    tf = ResNet(4, depth=8, dataset="cifar10", fused=True, device="cpu")
    load_jax_variables(tf, vf)
    want, _ = jf.apply(vf["params"], vf["state"], x, training=False)
    with torch.inference_mode():
        got = tf(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="6n"):
        ResNet(4, depth=10, dataset="cifar10", device="cpu")


class _Args:
    learningRate, maxLr, warmupEpoch, maxEpoch = 0.1, 3.2, 2, 6
    momentum, weightDecay = 0.9, 1e-4


@pytest.mark.parametrize("method", ["lars", "sgd"])
def test_recipe_rates_match_jax_step_by_step(method):
    args = type("A", (_Args,), {"optim": method})
    ipe = 7
    j = jax_resnet_train.make_recipe_optim(args, ipe)
    t = resnet_train.make_recipe_optim(args, ipe)
    assert type(t).__name__ == type(j).__name__
    assert (t.momentum, t.weight_decay) == (j.momentum, j.weight_decay)
    rates = []
    for n in range(args.maxEpoch * ipe + 3):
        for m in (j, t):
            m.state["neval"], m.state["epoch"] = n, n // ipe
        assert t.current_rate() == j.current_rate(), n
        rates.append(t.current_rate())
    warm = args.warmupEpoch * ipe
    assert rates[0] == pytest.approx(0.1)
    assert rates[warm] == pytest.approx(3.2)  # the poly starts at maxLr
    assert rates[warm - 1] < rates[warm] and rates[-4] < rates[warm + 1]


def test_main_runs_the_recipe_on_the_cpu(caplog):
    with caplog.at_level("INFO", logger="bigdl_tpu_torch.optim"):
        res = resnet_train.main(RECIPE + ["--device", "cpu"])
    assert set(res) == {"Top1Accuracy", "Top5Accuracy"}
    assert 0.0 <= res["Top1Accuracy"] <= res["Top5Accuracy"] <= 1.0
    lines = [r.getMessage() for r in caplog.records]
    # the async loop's phases, validation every epoch
    assert any("data_stall" in m and "dispatch" in m for m in lines)
    assert sum(m.startswith("Top5Accuracy is") for m in lines) == 2
    jres = jax_resnet_train.main(RECIPE)
    assert set(jres) == set(res)


def test_main_runs_the_fused_cifar_recipe_on_the_cpu(caplog):
    """Two iterations of the fused CIFAR ResNet-8 with finite losses (its
    4 validation images are fewer than a batch: no Top1 to report)."""
    with caplog.at_level("INFO", logger="bigdl_tpu_torch.optim"):
        res = resnet_train.main(["--fused", "--dataset", "cifar10",
                                 "--depth", "8", "--classNum", "4", "-b",
                                 "8", "--syntheticSize", "16", "--maxEpoch",
                                 "1", "--warmupEpoch", "1", "--device",
                                 "cpu"])
    losses = [float(v) for r in caplog.records
              for v in re.findall(r"Loss is (\S+)\. ", r.getMessage())]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert res == {}


@pytest.mark.parametrize("flag", [["--folder", "{cifar}"],
                                  ["--streaming", "--folder", "{shards}"],
                                  ["--summary", "{logs}"]])
def test_unported_options_raise(flag, tmp_path, caplog):
    """Once these options raised NotImplementedError; now each runs:
    ``--folder`` reads CIFAR-10 binary batches written here (the cifar10
    recipe), ``--streaming`` streams imagenet-layout TFRecord shards (an
    unfused depth-18 imagenet ResNet at 32 px), ``--summary`` writes the
    training scalars at every iteration."""
    from bigdl_tpu_torch.dataset.sharded import write_image_shards
    from bigdl_tpu_torch.visualization import TrainSummary

    rs = np.random.RandomState(5)
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    for name, n in [(f"data_batch_{i}", 16) for i in range(1, 6)] + [
            ("test_batch", 32)]:
        recs = np.concatenate([rs.randint(0, 4, (n, 1)),
                               rs.randint(0, 256, (n, 3072))], axis=1)
        recs.astype(np.uint8).tofile(str(cifar / f"{name}.bin"))
    shards = tmp_path / "shards"
    for split, n, k in (("train", 32, 4), ("validation", 16, 2)):
        write_image_shards(str(shards), rs.randint(0, 256, (n, 32, 32, 3)),
                           rs.randint(0, 4, n), k, split)
    paths = {"cifar": str(cifar), "shards": str(shards),
             "logs": str(tmp_path / "logs")}
    argv = RECIPE + ["--device", "cpu"] + [a.format(**paths) for a in flag]
    if "--streaming" in flag:
        argv += ["--dataset", "imagenet", "--depth", "18", "-b", "16"]
    with caplog.at_level("INFO", logger="bigdl_tpu_torch.optim"):
        res = resnet_train.main(argv)
    assert set(res) == {"Top1Accuracy", "Top5Accuracy"}
    assert 0.0 <= res["Top1Accuracy"] <= res["Top5Accuracy"] <= 1.0
    iters = [m for m in (r.getMessage() for r in caplog.records)
             if "[Iteration" in m]
    # 80 cifar records at batch 32 or 32 streamed ones at 16: 2 batches an
    # epoch; the synthetic 128: 4
    want = 8 if "--summary" in flag else 4
    assert f"[Iteration {want}]" in iters[-1], iters[-1]
    if "--summary" in flag:
        s = TrainSummary(paths["logs"], "resnet_train")
        for tag in ("Loss", "Throughput", "LearningRate"):
            assert [st for st, _ in s.read_scalar(tag)] == \
                list(range(1, want + 1)), tag


def test_synthetic_imagenet_and_predict_match_jax():
    x, y = synthetic_imagenet(10, 32, 4, seed=2)
    jx, jy = jax_synthetic_imagenet(10, 32, 4, 2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    jm, tm, v = _cifar8()
    got = list(predict(tm, dict(tm.named_parameters()),
                       dict(tm.named_buffers()),
                       DataSet.from_arrays(x, y, batch_size=4)))
    want = list(jax_predict(jm, v["params"], v["state"],
                            JaxDataSet.from_arrays(x, y, batch_size=4)))
    assert len(got) == len(want) == 2  # the last partial batch dropped
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (4, 4)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
