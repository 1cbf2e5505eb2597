"""Remote paths and model files of the port (bigdl_tpu_torch/utils/
file_io.py, serialization.py, the optimizer's checkpoint directories)
against the JAX package's, on the CPU.

- ``file_io`` gives JAX's answers on local, ``file://`` and ``memory://``
  paths; a local write leaves no temporary file.
- Pytrees saved by either package under ``memory://`` load in the other.
- ``save_model``/``load_model``: the blob ``{"class", "variables"}`` of a
  depth-8 cifar ResNet and an unfused depth-18 imagenet ResNet crosses
  both ways, locally and under ``memory://``, and the loaded model's
  forward equals the saved one's bit for bit (port to port) or JAX's
  within 1e-4.
- Checkpoints under ``memory://`` through the ``Optimizer`` (async and
  ``BIGDL_TPU_SYNC_LOOP=1``): written, resumed bit-equal to the
  uninterrupted run, retried after a NaN step, with and without
  overwrite; JAX resumes from the port's and the port from JAX's.

The ``memory://`` cases need ``fsspec``, which the package imports only
for such a path.
"""
import os

import numpy as np
import pytest

import jax
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.optim import SGD as JaxSGD, Trigger as JaxTrigger
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.utils import file_io as jfile_io
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils import (export_variables, file_io, flatten,
                                   load_jax_variables, load_model,
                                   load_pytree, random_variables,
                                   save_model, save_pytree)


@pytest.fixture(params=["async", "sync"])
def loop(request, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP",
                       "1" if request.param == "sync" else "0")
    return request.param


@pytest.fixture
def mem(tmp_path):
    """A fresh ``memory://`` directory (the filesystem is per process)."""
    pytest.importorskip("fsspec")
    return f"memory://{tmp_path.name}"


def _leaves(tree):
    return {k: np.asarray(v) for k, v in flatten(tree).items()}


def _bit_equal(a, b):
    a, b = _leaves(a), _leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------- file_io
def test_file_io_local_paths_equal_jax(tmp_path):
    base = str(tmp_path)
    for f in ("is_remote", "strip_file_scheme"):
        for p in ("a/b", "file:///x/y", "gs://b/k", "memory://m/x"):
            assert getattr(file_io, f)(p) == getattr(jfile_io, f)(p), (f, p)
    for mod, sub in ((file_io, "t"), (jfile_io, "j")):
        d = mod.join(base, sub, "deep")
        assert not mod.exists(d) and mod.listdir(d) == []
        mod.makedirs("file://" + d)
        assert mod.exists(d)
        mod.write_bytes(mod.join(d, "f.bin"), b"payload")
        with mod.open_file("file://" + mod.join(d, "f.bin")) as f:
            assert f.read() == b"payload"
    for sub in ("t", "j"):
        d = os.path.join(base, sub, "deep")
        assert sorted(file_io.listdir(d)) == sorted(jfile_io.listdir(d)) \
            == ["f.bin"]  # no temporary file left
        assert file_io.read_bytes(os.path.join(d, "f.bin")) == b"payload"
    assert file_io.join("gs://b/", "/c/", "d") == \
        jfile_io.join("gs://b/", "/c/", "d") == "gs://b/c/d"


def test_file_io_memory_paths_equal_jax(mem):
    for mod, sub in ((file_io, "t"), (jfile_io, "j")):
        d = mod.join(mem, sub)
        assert not mod.exists(d) and mod.listdir(d) == []
        mod.makedirs(d)
        mod.write_bytes(mod.join(d, "a.npz"), b"x" * 10)
        mod.write_bytes(mod.join(d, "b"), b"yy")
    for sub in ("t", "j"):
        d = f"{mem}/{sub}"
        assert sorted(file_io.listdir(d)) == sorted(jfile_io.listdir(d)) \
            == ["a.npz", "b"]
        assert file_io.read_bytes(d + "/b") == jfile_io.read_bytes(d + "/b")
        assert file_io.exists(d + "/a.npz")


def test_pytrees_cross_under_memory_paths(mem, tmp_path):
    tree = {"a": np.arange(6, dtype=np.int8).reshape(2, 3),
            "b": (np.ones(3, np.float32), [np.zeros(2)]), "name": "x",
            "none": None}
    for save, load in ((save_pytree, jser.load_pytree),
                       (jser.save_pytree, load_pytree)):
        for path in (f"{mem}/{save.__module__}/t", str(tmp_path / "t")):
            save(path, tree)
            got = load(path)
            assert got["name"] == "x" and got["none"] is None
            assert isinstance(got["b"], tuple)
            np.testing.assert_array_equal(got["a"], tree["a"])
            assert got["a"].dtype == np.int8
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


# ------------------------------------------------------------ model files
def _resnets(kind):
    if kind == "cifar8":
        jm = JaxResNet(10, depth=8, dataset="cifar10")
        tm = ResNet(10, depth=8, dataset="cifar10", device="cpu")
        size = 32
    else:
        jm = JaxResNet(10, depth=18, dataset="imagenet")
        tm = ResNet(10, depth=18, dataset="imagenet", device="cpu")
        size = 32
    v = random_variables(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1))), 6)
    x = np.random.RandomState(2).rand(3, size, size, 3).astype(np.float32)
    return jm, tm, v, x


def _fresh(kind):
    return (ResNet(10, depth=8, dataset="cifar10", device="cpu")
            if kind == "cifar8"
            else ResNet(10, depth=18, dataset="imagenet", device="cpu"))


@pytest.mark.parametrize("where", ["local", "memory"])
@pytest.mark.parametrize("kind", ["cifar8", "imagenet18"])
def test_save_model_load_model_cross_both_ways(tmp_path, kind, where):
    if where == "memory":
        pytest.importorskip("fsspec")
        base = f"memory://{tmp_path.name}-{kind}"
    else:
        base = str(tmp_path)
    jm, tm, v, x = _resnets(kind)
    load_jax_variables(tm, v)
    tm.eval()
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    jwant = np.asarray(jm.apply(v["params"], v["state"], x,
                                training=False)[0])
    np.testing.assert_allclose(want, jwant, rtol=1e-4, atol=1e-4)

    # port -> port: the loaded model's forward bit-equal
    save_model(file_io.join(base, "port"), tm)
    fresh = _fresh(kind)
    blob = load_model(file_io.join(base, "port"), fresh)
    assert blob["class"] == type(tm).__name__
    _bit_equal(blob["variables"], export_variables(tm))
    fresh.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(x)).numpy(),
                                      want)
    # port -> JAX
    jblob = jser.load_model(file_io.join(base, "port"))
    assert jblob["class"] == blob["class"]
    np.testing.assert_allclose(
        np.asarray(jm.apply(jblob["variables"]["params"],
                            jblob["variables"]["state"], x,
                            training=False)[0]), jwant, rtol=1e-5,
        atol=1e-5)
    # JAX -> port
    jser.save_model(file_io.join(base, "jax"), jm, v)
    fresh = _fresh(kind)
    blob = load_model(file_io.join(base, "jax"), fresh)
    assert blob["class"] == type(jm).__name__
    fresh.eval()
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(x)).numpy(),
                                      want)
    # explicit variables, as JAX's signature takes them
    save_model(file_io.join(base, "explicit"), tm, v)
    _bit_equal(load_model(file_io.join(base, "explicit"))["variables"], v)


# ------------------------------------------------- checkpoints, remote
def _conv(nn):
    return nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, padding="SAME"),
        nn.SpatialBatchNormalization(8), nn.ReLU(),
        nn.GlobalAveragePooling2D(), nn.Linear(8, 5))


def _data():
    rs = np.random.RandomState(0)
    return rs.randn(12, 8, 8, 3).astype(np.float32), rs.randint(0, 5, 12)


def _variables():
    return random_variables(jax.tree_util.tree_map(
        np.asarray, _conv(jnn).init(jax.random.PRNGKey(0))), 4)


class _NanAt(tnn.ClassNLLCriterion):
    """ClassNLL whose loss is NaN at the given (1-based) calls."""

    def __init__(self, calls=()):
        super().__init__(logits=True)
        self.calls, self.n = set(calls), 0

    def forward(self, out, target):
        self.n += 1
        loss = super().forward(out, target)
        return loss * float("nan") if self.n in self.calls else loss


def _run(end, ckpt=None, resume=None, every=1, nan=(), overwrite=True):
    x, y = _data()
    opt = (Optimizer.apply(_conv(tnn), DataSet.from_arrays(x, y,
                                                           batch_size=4),
                           _NanAt(nan), end_trigger=Trigger.max_iteration(end),
                           device="cpu")
           .set_optim_method(SGD(0.1, momentum=0.9))
           .set_initial_variables(_variables()))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.several_iteration(every))
        opt.over_write_checkpoint(overwrite)
    if resume is not None:
        opt.resume_from(resume)
    opt.optimize()
    return opt


def _jax_run(end, ckpt=None, resume=None):
    x, y = _data()
    opt = (JaxLocalOptimizer(_conv(jnn),
                             JaxDataSet.from_arrays(x, y, batch_size=4),
                             jnn.ClassNLLCriterion(logits=True),
                             JaxTrigger.max_iteration(end))
           .set_optim_method(JaxSGD(0.1, momentum=0.9))
           .set_initial_variables(_variables()))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, JaxTrigger.several_iteration(2))
    if resume is not None:
        opt.resume_from(resume)
    opt.optimize()
    return opt


def test_memory_checkpoints_resume_bit_equal(mem, loop):
    full = _run(7)
    _run(4, ckpt=f"{mem}/part")
    blob = load_pytree(f"{mem}/part/model")
    assert blob["driver_state"]["neval"] == 4
    resumed = _run(7, resume=f"{mem}/part/model")
    assert resumed._loop_state["loss"] == full._loop_state["loss"]
    for k, t in resumed.final_params.items():
        np.testing.assert_array_equal(t.numpy(), full.final_params[k].numpy())
    # without overwrite: a timestamped directory of model.<iteration>
    _run(3, ckpt=f"{mem}/ts", overwrite=False)
    (sub,) = file_io.listdir(f"{mem}/ts")
    assert sorted(file_io.listdir(f"{mem}/ts/{sub}")) == \
        ["model.1.npz", "model.2.npz", "model.3.npz"]
    from bigdl_tpu_torch.optim import LocalOptimizer
    assert LocalOptimizer._latest_ckpt(f"{mem}/ts/{sub}") == \
        f"{mem}/ts/{sub}/model.3"


def test_memory_checkpoint_retry_after_a_nan_step(mem, loop):
    opt = _run(6, ckpt=f"{mem}/retry", every=2, nan=[4])
    assert opt._retries == 1 and opt._loop_state["neval"] == 6
    assert np.isfinite(opt._loop_state["loss"])
    blob = load_pytree(f"{mem}/retry/model")
    for tree in ("params", "model_state", "opt_states"):
        assert all(np.isfinite(a).all() for a in _leaves(blob[tree]).values())


def test_memory_checkpoints_cross_between_the_packages(mem, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP", "1")
    # JAX -> port
    _jax_run(4, ckpt=f"{mem}/jax")
    jblob = jser.load_pytree(f"{mem}/jax/model")
    port = _run(4, resume=f"{mem}/jax/model")
    _bit_equal({k: t.numpy() for k, t in port.final_params.items()},
               jblob["params"])
    # port -> JAX, then both go on to iteration 8 and agree
    _run(6, ckpt=f"{mem}/port", every=2)
    jres = _jax_run(8, resume=f"{mem}/port/model")
    port8 = _run(8)
    for k, w in _leaves(jax.tree_util.tree_map(np.asarray,
                                               jres.final_params)).items():
        np.testing.assert_allclose(port8.final_params[k].numpy(), w,
                                   rtol=1e-5, atol=1e-5, err_msg=k)
