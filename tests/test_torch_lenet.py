"""LeNet-5 (both forms), the autoencoder, the MNIST reader and the
LeNet driver of the port against the JAX package's, on the CPU.

The models take the same seeded numpy weights through
``load_jax_variables``; outputs, every parameter gradient and the input
gradient are held at rtol/atol 1e-5 of the largest |value| (sum order
only).  The drivers run two iterations each on the same synthetic MNIST
from the same weights, and their first logged losses agree to the log
line's 4 decimals.
The idx files the reader round-trips are written here, plain and gzip.
"""
import gzip
import logging
import re
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bigdl_tpu.models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import mnist as tmnist
from bigdl_tpu_torch.utils import load_jax_variables, random_variables
from bigdl_tpu_torch.utils.convert import flatten

TOL = 1e-5


def _variables(jm, seed):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    return random_variables(zeros, seed)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _hold(jm, tm, variables, x, loss):
    """Output, loss, input and parameter gradients of one forward and
    backward of ``loss(out)`` in both packages."""
    def f(params, xx):
        out = jm.apply(params, variables["state"], xx)[0]
        return loss(jnp, out), out

    (jl, jout), (jgp, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    load_jax_variables(tm, variables)
    xt = torch.tensor(x, requires_grad=True)
    out = tm.eval()(xt)
    tl = loss(torch, out)
    tl.backward()
    _close(out.detach().numpy(), jout, "output")
    _close(tl.item(), jl, "loss")
    _close(xt.grad.numpy(), jgx, "input gradient")
    want = flatten(jgp)
    params = dict(tm.named_parameters())
    assert sorted(want) == sorted(params)
    for k, p in params.items():
        _close(p.grad.numpy(), want[k], k)


def _nll(xp, out):
    """Mean negative log-likelihood of class (row index % 10)."""
    if xp is jnp:
        logp = jax.nn.log_softmax(out, -1)
    else:
        logp = torch.log_softmax(out, -1)
    rows = np.arange(out.shape[0])
    return -logp[rows, rows % 10].mean()


@pytest.mark.parametrize("form", ["sequential", "graph"])
def test_lenet_forward_backward_against_jax(form):
    build = {"sequential": "LeNet5", "graph": "lenet_graph"}[form]
    jm = getattr(jmodels, build)(10)
    tm = getattr(tmodels, build)(10, device="cpu")
    x = np.random.RandomState(1).randn(4, 28, 28, 1).astype(np.float32)
    _hold(jm, tm, _variables(jm, 3), x, _nll)


@pytest.mark.parametrize("build", ["LeNet5", "lenet_graph", "Autoencoder"])
def test_parameter_keys_are_jax_keys(build):
    want = flatten(jax.eval_shape(getattr(jmodels, build)().init,
                                  jax.random.PRNGKey(0))["params"])
    got = dict(getattr(tmodels, build)(device="cpu").named_parameters())
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in want)


def test_autoencoder_mse_against_jax():
    jm, tm = jmodels.Autoencoder(16), tmodels.Autoencoder(16, device="cpu")
    rs = np.random.RandomState(2)
    x = rs.rand(4, 28, 28, 1).astype(np.float32)
    target = x.reshape(4, -1)

    def mse(xp, out):
        t = jnp.asarray(target) if xp is jnp else torch.from_numpy(target)
        return ((out - t) ** 2).mean()

    _hold(jm, tm, _variables(jm, 4), x, mse)
    crit = tnn.MSECriterion()
    jcrit = jnn.MSECriterion()
    out = tm(torch.from_numpy(x))
    _close(crit.forward(out, torch.from_numpy(target)).item(),
           jcrit.forward(jnp.asarray(out.detach().numpy()),
                         jnp.asarray(target)), "MSECriterion")


def _write_idx(folder, prefix, images, labels, gz):
    op = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    with op(folder / f"{prefix}-images-idx3-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with op(folder / f"{prefix}-labels-idx1-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_round_trip(tmp_path, gz):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    _write_idx(tmp_path, "t10k", images, labels, gz)
    x, y = tmnist.load_mnist(str(tmp_path), train=False)
    assert x.shape == (5, 28, 28, 1) and x.dtype == np.float32
    np.testing.assert_array_equal(y, labels.astype(np.int32))
    np.testing.assert_allclose(
        x[..., 0] * tmnist.TRAIN_STD + tmnist.TRAIN_MEAN, images / 255.0,
        rtol=1e-6, atol=1e-6)
    jx, jy = jmnist.load_mnist(str(tmp_path), train=False)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist(str(tmp_path), train=True)


def test_synthetic_mnist_bit_equal_to_jax():
    for train in (True, False):
        x, y = tmnist.load_mnist(None, train=train, synthetic_n=96)
        jx, jy = jmnist.load_mnist(None, train=train, synthetic_n=96)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert (tmnist.TRAIN_MEAN, tmnist.TRAIN_STD) == (jmnist.TRAIN_MEAN,
                                                     jmnist.TRAIN_STD)


_LOSS = re.compile(r"\[Iteration (\d+)\].*?Loss is (\d+\.\d+)")


class _Lines(logging.Handler):
    """Collects the messages of one logger."""

    def __init__(self, logger):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logging.getLogger(logger)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)

    def losses(self):
        """``{iteration: loss}`` of the reference log lines."""
        return {int(m.group(1)): float(m.group(2)) for m in
                map(_LOSS.search, self.lines) if m}


def test_lenet_train_first_loss_matches_jax_driver(monkeypatch):
    """Both drivers, two iterations (256 synthetic images, batch 128) from
    the same weights: the logged loss of iteration 1 agrees."""
    from bigdl_tpu.models import lenet_train as jdriver
    from bigdl_tpu_torch.models import lenet_train as tdriver

    variables = _variables(jmodels.LeNet5(10), 5)

    def jax_lenet(n):
        m = jmodels.LeNet5(n)
        m.init = lambda rng=None, dtype=None: variables
        return m

    def port_lenet(n, device=None, generator=None):
        m = tmodels.LeNet5(n, device=device, generator=generator)
        load_jax_variables(m, variables)
        return m

    monkeypatch.setattr(jdriver, "LeNet5", jax_lenet)
    monkeypatch.setattr(tdriver, "LeNet5", port_lenet)
    argv = ["--maxEpoch", "1", "-b", "128", "--syntheticSize", "256"]
    with _Lines("bigdl_tpu.optim") as j, _Lines("bigdl_tpu_torch.optim") as t:
        jdriver.main(argv)
        res = tdriver.main(argv + ["--device", "cpu"])
    assert res == {}  # 64 validation images: under one batch
    jl, tl = j.losses(), t.losses()
    assert max(tl) == 2 and 1 in jl, (tl, jl)
    # the log line rounds the loss to 4 decimals
    assert abs(tl[1] - jl[1]) <= 1e-4, (tl, jl)
