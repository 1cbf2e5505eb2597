"""The port's dense layers, embedding, containers of nn/module.py,
stochastic layers and initialisers against the JAX package's, on the
CPU.

The layer cases of this group (tests/torch_zoo_cases.py) go through
tests/torch_zoo_harness.py: values and gradients against JAX, f32 and
bf16.  The stochastic layers are held there in evaluation mode, exactly;
in training mode they draw from the port's seed streams
(``nn/dropout.py``), which cannot replay JAX's threefry bits, so they are
held by structure (a spatial dropout zeroes whole channels and scales
the rest by 1 / (1 - p)), by seed (the same seed, int or tensor, gives
the same draw; another seed another) and by law: the moments of 2**16
draws within 5 standard errors of JAX's distribution.  The
deterministic initialisers (Ones, ConstInitMethod, BilinearFiller)
match JAX exactly, the random ones by bounds and moments.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_zoo_harness as H
from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.dropout import normal, uniform
from torch_zoo_cases import CASES, group

MODES = [(name, mode) for name in group("linear_dropout_init")
         for mode in (("f32", "bf16") if CASES[name].bf16 else ("f32",))]
N = 1 << 16  # draws for a moment check


@pytest.mark.parametrize("name,mode", MODES,
                         ids=[f"{n}-{m}" for n, m in MODES])
def test_layer_against_jax(name, mode):
    H.run(name, "bfloat16" if mode == "bf16" else "float32")


def test_echo_prints_name_and_shape(capsys):
    x = torch.zeros(2, 3)
    assert tnn.Echo(name="probe")(x) is x
    assert capsys.readouterr().out == "probe: (2, 3)\n"


def _moments(a, mean, std, what):
    a = np.asarray(a, np.float64).ravel()
    se = std / math.sqrt(a.size)
    assert abs(a.mean() - mean) < 5 * se, (what, a.mean(), mean)
    # the sample variance's standard error is about var * sqrt(2 / n)
    assert abs(a.var() - std * std) < 5 * std * std * math.sqrt(
        2.0 / a.size), (what, a.std(), std)


@pytest.mark.parametrize("cls,shape,mask_shape", [
    ("SpatialDropout1D", (64, 5, 64), (64, 1, 64)),
    ("SpatialDropout2D", (64, 3, 2, 64), (64, 1, 1, 64)),
    ("SpatialDropout3D", (64, 2, 2, 2, 64), (64, 1, 1, 1, 64))])
def test_spatial_dropout_training(cls, shape, mask_shape):
    p = 0.3
    m = getattr(tnn, cls)(p).train()
    x = torch.rand(shape) + 0.5  # no zero in x
    y = m(x, rng=11)
    kept = (y != 0)
    # whole channels: every position of a (sample, channel) agrees
    per = kept.reshape(shape[0], -1, shape[-1])
    assert (per.all(1) | ~per.any(1)).all()
    torch.testing.assert_close(y[kept], (x / (1 - p))[kept])
    frac = per[:, 0].float().mean().item()
    n = math.prod(mask_shape)
    assert abs(frac - (1 - p)) < 5 * math.sqrt(p * (1 - p) / n)
    assert torch.equal(m(x, rng=11), y)
    assert torch.equal(m(x, rng=torch.tensor(11)), y)
    assert not torch.equal(m(x, rng=12), y)
    assert torch.equal(m.eval()(x), x)
    with pytest.raises(ValueError, match="needs an rng"):
        m.train()(x)


def test_gaussian_dropout_and_noise_training_law():
    x = torch.full((N,), 2.0)
    rate = 0.2
    y = tnn.GaussianDropout(rate).train()(x, rng=3)
    _moments((y / 2.0).numpy(), 1.0, math.sqrt(rate / (1 - rate)),
             "GaussianDropout")
    j = np.asarray(jnn.GaussianDropout(rate).apply(
        {}, {}, jnp.asarray(x.numpy()), training=True,
        rng=jax.random.PRNGKey(3))[0])
    _moments(j / 2.0, 1.0, math.sqrt(rate / (1 - rate)), "JAX's")
    z = tnn.GaussianNoise(0.3).train()(x, rng=4)
    _moments((z - x).numpy(), 0.0, 0.3, "GaussianNoise")
    assert torch.equal(tnn.GaussianNoise(0.3).train()(x, rng=4), z)
    assert not torch.equal(tnn.GaussianNoise(0.3).train()(x, rng=5), z)


def test_gaussian_sampler_reparameterises():
    rs = np.random.RandomState(0)
    mean = torch.tensor(rs.randn(256, 256), dtype=torch.float32,
                        requires_grad=True)
    logvar = torch.tensor(0.3 * rs.randn(256, 256), dtype=torch.float32,
                          requires_grad=True)
    y = tnn.GaussianSampler()((mean, logvar), rng=9)
    std = torch.exp(0.5 * logvar)
    eps = ((y - mean) / std).detach()
    _moments(eps.numpy(), 0.0, 1.0, "eps")
    g = torch.randn(256, 256)
    y.backward(g)
    torch.testing.assert_close(mean.grad, g)
    torch.testing.assert_close(logvar.grad, g * 0.5 * std.detach() * eps,
                               rtol=1e-5, atol=1e-5)
    # no rng: the mean, in any mode, as JAX
    assert tnn.GaussianSampler()((mean, logvar)) is mean


def test_rrelu_training_slopes():
    lower, upper = 0.1, 0.4
    x = -torch.rand(N) - 0.5
    y = tnn.RReLU(lower, upper).train()(x, rng=5)
    a = (y / x).numpy()
    assert a.min() >= lower and a.max() <= upper
    _moments(a, (lower + upper) / 2, (upper - lower) / math.sqrt(12),
             "RReLU slopes")
    pos = torch.rand(10)
    assert torch.equal(tnn.RReLU().train()(pos, rng=5), pos)


def test_seed_streams():
    u = uniform((N,), 7, "cpu")
    assert 0.0 <= u.min().item() and u.max().item() < 1.0
    _moments(u.numpy(), 0.5, math.sqrt(1 / 12), "uniform")
    z = normal((N,), 7, "cpu")
    _moments(z.numpy(), 0.0, 1.0, "normal")
    assert torch.equal(normal((N,), torch.tensor(7), "cpu"), z)
    assert normal((3, 4), 7, "cpu", torch.bfloat16).dtype == torch.bfloat16


def _chain(form):
    layers = [tnn.Linear(8, 8), tnn.Dropout(0.5), tnn.SpatialDropout1D(0.5),
              tnn.Tanh()]
    if form == "sequential":
        return tnn.Sequential(*layers)
    node = inp = tnn.Input()
    for m in layers:
        node = m.inputs(node)
    return tnn.Graph([inp], [node])


@pytest.mark.parametrize("form", ["sequential", "graph"])
def test_container_hands_child_i_its_split_seed(form):
    model = _chain(form).train()
    keys = model.child_keys
    x = torch.randn(4, 3, 8)
    got = model(x, rng=21)
    h = model._modules[keys[0]](x)
    h = model._modules[keys[1]](h, rng=tnn.split_rng(21, 1))
    h = model._modules[keys[2]](h, rng=tnn.split_rng(21, 2))
    assert torch.equal(got, torch.tanh(h))
    assert torch.equal(model.eval()(x), model(x, rng=21))


@pytest.mark.parametrize("name,make", [
    ("Ones", lambda nn: nn.Ones()),
    ("ConstInitMethod", lambda nn: nn.ConstInitMethod(0.375)),
    ("BilinearFiller", lambda nn: nn.BilinearFiller()),
    ("Zeros", lambda nn: nn.Zeros())])
def test_deterministic_initialisers_match_jax(name, make):
    for shape in ((2, 3, 4, 4), (1, 2, 3, 5)):
        want = np.asarray(make(jnn)(jax.random.PRNGKey(0), shape))
        got = make(tnn)(None, shape).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("average", [False, True])
def test_msra_filler_std(average):
    shape, fan_in, fan_out = (256, 256), 64, 192
    g = torch.Generator().manual_seed(0)
    w = tnn.MsraFiller(average)(g, shape, fan_in=fan_in, fan_out=fan_out)
    n = (fan_in + fan_out) / 2 if average else fan_in
    _moments(w.numpy(), 0.0, math.sqrt(2.0 / n), "MsraFiller")
    j = np.asarray(jnn.MsraFiller(average)(jax.random.PRNGKey(0), shape,
                                           fan_in=fan_in, fan_out=fan_out))
    _moments(j, 0.0, math.sqrt(2.0 / n), "JAX's MsraFiller")


def test_random_initialisers_bounds():
    g = torch.Generator().manual_seed(0)
    w = tnn.RandomUniform()(g, (N,), fan_in=16)
    assert w.abs().max().item() <= 0.25
    _moments(w.numpy(), 0.0, 0.25 / math.sqrt(3), "RandomUniform")
    w = tnn.Xavier()(g, (256, 256), fan_in=100, fan_out=60)
    bound = math.sqrt(6.0 / 160)
    assert w.abs().max().item() <= bound
    w = tnn.RandomNormal(0.5, 0.1)(g, (N,))
    _moments(w.numpy(), 0.5, 0.1, "RandomNormal")
    assert issubclass(tnn.Ones, tnn.InitializationMethod)
