"""The port's public callables take the JAX package's parameters.

For every callable that both packages export from ``nn``, ``optim``,
``dataset``, ``serving``, ``parallel`` and ``distributed`` (a class is
compared by its constructor), a positional call that is right for JAX
either binds the same way in the port or raises:

- the port's positional parameters begin with JAX's, in JAX's order
  (port-only ones, such as ``device``, ``generator``, ``remat`` or
  ``mesh``, come after them or are keyword-only);
- every parameter of JAX's exists in the port under its name, with
  JAX's default where the default is a plain value (None, a number, a
  string, a tuple of those) and with a default exactly where JAX has
  one;
- where JAX has a parameter the port lacks (``jit`` plumbing), the port
  has no positional parameter from that position on, so a JAX call that
  passes it positionally raises instead of binding it to another one.

``EXCEPTIONS`` lists each difference that is allowed, with its reason.
A second test holds that every public name of the JAX package's core
layer files is exported by ``bigdl_tpu_torch.nn``; the rest hold the
repaired behaviours (the quantized conv built from a conv, a dataset
that keeps its short last batch, the compressed step's auxiliary-loss
weight, ``evaluate``'s ``batch_to_device``, ``Metrics``' category).
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

PACKAGES = ("nn", "optim", "dataset", "serving", "parallel", "distributed")

_OWN_WEIGHTS = ("optional: the port's modules hold their own weights, so "
                "the variables default to the model's (export_variables)")
_JIT = "jit plumbing with no counterpart: the port's compiled calls are " \
       "CUDA graphs that update their trees in place"
_CAPTURE = ("the example tensors a CUDA-graph capture is made from (the "
            "JAX function traces at its first call)")

# "pkg.Name" -> {parameter: (kind, reason)}; kind is "missing" (JAX's
# parameter has no counterpart), "default" (another default), "renamed
# <port name>" (the port's counterpart, at the same place, with a
# default of its own), "keyword" (keyword-only in the port) or
# "inserted" (a port-only parameter placed before JAX's next one)
EXCEPTIONS = {
    "nn.quantize": {"variables": ("default", _OWN_WEIGHTS)},
    "nn.save_quantized": {"variables": ("default", _OWN_WEIGHTS)},
    "optim.PredictionService": {"variables": ("default", _OWN_WEIGHTS)},
    "serving.ServingEngine": {"variables": ("default", _OWN_WEIGHTS)},
    "serving.DecodeEngine": {"variables": ("default", _OWN_WEIGHTS)},
    "serving.ServingMetrics": {"base": (
        "missing", "the port's counters keep their own windows instead of "
                   "recording into an optim Metrics; window is "
                   "keyword-only")},
    "serving.build_prefill": {"ids": ("inserted", _CAPTURE),
                              "lengths": ("inserted", _CAPTURE)},
    "serving.build_spec_verify": {
        "cache": ("inserted", _CAPTURE),
        "paged": ("keyword", "after the capture's example tensors (*args)")},
    "parallel.build_dp_eval_step": {"template_variables": ("missing", _JIT)},
    "parallel.build_dp_train_step": {
        "donate": ("missing", _JIT),
        "template_variables": ("missing", _JIT)},
    "parallel.init_stacked_params": {"rng": (
        "renamed generator", "a torch.Generator stands for the JAX key, as "
                             "in every initialiser of the port")},
    "parallel.make_mesh": {"devices": (
        "renamed device", "JAX takes a device list; a torch.distributed "
                          "mesh spans the process group's ranks, one device "
                          "each, so the port takes their device type")},
    "distributed.build_compressed_dp_train_step": {
        "donate": ("missing", _JIT),
        "template_variables": ("missing", _JIT)},
    "distributed.build_reshard_step": {"donate": ("missing", _JIT)},
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _plain(v) -> bool:
    if isinstance(v, tuple):
        return all(_plain(e) for e in v)
    return v is None or isinstance(v, (bool, int, float, str))


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters.values() if p.kind not in _VAR]


def _shared():
    """``("pkg.Name", jax object, port object)`` for every callable
    both packages export."""
    out = []
    for pkg in PACKAGES:
        j = importlib.import_module(f"bigdl_tpu.{pkg}")
        t = importlib.import_module(f"bigdl_tpu_torch.{pkg}")
        for name in sorted(set(dir(j)) & set(dir(t))):
            a, b = getattr(j, name), getattr(t, name)
            if (name.startswith("_") or inspect.ismodule(a)
                    or not callable(a) or not callable(b)):
                continue
            if _params(a) is None or _params(b) is None:
                continue
            out.append((f"{pkg}.{name}", a, b))
    return out


def mismatches(key, jax_obj, port_obj):
    """The differences of ``port_obj``'s parameters from ``jax_obj``'s
    that ``EXCEPTIONS`` does not allow."""
    allowed = EXCEPTIONS.get(key, {})
    jp, tp = _params(jax_obj), _params(port_obj)
    tnames = {p.name: p for p in tp}
    errs = []
    rename = {n: k.split()[1] for n, (k, _) in allowed.items()
              if k.startswith("renamed")}
    missing = {n for n, (k, _) in allowed.items() if k == "missing"}
    keyword = {n for n, (k, _) in allowed.items() if k == "keyword"}
    inserted = {n for n, (k, _) in allowed.items() if k == "inserted"}
    jpos = [p.name for p in jp if p.kind in _POSITIONAL]
    tpos = [p.name for p in tp if p.kind in _POSITIONAL
            and p.name not in inserted]
    want = []
    for n in jpos:
        if n in missing | keyword:  # from here on: keywords only
            if len(tpos) > len(want):
                errs.append(f"positional {tpos[len(want):]} where JAX has "
                            f"{n!r}")
            break
        want.append(rename.get(n, n))
    if tpos[:len(want)] != want:
        errs.append(f"positional {tpos[:len(want)]} != JAX's {want}")
    for p in jp:
        if p.name in missing:
            continue
        q = tnames.get(rename.get(p.name, p.name))
        if q is None:
            errs.append(f"no parameter {p.name!r}")
            continue
        if allowed.get(p.name, ("",))[0].startswith(("default", "renamed")):
            continue
        jd, td = p.default, q.default
        if (jd is inspect.Parameter.empty) != (td is inspect.Parameter.empty):
            errs.append(f"{p.name}: default {td!r}, JAX's {jd!r}")
        elif _plain(jd) and _plain(td) and jd != td:
            errs.append(f"{p.name}: default {td!r}, JAX's {jd!r}")
    for n in allowed:
        if n not in {p.name for p in jp} | inserted:
            errs.append(f"exception for {n!r}, which JAX does not have")
    return errs


SHARED = _shared()


def test_shared_callables_found():
    keys = {k for k, _, _ in SHARED}
    assert len(keys) > 200
    assert {"nn.SpatialConvolution", "optim.make_train_step",
            "dataset.LocalArrayDataSet", "serving.ServingMetrics",
            "parallel.make_mesh",
            "distributed.build_compressed_dp_train_step"} <= keys
    assert set(EXCEPTIONS) <= keys


@pytest.mark.parametrize("pkg", PACKAGES)
def test_signatures_match_jax(pkg):
    bad = {key: errs for key, a, b in SHARED if key.startswith(pkg + ".")
           for errs in [mismatches(key, a, b)] if errs}
    assert not bad, bad


LAYER_FILES = ("init", "module", "activation", "conv", "pool", "reshape",
               "linear", "table_ops", "dropout", "norm", "embedding")


def jax_layer_names():
    """The names ``bigdl_tpu.nn`` exports whose objects the core layer
    files define (aliases included)."""
    import bigdl_tpu.nn as jnn

    mods = {f"bigdl_tpu.nn.{f}" for f in LAYER_FILES}
    return sorted(n for n in dir(jnn) if not n.startswith("_")
                  and getattr(getattr(jnn, n), "__module__", None) in mods)


def test_every_core_layer_name_is_exported():
    import bigdl_tpu.nn as jnn
    import bigdl_tpu_torch.nn as tnn

    names = jax_layer_names()
    assert len(names) >= 160
    assert [n for n in names if n not in tnn.__all__] == []
    for n in names:  # an alias stays an alias
        if getattr(jnn, n).__name__ != n:
            assert getattr(tnn, n) is getattr(tnn, getattr(jnn, n).__name__)


def test_every_new_class_has_a_parity_case():
    """Each layer class of the core files has a case against JAX
    (tests/torch_zoo_cases.py) or its own test (the initialisers, the
    BatchNorm, LayerNorm, Dropout, LookupTable and CAddTable of earlier
    slices)."""
    from torch_zoo_cases import classes

    own = {"InitializationMethod", "Zeros", "Ones", "ConstInitMethod",
           "RandomUniform", "RandomNormal", "Xavier", "MsraFiller",
           "BilinearFiller", "Module", "Container", "Sequential",
           "DynamicContainer", "BatchNormalization", "LayerNormalization",
           "Dropout", "LookupTable", "CAddTable", "SpaceToDepth", "Linear"}
    import bigdl_tpu.nn as jnn

    covered = set(classes()) | own
    missing = [n for n in jax_layer_names()
               if n not in covered and getattr(jnn, n).__name__ not in
               covered]
    assert missing == []


# ------------------------------------------------------------- repairs
def test_quantized_conv_is_built_from_a_conv():
    from bigdl_tpu import nn as jnn
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.utils import load_jax_variables

    import jax

    jc = jnn.SpatialConvolution(4, 6, 3, 1, "SAME", 2, True, 2)
    var = jax.tree_util.tree_map(np.asarray, jc.init(jax.random.PRNGKey(0)))
    for weight_only in (False, True):
        jm, jp = jnn.QuantizedSpatialConvolution.from_conv(
            jc, var["params"], weight_only)
        tc = tnn.SpatialConvolution(4, 6, 3, 1, "SAME", 2, True, 2)
        q = tnn.QuantizedSpatialConvolution(tc, weight_only)
        # the conv's geometry, not its weights
        assert isinstance(q.conv, tnn.SpatialConvolution)
        assert (q.conv.kernel_size, q.conv.dilation, q.conv.n_group,
                q.name) == (tc.kernel_size, tc.dilation, tc.n_group, tc.name)
        assert list(q.conv.parameters()) == [] and tc.weight is not None
        assert sorted(dict(q.named_parameters())) == ["bias", "scale",
                                                      "weight_q"]
        load_jax_variables(q, {"params": jax.tree_util.tree_map(
            np.asarray, jp)})
        x = np.random.RandomState(0).randn(2, 7, 6, 4).astype(np.float32)
        want = np.asarray(jm.apply(jp, {}, x)[0])
        got = q(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dataset_keeps_the_short_batch_without_drop_remainder():
    from bigdl_tpu.dataset import LocalArrayDataSet as J
    from bigdl_tpu_torch.dataset import LocalArrayDataSet as T

    x = np.arange(10, dtype=np.float32)[:, None]
    for drop in (True, False):
        t, j = T(x, x[:, 0], 4, drop_remainder=drop), J(
            x, x[:, 0], 4, drop_remainder=drop)
        assert t.batches_per_epoch() == j.batches_per_epoch() == (
            2 if drop else 3)
        got = [b.get_input()[:, 0].tolist() for b in t.data(train=False)]
        want = [b.get_input()[:, 0].tolist() for b in j.data(train=False)]
        assert got == want
        assert [len(b) for b in got] == ([4, 4] if drop else [4, 4, 2])
    stream = T(x, None, 4, drop_remainder=False).data(train=True)
    assert [len(next(stream).get_input()) for _ in range(4)] == [4, 4, 2, 4]


def test_compressed_step_weighs_the_auxiliary_loss():
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.distributed.compression import \
        build_compressed_dp_train_step
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel.mesh import data_parallel_mesh

    class WithAux(tnn.Module):
        """A Linear that leaves ``sum(w^2)`` in its ``aux_loss``."""

        def __init__(self):
            super().__init__()
            self.fc = tnn.Linear(4, 3)
            self.register_buffer("aux_loss", torch.zeros(()))

        def forward(self, x):
            buf = self.aux_loss  # as parallel/expert.py surfaces it
            buf.detach_()
            buf.copy_(torch.sum(self.fc.weight ** 2))
            return self.fc(x)

    mesh = data_parallel_mesh(device="cpu")
    x = torch.randn(8, 4)
    y = torch.randint(0, 3, (8,))
    losses = {}
    for w in (0.0, 0.5):
        torch.manual_seed(0)
        model = WithAux()
        step, _ = build_compressed_dp_train_step(
            model, tnn.ClassNLLCriterion(logits=True), {"__all__": SGD(0.1)},
            mesh, "bf16", None, None, w)
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = {k: b.detach().clone() for k, b in model.named_buffers()}
        aux = float(torch.sum(params["fc.weight"] ** 2))
        out = step(params, state, {"__all__": {}}, 1, None, x, y, [0.1])
        losses[w] = float(out[3])
    assert losses[0.5] == pytest.approx(losses[0.0] + 0.5 * aux, rel=1e-5)
    with pytest.raises(TypeError):  # JAX's donate has no place here
        build_compressed_dp_train_step(
            WithAux(), tnn.ClassNLLCriterion(logits=True),
            {"__all__": SGD(0.1)}, mesh, "bf16", None, None, 0.01, True)


def test_evaluate_batch_to_device_and_metrics_category():
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Metrics, Top1Accuracy, evaluate

    class Placed:
        """A dataset whose batches are tensors already."""

        def __init__(self, base):
            self.base = base

        def data(self, train):
            for b in self.base.data(train):
                b.features = torch.from_numpy(b.get_input())
                yield b

    model = tnn.Linear(3, 2)
    params = dict(model.named_parameters())
    ds = DataSet.from_arrays(np.ones((4, 3), np.float32),
                             np.zeros(4, np.int64), batch_size=2)
    (_, res), = evaluate(model, params, {}, ds, [Top1Accuracy()])
    (_, placed), = evaluate(model, params, {}, Placed(ds), [Top1Accuracy()],
                            False)
    assert res.result() == placed.result() and res.result()[1] == 4
    assert Metrics().category == "train"
    assert Metrics("serve").category == "serve"
