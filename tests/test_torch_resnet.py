"""The port's ResNet-50 against the JAX package's, from the same weights.

``ResNet50(class_num=10, stem="space_to_depth")`` at 32x32 input, batch
2, fused and unfused.  The JAX model's ``init`` gives the tree; every
leaf is redrawn in numpy with BatchNorm randomised (a zero closing gamma
would multiply each residual branch, and with it both kernels, by 0);
both sides get that tree.  Logits agree to f32 ``rtol=atol=1e-3``: 53
convolutions summed in the orders JAX's and PyTorch's CPU kernels
choose.
"""
import numpy as np
import pytest

import jax
import torch

from bigdl_tpu.models.resnet import ResNet50 as JaxResNet50
from bigdl_tpu_torch.models import ResNet50, fold_stem_to_s2d
from bigdl_tpu_torch.utils import (export_variables, flatten,
                                   load_jax_variables, random_variables)

TOL = dict(rtol=1e-3, atol=1e-3)


def _jax_template(model):
    """The JAX variable tree with shapes only (no weights drawn)."""
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


def _numpy_tree(template, seed):
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), template)
    return random_variables(zeros, seed)


@pytest.mark.parametrize("fused", [True, False])
def test_resnet50_logits_match_jax(fused):
    jmodel = JaxResNet50(10, stem="space_to_depth", fused=fused)
    variables = _numpy_tree(_jax_template(jmodel), seed=int(fused))
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    want, _ = jmodel.apply(variables["params"], variables["state"], x,
                           training=False)

    model = ResNet50(10, stem="space_to_depth", fused=fused, device="cpu")
    load_jax_variables(model, variables)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bench_model_keys_and_size():
    model = ResNet50(1000, stem="space_to_depth", fused=True, device="cpu")
    assert model.child_keys == (
        ["SpaceToDepth", "conv1", "SpatialBatchNormalization", "ReLU",
         "SpatialMaxPooling"]
        + [f"fused_s{s}b{b}" for s, n in enumerate((3, 4, 6, 3))
           for b in range(n)]
        + ["GlobalAveragePooling2D", "fc1000"])
    assert sum(p.numel() for p in model.parameters()) == 25_559_912


@pytest.mark.parametrize("fused", [True, False])
def test_variables_round_trip_with_the_jax_tree_shape(fused):
    template = _jax_template(JaxResNet50(10, stem="space_to_depth",
                                         fused=fused))
    variables = _numpy_tree(template, seed=3)
    model = ResNet50(10, stem="space_to_depth", fused=fused, device="cpu")
    out = load_jax_variables(model, variables)
    # same nesting, empty subtrees included, and the same leaves
    assert jax.tree_util.tree_structure(out) == \
        jax.tree_util.tree_structure(variables)
    for kind in ("params", "state"):
        a, b = flatten(out[kind]), flatten(variables[kind])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert jax.tree_util.tree_structure(export_variables(model)) == \
        jax.tree_util.tree_structure(variables)


def test_load_rejects_missing_extra_and_misshaped_leaves():
    model = ResNet50(10, stem="space_to_depth", fused=True, device="cpu")
    good = export_variables(model)
    before = model.fc1000.weight.detach().clone()

    missing = export_variables(model)
    del missing["state"]["fused_s0b0"]["bn1"]["running_var"]
    with pytest.raises(KeyError, match="running_var"):
        load_jax_variables(model, missing)

    extra = export_variables(model)
    extra["params"]["fc1000"]["scale"] = np.ones(10, np.float32)
    with pytest.raises(KeyError, match="scale"):
        load_jax_variables(model, extra)

    bad = export_variables(model)
    bad["params"]["fc1000"]["weight"] = np.zeros((2048, 11), np.float32)
    bad["params"]["conv1"]["weight"] = bad["params"]["conv1"]["weight"] + 1
    with pytest.raises(ValueError, match="fc1000.weight"):
        load_jax_variables(model, bad)
    # nothing was copied before the mismatch was found
    assert torch.equal(model.fc1000.weight, before)
    load_jax_variables(model, good)


def test_stem_fold_matches_the_conv7_stem():
    """A 7x7/s2 stem's weights folded for the space-to-depth stem give the
    same features (bigdl_tpu/models/resnet.py fold_stem_to_s2d)."""
    rs = np.random.RandomState(0)
    conv7 = ResNet50(10, stem="conv7", device="cpu")
    s2d = ResNet50(10, stem="space_to_depth", device="cpu")
    w7 = rs.randn(7, 7, 3, 64).astype(np.float32)
    with torch.no_grad():
        conv7.conv1.weight.copy_(torch.from_numpy(w7))
        s2d.conv1.weight.copy_(torch.from_numpy(fold_stem_to_s2d(w7)))
    x = torch.from_numpy(rs.randn(1, 32, 32, 3).astype(np.float32))
    with torch.inference_mode():
        a = conv7.conv1(x)
        b = s2d.conv1(s2d.SpaceToDepth(x))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(10, stem="space_to_depth", fused=True)
