"""The layer cases of the zoo slice: one or more per class of the JAX
package's core layer files (activation, conv, pool, reshape, linear,
table ops, dropout, norm, embedding, module), at test size.

Each case names a class (``"Name"`` or ``"Name/variant"``), builds it
from either package's ``nn`` (``build(nn)``: the two take the same
arguments) and makes its input from a seeded ``numpy`` RandomState
(``inputs(rs)``): an array, a tuple of activities, or a :class:`Tab` (a
``Table`` of each package).  Integer and boolean arrays are data, never
differentiated.  This module imports neither JAX nor torch:
tests/torch_zoo_harness.py holds the cases against the JAX package on
the CPU, and chip_smoke.py's phase 17 runs them on the card against the
CPU.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class Tab(list):
    """A table activity: its entries go under the keys 1, 2, ... of the
    package's ``Table``."""


class Case(NamedTuple):
    group: str             # test file: conv, pool_norm, activation, ...
    build: Callable        # build(nn) -> module
    inputs: Callable       # inputs(rs) -> activity
    train: bool = False    # also held in training mode (its new state)
    bf16: bool = True      # also held with bf16 inputs
    tol: float = 1e-5      # f32 rtol and atol (of the largest |value|)
    random: bool = False   # draws in training: held in eval mode only


def f32(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype(np.float32)


def pos(rs, *shape):
    return rs.uniform(0.5, 2.0, shape).astype(np.float32)


def _x(*shape, scale=1.0):
    return lambda rs: f32(rs, *shape, scale=scale)


def _xs(*shapes):
    return lambda rs: tuple(f32(rs, *s) for s in shapes)


def _masked(rs):
    x = f32(rs, 2, 5, 3)
    x[0, 1] = 0.0
    x[1, 3] = 0.0
    return x


def _index(rs):
    return (f32(rs, 3, 5, 2), rs.randint(0, 5, (2, 3)).astype(np.int32))


def _conn_matrix(c_in, c_out, seed=5):
    m = (np.random.RandomState(seed).rand(c_in, c_out) > 0.5)
    m[0, 0] = True
    return m.astype(np.float32)


CASES = {}


def _add(group, name, build, inputs, **kw):
    assert name not in CASES, name
    CASES[name] = Case(group, build, inputs, **kw)


# ---------------------------------------------------------- activations
for _name, _args, _inp in [
        ("ReLU", (), _x(2, 3, 4)), ("ReLU6", (), _x(2, 3, 4, scale=4.0)),
        ("Tanh", (), _x(2, 3, 4)), ("Sigmoid", (), _x(2, 3, 4)),
        ("HardSigmoid", (), _x(2, 3, 4, scale=3.0)),
        ("HardTanh", (-0.5, 0.8), _x(2, 3, 4)), ("ELU", (0.7,), _x(2, 3, 4)),
        ("SELU", (), _x(2, 3, 4)), ("GELU", (), _x(2, 3, 4)),
        ("Swish", (), _x(2, 3, 4)), ("Mish", (), _x(2, 3, 4)),
        ("SoftPlus", (2.0,), _x(2, 3, 4)), ("SoftSign", (), _x(2, 3, 4)),
        ("LeakyReLU", (0.1,), _x(2, 3, 4)), ("PReLU", (4,), _x(2, 3, 4)),
        ("RReLU", (), _x(2, 3, 4)), ("Threshold", (0.1, -2.0), _x(2, 3, 4)),
        ("SoftMax", (1,), _x(2, 5, 3)), ("LogSoftMax", (), _x(2, 3, 5)),
        ("SoftMin", (), _x(2, 3, 5)),
        ("Power", (2.5, 0.5, 3.0), _x(2, 3, 4)),
        ("Square", (), _x(2, 3, 4)), ("Sqrt", (), lambda rs: pos(rs, 2, 3, 4)),
        ("Log", (), lambda rs: pos(rs, 2, 3, 4)), ("Exp", (), _x(2, 3, 4)),
        ("Abs", (), _x(2, 3, 4)), ("Clamp", (-0.3, 0.4), _x(2, 3, 4)),
        ("Negative", (), _x(2, 3, 4)), ("HardShrink", (0.3,), _x(2, 3, 4)),
        ("SoftShrink", (0.3,), _x(2, 3, 4)), ("TanhShrink", (), _x(2, 3, 4)),
        ("LogSigmoid", (), _x(2, 3, 4)),
        ("BinaryThreshold", (0.1,), _x(2, 3, 4)),
        ("SReLU", ((3, 4), [1]), _x(2, 3, 4)), ("Scale", ((3, 4),), _x(2, 3, 4))]:
    _add("activation", _name,
         (lambda n, a: lambda nn: getattr(nn, n)(*a))(_name, _args), _inp,
         random=_name == "RReLU")
_add("activation", "Tanh/table", lambda nn: nn.Tanh(),
     lambda rs: (f32(rs, 2, 3), Tab([f32(rs, 4), f32(rs, 2, 2)])))

# ----------------------------------------------------------------- conv
_add("conv", "SpatialConvolution",
     lambda nn: nn.SpatialConvolution(4, 6, 3, 2, "SAME", 2, True, 2),
     _x(2, 9, 8, 4))
_add("conv", "SpatialConvolution/dilated_same_even",
     lambda nn: nn.SpatialConvolution(3, 4, 3, 1, "SAME", dilation=(2, 3)),
     _x(2, 8, 10, 3))
_add("conv", "SpatialConvolution/groups_explicit",
     lambda nn: nn.SpatialConvolution(6, 9, (3, 2), (1, 2), ((1, 2), (0, 1)),
                                      3, False),
     _x(2, 7, 8, 6))
_add("conv", "SpatialShareConvolution",
     lambda nn: nn.SpatialShareConvolution(3, 4, 3, 1, 1), _x(2, 6, 5, 3))
_add("conv", "SpatialDilatedConvolution",
     lambda nn: nn.SpatialDilatedConvolution(3, 4, 3, 1, "SAME", 2),
     _x(2, 7, 8, 3))
_add("conv", "SpatialFullConvolution",
     lambda nn: nn.SpatialFullConvolution(3, 4, 3, 2, 1, 1), _x(2, 5, 4, 3))
_add("conv", "SpatialFullConvolution/k4_s2_p1",
     lambda nn: nn.SpatialFullConvolution(2, 3, (4, 3), (2, 1), (1, 0), 0,
                                          False),
     _x(2, 4, 5, 2))
_add("conv", "SpatialSeparableConvolution",
     lambda nn: nn.SpatialSeparableConvolution(3, 5, 2, 3, 1, "SAME"),
     _x(2, 6, 7, 3))
_add("conv", "TemporalConvolution",
     lambda nn: nn.TemporalConvolution(4, 5, 3, 2, "SAME"), _x(2, 9, 4))
_add("conv", "TemporalConvolution/int_pad",
     lambda nn: nn.TemporalConvolution(4, 3, 3, 1, 1, False), _x(2, 7, 4))
_add("conv", "VolumetricConvolution",
     lambda nn: nn.VolumetricConvolution(3, 4, (2, 3, 3), (1, 2, 1), 1),
     _x(2, 4, 5, 4, 3))
_add("conv", "VolumetricConvolution/same",
     lambda nn: nn.VolumetricConvolution(2, 3, 3, 2, "SAME"), _x(1, 4, 5, 5, 2))
_add("conv", "VolumetricFullConvolution",
     lambda nn: nn.VolumetricFullConvolution(3, 2, 3, 2, 1, 1),
     _x(1, 3, 4, 3, 3))
_add("conv", "UpSampling1D", lambda nn: nn.UpSampling1D(3), _x(2, 4, 3))
_add("conv", "UpSampling2D", lambda nn: nn.UpSampling2D((2, 3)),
     _x(2, 3, 4, 2))
_add("conv", "UpSampling3D", lambda nn: nn.UpSampling3D((1, 2, 2)),
     _x(1, 2, 3, 3, 2))
_add("conv", "ResizeBilinear", lambda nn: nn.ResizeBilinear(7, 5),
     _x(2, 4, 9, 3))
_add("conv", "ResizeBilinear/align_corners",
     lambda nn: nn.ResizeBilinear(7, 3, align_corners=True), _x(2, 4, 6, 3))
_add("conv", "ResizeBilinear/legacy_asymmetric",
     lambda nn: nn.ResizeBilinear(5, 8, half_pixel_centers=False),
     _x(2, 4, 6, 3))
_add("conv", "SpatialZeroPadding",
     lambda nn: nn.SpatialZeroPadding(1, 2, 0, 3), _x(2, 3, 4, 2))
_add("conv", "Cropping2D", lambda nn: nn.Cropping2D(1, 0, 1, 2),
     _x(2, 5, 6, 3))
_add("conv", "Cropping3D",
     lambda nn: nn.Cropping3D((1, 0), (0, 1), (1, 1)), _x(1, 4, 5, 6, 2))
_add("conv", "LocallyConnected1D",
     lambda nn: nn.LocallyConnected1D(7, 3, 4, 3, 2), _x(2, 7, 3))
_add("conv", "LocallyConnected2D",
     lambda nn: nn.LocallyConnected2D(3, 6, 5, 4, 3, 2, 2, 1, 1, 0),
     _x(2, 5, 6, 3))
_add("conv", "SpatialConvolutionMap",
     lambda nn: nn.SpatialConvolutionMap(
         [(0, 0), (1, 0), (1, 1), (2, 1), (2, 2)], 3, 3, 3, 2, 1, "SAME"),
     _x(2, 6, 5, 3))
_add("conv", "SpatialConvolutionMap/matrix",
     lambda nn: nn.SpatialConvolutionMap(_conn_matrix(3, 2), 3, 2, 3),
     _x(2, 6, 5, 3))
_add("conv", "SpatialConvolutionMap/pair_array",
     lambda nn: nn.SpatialConvolutionMap(
         np.array([[0, 1], [2, 0], [1, 1]]), 3, 2, 2, stride=2),
     _x(2, 6, 5, 3))

# ----------------------------------------------------------------- pool
_add("pool_norm", "SpatialMaxPooling",
     lambda nn: nn.SpatialMaxPooling(3, 2, 1, True), _x(2, 8, 7, 3))
_add("pool_norm", "SpatialMaxPooling/pad_over_half",
     lambda nn: nn.SpatialMaxPooling(3, 1, 2), _x(2, 5, 4, 2))
_add("pool_norm", "SpatialMaxPooling/same",
     lambda nn: nn.SpatialMaxPooling(3, 2, "SAME"), _x(2, 8, 9, 2))
_add("pool_norm", "SpatialAveragePooling",
     lambda nn: nn.SpatialAveragePooling(3, 2, 1, True, True),
     _x(2, 8, 7, 3))
_add("pool_norm", "SpatialAveragePooling/exclude_pad",
     lambda nn: nn.SpatialAveragePooling(3, 2, 1, True, False),
     _x(2, 8, 7, 3))
_add("pool_norm", "SpatialAveragePooling/same",
     lambda nn: nn.SpatialAveragePooling(2, 2, "SAME"), _x(2, 7, 8, 3))
_add("pool_norm", "TemporalMaxPooling", lambda nn: nn.TemporalMaxPooling(3, 2),
     _x(2, 9, 4))
_add("pool_norm", "VolumetricMaxPooling",
     lambda nn: nn.VolumetricMaxPooling((2, 2, 1), (1, 2, 1)),
     _x(1, 4, 5, 4, 2))
_add("pool_norm", "VolumetricAveragePooling",
     lambda nn: nn.VolumetricAveragePooling(2), _x(1, 4, 4, 5, 2))
_add("pool_norm", "GlobalAveragePooling2D",
     lambda nn: nn.GlobalAveragePooling2D(True), _x(2, 3, 4, 5))
_add("pool_norm", "GlobalMaxPooling2D",
     lambda nn: nn.GlobalMaxPooling2D(), _x(2, 3, 4, 5))
_add("pool_norm", "SpatialAdaptiveMaxPooling",
     lambda nn: nn.SpatialAdaptiveMaxPooling(2, 3), _x(2, 5, 7, 3))
_add("pool_norm", "SpatialAdaptiveMaxPooling/divisible",
     lambda nn: nn.SpatialAdaptiveMaxPooling(2, 3), _x(2, 4, 6, 3))

# ----------------------------------------------------------------- norm
_add("pool_norm", "SpatialBatchNormalization",
     lambda nn: nn.SpatialBatchNormalization(3), _x(2, 3, 4, 3), train=True)
_add("pool_norm", "VolumetricBatchNormalization",
     lambda nn: nn.VolumetricBatchNormalization(3), _x(2, 3, 3, 2, 3),
     train=True)
_add("pool_norm", "RMSNorm", lambda nn: nn.RMSNorm(5), _x(2, 3, 5))
_add("pool_norm", "GroupNorm", lambda nn: nn.GroupNorm(2, 4),
     _x(2, 3, 3, 4))
_add("pool_norm", "SpatialCrossMapLRN",
     lambda nn: nn.SpatialCrossMapLRN(3, 0.5, 0.75, 2.0), _x(2, 3, 3, 5))
_add("pool_norm", "Normalize", lambda nn: nn.Normalize(), _x(3, 5))
_add("pool_norm", "Normalize/p3", lambda nn: nn.Normalize(3.0), _x(3, 5))
_add("pool_norm", "NormalizeScale", lambda nn: nn.NormalizeScale(4, 10.0),
     _x(2, 3, 3, 4))
_add("pool_norm", "SpatialSubtractiveNormalization",
     lambda nn: nn.SpatialSubtractiveNormalization(3, [1.0, 2.0, 1.0]),
     _x(2, 6, 5, 3))
_add("pool_norm", "SpatialDivisiveNormalization",
     lambda nn: nn.SpatialDivisiveNormalization(
         3, np.arange(1.0, 10.0).reshape(3, 3)), _x(2, 6, 5, 3))
_add("pool_norm", "SpatialContrastiveNormalization",
     lambda nn: nn.SpatialContrastiveNormalization(
         3, [1.0, 2.0, 3.0, 2.0, 1.0]), _x(2, 6, 5, 3))
_add("pool_norm", "SpatialWithinChannelLRN",
     lambda nn: nn.SpatialWithinChannelLRN(3, 0.5, 0.75), _x(2, 5, 4, 3))

# -------------------------------------------------------------- reshape
for _name, _build, _inp in [
        ("DepthToSpace", lambda nn: nn.DepthToSpace(2), _x(2, 3, 2, 8)),
        ("Reshape", lambda nn: nn.Reshape((6, 2)), _x(2, 3, 4)),
        ("Reshape/no_batch", lambda nn: nn.Reshape((4, -1), False),
         _x(2, 3, 4)),
        ("View", lambda nn: nn.View((4, 3)), _x(2, 3, 4)),
        ("InferReshape", lambda nn: nn.InferReshape((-1, 3)), _x(2, 3, 4)),
        ("Flatten", lambda nn: nn.Flatten(), _x(2, 3, 4, 5)),
        ("Squeeze", lambda nn: nn.Squeeze(1), _x(2, 1, 3)),
        ("Squeeze/all", lambda nn: nn.Squeeze(), _x(2, 1, 3, 1)),
        ("Unsqueeze", lambda nn: nn.Unsqueeze(1), _x(2, 3)),
        ("Transpose", lambda nn: nn.Transpose([(0, 2), (1, 2)]),
         _x(2, 3, 4)),
        ("Permute", lambda nn: nn.Permute((2, 0, 1)), _x(2, 3, 4, 5)),
        ("Select", lambda nn: nn.Select(1, 2), _x(2, 4, 3)),
        ("Narrow", lambda nn: nn.Narrow(1, 1, -2), _x(2, 6, 3)),
        ("Replicate", lambda nn: nn.Replicate(3, 1), _x(2, 4)),
        ("Padding", lambda nn: nn.Padding(1, -2, 0.5), _x(2, 3, 4)),
        ("Contiguous", lambda nn: nn.Contiguous(), _x(2, 3)),
        ("MulConstant", lambda nn: nn.MulConstant(0.7), _x(2, 3)),
        ("AddConstant", lambda nn: nn.AddConstant(-0.3), _x(2, 3)),
        ("Sum", lambda nn: nn.Sum(1, False), _x(2, 3, 4)),
        ("Mean", lambda nn: nn.Mean(2, True), _x(2, 3, 4)),
        ("Max", lambda nn: nn.Max(1), _x(2, 3, 4)),
        ("Min", lambda nn: nn.Min(2), _x(2, 3, 4)),
        ("ZeroPaddingND",
         lambda nn: nn.ZeroPaddingND([(0, 0), (1, 2), (0, 1)], 0.25),
         _x(2, 3, 4)),
        ("Tile", lambda nn: nn.Tile(1, 3), _x(2, 3)),
        ("Reverse", lambda nn: nn.Reverse(2), _x(2, 3, 4)),
        ("ExpandSize", lambda nn: nn.ExpandSize((-1, 3, 4)), _x(2, 1, 4))]:
    _add("reshape_table", _name, _build, _inp)

# ---------------------------------------------------------------- table
_add("reshape_table", "Concat",
     lambda nn: nn.Concat(1, nn.Linear(4, 3), nn.Tanh()), _x(2, 4))
_add("reshape_table", "ConcatTable",
     lambda nn: nn.ConcatTable(nn.Linear(4, 3), nn.Identity()), _x(2, 4))
_add("reshape_table", "ParallelTable",
     lambda nn: nn.ParallelTable(nn.Linear(4, 3), nn.Tanh()),
     _xs((2, 4), (2, 5)))
_add("reshape_table", "MapTable", lambda nn: nn.MapTable(nn.Linear(4, 3)),
     lambda rs: Tab([f32(rs, 2, 4) for _ in range(3)]))
for _name in ("CMulTable", "CSubTable", "CMaxTable", "CMinTable",
              "CAveTable"):
    _add("reshape_table", _name,
         (lambda n: lambda nn: getattr(nn, n)())(_name),
         _xs((2, 3), (2, 3), (2, 3)))
_add("reshape_table", "CDivTable", lambda nn: nn.CDivTable(),
     lambda rs: (f32(rs, 2, 3), pos(rs, 2, 3)))
_add("reshape_table", "JoinTable", lambda nn: nn.JoinTable(1),
     _xs((2, 3), (2, 4)))
_add("reshape_table", "SelectTable", lambda nn: nn.SelectTable(1),
     lambda rs: Tab([f32(rs, 2, 3), f32(rs, 2, 4)]))
_add("reshape_table", "NarrowTable", lambda nn: nn.NarrowTable(1, 2),
     _xs((2, 3), (2, 4), (3,), (1, 2)))
_add("reshape_table", "FlattenTable", lambda nn: nn.FlattenTable(),
     lambda rs: ((f32(rs, 2), (f32(rs, 3), f32(rs, 1, 2))), f32(rs, 4)))
_add("reshape_table", "SplitTable", lambda nn: nn.SplitTable(1),
     _x(2, 3, 4))
_add("reshape_table", "DotProduct", lambda nn: nn.DotProduct(),
     _xs((3, 4), (3, 4)))
_add("reshape_table", "CosineDistance", lambda nn: nn.CosineDistance(),
     _xs((3, 4), (3, 4)))
_add("reshape_table", "MM", lambda nn: nn.MM(True, False),
     _xs((2, 4, 3), (2, 4, 5)))
_add("reshape_table", "MV", lambda nn: nn.MV(True), _xs((2, 4, 3), (2, 4)))
_add("reshape_table", "MixtureTable", lambda nn: nn.MixtureTable(),
     lambda rs: (f32(rs, 2, 3), tuple(f32(rs, 2, 4) for _ in range(3))))
_add("reshape_table", "MixtureTable/tensor_experts",
     lambda nn: nn.MixtureTable(), _xs((2, 3), (2, 3, 4)))
_add("reshape_table", "BifurcateSplitTable",
     lambda nn: nn.BifurcateSplitTable(1), _x(2, 5, 3))
_add("reshape_table", "Index", lambda nn: nn.Index(1), _index)
_add("reshape_table", "Pack", lambda nn: nn.Pack(1),
     _xs((2, 4), (2, 4), (2, 4)))
_add("reshape_table", "CrossProduct", lambda nn: nn.CrossProduct(3, 4),
     _xs((2, 4), (2, 4), (2, 4)))
_add("reshape_table", "MaskedSelect", lambda nn: nn.MaskedSelect(),
     lambda rs: (f32(rs, 3, 4), rs.rand(3, 4) > 0.5), bf16=False)
_add("reshape_table", "MaskedSelect/pad_to",
     lambda nn: nn.MaskedSelect(16, -1.0),
     lambda rs: (f32(rs, 3, 4), rs.rand(3, 4) > 0.5))
_add("reshape_table", "PairwiseDistance", lambda nn: nn.PairwiseDistance(),
     _xs((3, 4), (3, 4)))
_add("reshape_table", "PairwiseDistance/p1",
     lambda nn: nn.PairwiseDistance(1), _xs((3, 4), (3, 4)))
_add("reshape_table", "PairwiseDistance/p3",
     lambda nn: nn.PairwiseDistance(3), _xs((3, 4), (3, 4)))
_add("reshape_table", "TableOperation",
     lambda nn: nn.TableOperation(nn.CMulTable()),
     _xs((2, 3, 4), (1, 3, 4)))
_add("reshape_table", "Bottle", lambda nn: nn.Bottle(nn.Linear(4, 3), 2),
     _x(2, 3, 5, 4))

# --------------------------------------------------------------- linear
_add("linear_dropout_init", "Linear/no_bias",
     lambda nn: nn.Linear(5, 4, False), _x(3, 5))
_add("linear_dropout_init", "Bilinear", lambda nn: nn.Bilinear(3, 4, 2),
     _xs((5, 3), (5, 4)))
_add("linear_dropout_init", "Bilinear/table",
     lambda nn: nn.Bilinear(3, 4, 2, False),
     lambda rs: Tab([f32(rs, 5, 3), f32(rs, 5, 4)]))
_add("linear_dropout_init", "Euclidean", lambda nn: nn.Euclidean(4, 3),
     _x(5, 4))
_add("linear_dropout_init", "Cosine", lambda nn: nn.Cosine(4, 3), _x(5, 4))
_add("linear_dropout_init", "Maxout", lambda nn: nn.Maxout(4, 3, 2),
     _x(5, 4))
_add("linear_dropout_init", "Highway",
     lambda nn: nn.Highway(4, True, nn.Tanh()), _x(5, 4))
_add("linear_dropout_init", "CMul", lambda nn: nn.CMul((1, 4)), _x(3, 4))
_add("linear_dropout_init", "CAdd", lambda nn: nn.CAdd((3, 1)),
     _x(2, 3, 4))
_add("linear_dropout_init", "Mul", lambda nn: nn.Mul(), _x(3, 4))
_add("linear_dropout_init", "Add", lambda nn: nn.Add(4), _x(3, 4))
_add("linear_dropout_init", "Embedding", lambda nn: nn.Embedding(10, 4),
     lambda rs: rs.randint(0, 10, (2, 3)).astype(np.int32))
_add("linear_dropout_init", "Identity", lambda nn: nn.Identity(), _x(2, 3))
_add("linear_dropout_init", "Echo", lambda nn: nn.Echo(), _x(2, 3))

# -------------------------------------------------------------- dropout
for _name, _build in [
        ("SpatialDropout1D", lambda nn: nn.SpatialDropout1D(0.4)),
        ("SpatialDropout2D", lambda nn: nn.SpatialDropout2D(0.4)),
        ("SpatialDropout3D", lambda nn: nn.SpatialDropout3D(0.4)),
        ("GaussianDropout", lambda nn: nn.GaussianDropout(0.3)),
        ("GaussianNoise", lambda nn: nn.GaussianNoise(0.2))]:
    _add("linear_dropout_init", _name, _build,
         {"SpatialDropout1D": _x(2, 5, 3),
          "SpatialDropout3D": _x(2, 2, 3, 2, 3)}.get(_name, _x(2, 3, 4, 3)),
         random=True)
_add("linear_dropout_init", "Masking", lambda nn: nn.Masking(0.0), _masked)
_add("linear_dropout_init", "GaussianSampler",
     lambda nn: nn.GaussianSampler(), _xs((3, 4), (3, 4)), random=True)


def leaves(act):
    """The arrays of an activity, depth first."""
    if isinstance(act, (tuple, list)):
        return [a for v in act for a in leaves(v)]
    return [act]


def build(act, values, table, tensor):
    """``act``'s structure over ``values`` (consumed in order): a Tab
    becomes ``table(*entries)``, a tuple a tuple, an array
    ``tensor(value)``."""
    if isinstance(act, Tab):
        return table(*[build(v, values, table, tensor) for v in act])
    if isinstance(act, (tuple, list)):
        return tuple(build(v, values, table, tensor) for v in act)
    return tensor(values.pop(0))


def out_leaves(out):
    """The tensors of a module's output (a tensor, a tuple, a dict read
    in key order), depth first."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in out_leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for v in out for a in out_leaves(v)]
    return [out]


def is_float(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def classes():
    """The class names the cases cover."""
    return sorted({name.split("/")[0] for name in CASES})


def group(name: str):
    return sorted(k for k, c in CASES.items() if c.group == name)
