"""ResNet for ImageNet (counterpart of bigdl_tpu/models/resnet.py:82-202).

The graph is built node for node as the JAX builder builds it, so the
child keys, and with them the ``state_dict`` keys, equal the JAX pytree's
paths.  ``fused=True`` builds each bottleneck as one
:class:`~bigdl_tpu_torch.nn.FusedBottleneck`, which runs on the port's
two Hopper kernels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import MsraFiller, Zeros

__all__ = ["ResNet", "ResNet50", "fold_stem_to_s2d", "unfold_stem_from_s2d"]


def _conv(n_in, n_out, k, stride=1, name=None):
    # no bias: every conv is followed by BN
    return nn.SpatialConvolution(n_in, n_out, k, stride, padding="SAME",
                                 with_bias=False, weight_init=MsraFiller(),
                                 name=name)


def _bn(n, zero_gamma=False, name=None):
    return nn.SpatialBatchNormalization(
        n, eps=1e-5, momentum=0.1,
        weight_init=Zeros() if zero_gamma else None, name=name)


def basic_block(x, n_in, n_out, stride):
    """2x conv3x3 residual block (ResNet-18/34), unfused."""
    y = _conv(n_in, n_out, 3, stride).inputs(x)
    y = _bn(n_out).inputs(y)
    y = nn.ReLU().inputs(y)
    y = _conv(n_out, n_out, 3, 1).inputs(y)
    y = _bn(n_out, zero_gamma=True).inputs(y)
    if stride != 1 or n_in != n_out:
        sc = _bn(n_out).inputs(_conv(n_in, n_out, 1, stride).inputs(x))
    else:
        sc = x
    return nn.ReLU().inputs(nn.CAddTable().inputs(y, sc))


def bottleneck_block(x, n_in, planes, stride, expansion=4):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50/101/152), unfused."""
    n_out = planes * expansion
    y = _conv(n_in, planes, 1, 1).inputs(x)
    y = _bn(planes).inputs(y)
    y = nn.ReLU().inputs(y)
    y = _conv(planes, planes, 3, stride).inputs(y)
    y = _bn(planes).inputs(y)
    y = nn.ReLU().inputs(y)
    y = _conv(planes, n_out, 1, 1).inputs(y)
    y = _bn(n_out, zero_gamma=True).inputs(y)
    if stride != 1 or n_in != n_out:
        sc = _bn(n_out).inputs(_conv(n_in, n_out, 1, stride).inputs(x))
    else:
        sc = x
    return nn.ReLU().inputs(nn.CAddTable().inputs(y, sc))


_IMAGENET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def ResNet(class_num: int = 1000, depth: int = 50,
           dataset: str = "imagenet", stem: str = "conv7",
           fused: bool = False, device: DeviceLike = None,
           generator: Optional[torch.Generator] = None,
           remat: bool = True) -> nn.Graph:
    """Build ResNet-``depth`` for ImageNet in eval mode on ``device``
    (default: the card; ``device="cpu"`` for the CPU).

    ``stem="space_to_depth"`` is the 2x2 space-to-depth + 4x4/s1 conv
    with ``(1, 2)`` pads, the same function as the 7x7/s2 stem
    (:func:`fold_stem_to_s2d`).  ``fused=True`` builds each bottleneck as
    a :class:`~bigdl_tpu_torch.nn.FusedBottleneck`, whose training
    forward is recomputed in the backward when ``remat`` (the JAX
    package's default).  Call ``.train()`` to train.  Weights are drawn
    from ``generator`` (a CPU ``torch.Generator``); load trained or JAX
    weights with :func:`bigdl_tpu_torch.utils.load_jax_variables`.
    """
    device = resolve_device(device)
    if dataset != "imagenet":
        raise NotImplementedError(
            f"dataset={dataset!r} is not ported yet (imagenet only)")
    if stem not in ("conv7", "space_to_depth"):
        raise ValueError(f"unknown stem {stem!r}; "
                         "expected 'conv7' or 'space_to_depth'")
    kind, counts = _IMAGENET_CFG[depth]
    if fused and kind != "bottleneck":
        raise NotImplementedError("FusedBasicBlock is not ported yet")
    block = basic_block if kind == "basic" else bottleneck_block
    expansion = 1 if kind == "basic" else 4

    inp = nn.Input()
    if stem == "space_to_depth":
        x = nn.SpaceToDepth(2).inputs(inp)
        x = nn.SpatialConvolution(
            12, 64, 4, 1, padding=((1, 2), (1, 2)), with_bias=False,
            weight_init=MsraFiller(), name="conv1").inputs(x)
    else:
        x = _conv(3, 64, 7, 2, name="conv1").inputs(inp)
    x = _bn(64).inputs(x)
    x = nn.ReLU().inputs(x)
    x = nn.SpatialMaxPooling(3, 2, padding="SAME").inputs(x)
    n_in = 64
    for stage, n_blocks in enumerate(counts):
        planes = 64 * (2 ** stage)
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            if fused:
                x = nn.FusedBottleneck(n_in, planes, stride,
                                       name=f"fused_s{stage}b{b}",
                                       remat=remat).inputs(x)
            else:
                x = block(x, n_in, planes, stride)
            n_in = planes * expansion
    x = nn.GlobalAveragePooling2D().inputs(x)
    x = nn.Linear(n_in, class_num, name="fc1000").inputs(x)
    model = nn.Graph([inp], [x], name=f"resnet{depth}")
    if generator is not None:
        model.initialize(generator)
    return model.to(device).eval()


def ResNet50(class_num: int = 1000, stem: str = "conv7",
             fused: bool = False, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None,
             remat: bool = True) -> nn.Graph:
    """The bench model's network (bigdl_tpu/models/resnet.py:198)."""
    return ResNet(class_num, 50, "imagenet", stem, fused, device, generator,
                  remat)


def fold_stem_to_s2d(w7):
    """(7,7,C,O) conv1 weights -> the exactly-equivalent (4,4,4C,O)
    weights for the ``stem='space_to_depth'`` variant."""
    w7 = np.asarray(w7)
    c, o = w7.shape[2], w7.shape[3]
    w8 = np.zeros((8, 8, c, o), w7.dtype)
    w8[:7, :7] = w7
    return np.ascontiguousarray(
        w8.reshape(4, 2, 4, 2, c, o).transpose(0, 2, 1, 3, 4, 5)
        .reshape(4, 4, 4 * c, o))


def unfold_stem_from_s2d(w4):
    """Inverse of :func:`fold_stem_to_s2d`."""
    w4 = np.asarray(w4)
    c, o = w4.shape[2] // 4, w4.shape[3]
    w8 = (w4.reshape(4, 4, 2, 2, c, o).transpose(0, 2, 1, 3, 4, 5)
          .reshape(8, 8, c, o))
    return np.ascontiguousarray(w8[:7, :7])
