"""ResNet for ImageNet and CIFAR-10 (counterpart of
bigdl_tpu/models/resnet.py:82-202).

The graph is built node for node as the JAX builder builds it, so the
child keys, and with them the ``state_dict`` keys, equal the JAX pytree's
paths.  ``fused=True`` builds each residual block as one
:class:`~bigdl_tpu_torch.nn.FusedBottleneck` or
:class:`~bigdl_tpu_torch.nn.FusedBasicBlock`, which run on the port's
Hopper kernels 1-5; :func:`fuse_resnet_params` and
:func:`unfuse_resnet_params` carry weights between the two forms.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import MsraFiller, Zeros

__all__ = ["ResNet", "ResNet50", "fold_stem_to_s2d", "fuse_resnet_params",
           "unfold_stem_from_s2d", "unfuse_resnet_params"]


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
    """2x conv3x3 residual block (ResNet-18/34 and CIFAR), unfused."""
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
    """Build ResNet-``depth`` in eval mode on ``device`` (default: the
    card; ``device="cpu"`` for the CPU).

    ``dataset="imagenet"``: depth 18/34/50/101/152 on 224x224 inputs.
    ``dataset="cifar10"``: depth ``6n + 2`` (20/32/44/56/110), a 3x3 stem
    and three stages of n basic blocks of 16/32/64 channels on 32x32
    inputs, the classifier named ``fc``.

    ``stem="space_to_depth"`` is the 2x2 space-to-depth + 4x4/s1 conv
    with ``(1, 2)`` pads, the same function as the 7x7/s2 stem
    (:func:`fold_stem_to_s2d`).  ``fused=True`` builds each residual
    block as a :class:`~bigdl_tpu_torch.nn.FusedBottleneck` (depths 50,
    101, 152) or a :class:`~bigdl_tpu_torch.nn.FusedBasicBlock` (18, 34
    and CIFAR), named ``fused_s{stage}b{block}``, whose training forward
    is recomputed in the backward when ``remat`` (the JAX package's
    default).  Call ``.train()`` to train.  Weights are drawn
    from ``generator`` (a CPU ``torch.Generator``); load trained or JAX
    weights with :func:`bigdl_tpu_torch.utils.load_jax_variables`.
    """
    device = resolve_device(device)
    if stem not in ("conv7", "space_to_depth"):
        raise ValueError(f"unknown stem {stem!r}; "
                         "expected 'conv7' or 'space_to_depth'")
    if dataset == "imagenet":
        kind, counts = _IMAGENET_CFG[depth]
    elif dataset == "cifar10":
        if stem != "conv7":
            raise ValueError("stem='space_to_depth' applies to the "
                             "imagenet 7x7 stem only")
        if (depth - 2) % 6:
            raise ValueError(f"cifar ResNet depth must be 6n+2; got {depth}")
        kind = "basic"
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    inp = nn.Input()
    if dataset == "cifar10":
        n = (depth - 2) // 6
        x = _conv(3, 16, 3, 1).inputs(inp)
        x = _bn(16).inputs(x)
        x = nn.ReLU().inputs(x)
        n_in = 16
        for stage in range(3):
            planes = 16 * (2 ** stage)
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                if fused:
                    x = nn.FusedBasicBlock(n_in, planes, stride,
                                           name=f"fused_s{stage}b{b}",
                                           remat=remat).inputs(x)
                else:
                    x = basic_block(x, n_in, planes, stride)
                n_in = planes
        x = nn.GlobalAveragePooling2D().inputs(x)
        x = nn.Linear(n_in, class_num, name="fc").inputs(x)
    else:
        block = basic_block if kind == "basic" else bottleneck_block
        expansion = 1 if kind == "basic" else 4
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
                    fused_block = (nn.FusedBasicBlock if kind == "basic"
                                   else nn.FusedBottleneck)
                    x = fused_block(n_in, planes, stride,
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


def _block_key_order(block):
    """A fused block's slots in the unfused graph's topological order:
    the residual branch, then the shortcut
    (bigdl_tpu/models/resnet.py:205-214)."""
    keys = ["conv1", "bn1", "conv2", "bn2"]
    if isinstance(block, nn.FusedBottleneck):
        keys += ["conv3", "bn3"]
    if block.project:
        keys += ["conv_sc", "bn_sc"]
    return keys


def _convert_resnet_params(variables, class_num, depth, stem, to_fused,
                           dataset="imagenet"):
    """Map a JAX-layout ``{"params", "state"}`` tree (nested dicts of
    numpy arrays) between the unfused graph's keys and the fused blocks'
    slots (bigdl_tpu/models/resnet.py:216-261).  The leaves are the same
    arrays: only the keying differs.  The unfused graph's
    parameter-holding children come from the port's own graph, keyed as
    the JAX graph keys them."""
    unfused = ResNet(class_num, depth, dataset, stem, device="cpu")
    fused = ResNet(class_num, depth, dataset, stem, fused=True,
                   device="cpu")
    shared = set(fused.child_keys) & set(unfused.child_keys)
    children = dict(unfused.named_children())
    queue = [k for k in unfused.child_keys if k not in shared
             and next(children[k].parameters(), None) is not None]
    blocks = [(k, m) for k, m in fused.named_children()
              if k.startswith("fused_")]

    params, state = variables["params"], variables["state"]
    out_p, out_s = {}, {}
    qi = 0
    for fk, block in blocks:
        sub_p, sub_s = {}, {}
        for slot in _block_key_order(block):
            uk = queue[qi]
            qi += 1
            if to_fused:
                sub_p[slot] = params[uk]
                if state.get(uk):  # the BatchNorm slots (convs hold none)
                    sub_s[slot] = state[uk]
            else:
                out_p[uk] = params[fk][slot]
                out_s[uk] = state.get(fk, {}).get(slot) or {}
        if to_fused:
            out_p[fk] = sub_p
            out_s[fk] = sub_s
    if qi != len(queue):
        raise ValueError(f"{len(queue)} unfused layers for {qi} block slots")
    for k in shared:
        out_p[k] = params[k]
        out_s[k] = state.get(k, {})
    target = fused if to_fused else unfused
    # parameter-free keys get empty subtrees, in the target graph's order
    return {"params": {k: out_p.get(k, {}) for k in target.child_keys},
            "state": {k: out_s.get(k, {}) for k in target.child_keys}}


def fuse_resnet_params(variables, class_num=1000, depth=50, stem="conv7",
                       dataset="imagenet"):
    """Unfused ``ResNet(...)`` variables -> ``ResNet(fused=True)``
    variables (the same function; see nn/fused_block.py), so that a
    trained or mid-training checkpoint moves to the fused blocks."""
    return _convert_resnet_params(variables, class_num, depth, stem,
                                  to_fused=True, dataset=dataset)


def unfuse_resnet_params(variables, class_num=1000, depth=50, stem="conv7",
                         dataset="imagenet"):
    """Inverse of :func:`fuse_resnet_params`."""
    return _convert_resnet_params(variables, class_num, depth, stem,
                                  to_fused=False, dataset=dataset)
