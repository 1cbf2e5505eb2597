"""LeNet-5 (counterpart of bigdl_tpu/models/lenet.py; reference
models/lenet/LeNet5.scala), NHWC, emitting logits for
``ClassNLLCriterion(logits=True)``.  Child keys and layouts are the JAX
model's, so its variables load with ``load_jax_variables``; ``fc1``
reads the flattened (5, 5, 12) maps in H, W, C order."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DeviceLike, resolve_device


def place(model: nn.Module, device: DeviceLike,
          generator: Optional[torch.Generator]) -> nn.Module:
    """``model`` initialised from ``generator`` (torch's global one when
    None) and moved to ``device`` (the card unless ``"cpu"``)."""
    return model.initialize(generator).to(resolve_device(device))


def LeNet5(class_num: int = 10, device: DeviceLike = None,
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """LeNet-5 on ``device`` (the card unless ``device="cpu"``)."""
    return place(nn.Sequential(
        nn.SpatialConvolution(1, 6, 5, padding="SAME", name="conv1_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2),
        nn.SpatialConvolution(6, 12, 5, name="conv2_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2),
        nn.Flatten(),
        nn.Linear(12 * 5 * 5, 100, name="fc1"),
        nn.Tanh(),
        nn.Linear(100, class_num, name="fc2"),
    ), device, generator)


def lenet_graph(class_num: int = 10, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> nn.Graph:
    """The Graph-container form (reference LeNet5.graph); its children
    are keyed by class name, ``_1`` on a repeat, as JAX's graph keys
    them."""
    inp = nn.Input()
    x = nn.SpatialConvolution(1, 6, 5, padding="SAME").inputs(inp)
    x = nn.Tanh().inputs(x)
    x = nn.SpatialMaxPooling(2, 2).inputs(x)
    x = nn.SpatialConvolution(6, 12, 5).inputs(x)
    x = nn.Tanh().inputs(x)
    x = nn.SpatialMaxPooling(2, 2).inputs(x)
    x = nn.Flatten().inputs(x)
    x = nn.Linear(12 * 5 * 5, 100).inputs(x)
    x = nn.Tanh().inputs(x)
    x = nn.Linear(100, class_num).inputs(x)
    return place(nn.Graph([inp], [x]), device, generator)
