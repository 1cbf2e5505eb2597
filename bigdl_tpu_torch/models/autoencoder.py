"""MLP autoencoder on MNIST (counterpart of bigdl_tpu/models/
autoencoder.py; reference models/autoencoder/Autoencoder.scala): 784 ->
``class_num`` -> 784 with a sigmoid output, trained with
``MSECriterion`` against its input."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.device import DeviceLike
from bigdl_tpu_torch.models.lenet import place


def Autoencoder(class_num: int = 32, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    """The autoencoder on ``device`` (the card unless ``"cpu"``)."""
    return place(nn.Sequential(
        nn.Flatten(),
        nn.Linear(28 * 28, class_num),
        nn.ReLU(),
        nn.Linear(class_num, 28 * 28),
        nn.Sigmoid(),
    ), device, generator)
