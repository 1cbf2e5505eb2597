"""LeNet-5 MNIST training driver (counterpart of bigdl_tpu/models/
lenet_train.py; reference models/lenet/Train.scala:31).

    python -m bigdl_tpu_torch.models.lenet_train -f /path/to/mnist \\
        -b 128 --maxEpoch 15 --checkpoint ./ckpt

``--folder`` expects the idx files (``train-images-idx3-ubyte`` and the
rest, plain or ``.gz``); without it the JAX driver's deterministic
synthetic MNIST stands in, array for array.  It trains on the card
unless ``--device cpu``, through ``Optimizer.apply(...).optimize()``
(one captured step, replayed), with SGD and momentum, and validates
Top-1 after every epoch.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.mnist import load_mnist
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.train_utils import (base_parser, configure,
                                                init_logging,
                                                report_validation)


def main(argv: Optional[list] = None) -> dict:
    init_logging()
    p = base_parser("lenet_train", batch_size=128, max_epoch=15, lr=0.05)
    p.add_argument("--momentum", type=float, default=0.9)
    args = p.parse_args(argv)

    synth = args.syntheticSize
    x_train, y_train = load_mnist(args.folder, train=True,
                                  synthetic_n=synth or 8192)
    x_val, y_val = load_mnist(args.folder, train=False,
                              synthetic_n=(synth or 8192) // 4)
    train_ds = DataSet.from_arrays(x_train, y_train,
                                   batch_size=args.batchSize)
    val_ds = DataSet.from_arrays(x_val, y_val, batch_size=args.batchSize)

    model = LeNet5(10, device=args.device,
                   generator=torch.Generator().manual_seed(42))
    opt = optim.Optimizer.apply(
        model, train_ds, nn.ClassNLLCriterion(logits=True),
        end_trigger=optim.Trigger.max_epoch(args.maxEpoch),
        device=args.device)
    opt.set_optim_method(optim.SGD(args.learningRate,
                                   momentum=args.momentum))
    opt.set_validation(optim.Trigger.every_epoch(), val_ds,
                       [optim.Top1Accuracy()])
    configure(opt, args)
    trained = opt.optimize()
    return report_validation(opt, trained, val_ds, [optim.Top1Accuracy()])


if __name__ == "__main__":
    main()
