"""ResNet ImageNet training driver, the BASELINE north-star recipe
(counterpart of bigdl_tpu/models/resnet_train.py:36-137; reference
models/resnet/TrainImageNet.scala: 90 epochs, batch 8192, a warmup of 5
epochs to maxLr 3.2, poly decay, LARS, zero-gamma residual BatchNorm):

    python -m bigdl_tpu_torch.models.resnet_train --fused -b 256 \\
        --maxEpoch 2 --syntheticSize 1024 --optim lars --warmupEpoch 1

trains ``ResNet`` with the recipe's schedule and method in bf16 compute
on the async loop, validating Top1 and Top5 every epoch, on the card
unless ``--device cpu``.  ``--fused`` runs each residual block (the
bottlenecks of depths 50-152, the basic blocks of 18, 34 and CIFAR) on
kernels 1-5.  ``--folder DIR`` reads ``DIR/train-*`` and ``DIR/validation-*``
shards (TFRecord, or SequenceFile by the ``.seq`` extension; cached in
host memory, or streamed with ``--streaming``) for ``--dataset
imagenet``, and the CIFAR-10 batches under ``DIR`` for ``--dataset
cifar10``; without it ``synthetic_imagenet`` stands in (at 32x32 for
cifar10).  ``--summary DIR`` writes the training scalars, ``--checkpoint
DIR`` (local or remote) a checkpoint every epoch:

    python -m bigdl_tpu_torch.models.resnet_train --fused -b 256 \\
        --folder shards/ --streaming --summary logs/ --checkpoint ckpt/
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.sharded import imagenet_tfrecord_dataset
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.train_utils import (base_parser,
                                                cifar10_datasets, configure,
                                                init_logging,
                                                report_validation,
                                                synthetic_imagenet)

logger = logging.getLogger("bigdl_tpu_torch.train")


def make_recipe_optim(args, iters_per_epoch: int) -> optim.OptimMethod:
    """Warmup from ``learningRate`` to ``maxLr`` over ``warmupEpoch``
    epochs, then poly(2) decay to ``maxEpoch``: TrainImageNet.scala's
    SequentialSchedule; LARS or SGD per ``--optim``."""
    warm_iters = args.warmupEpoch * iters_per_epoch
    total_iters = args.maxEpoch * iters_per_epoch
    base_lr = args.learningRate
    sched = optim.SequentialSchedule(iters_per_epoch)
    if warm_iters > 0:
        sched.add(optim.Warmup((args.maxLr - base_lr) / warm_iters),
                  warm_iters)
    # after the warmup the base is maxLr: Poly decays from there
    poly_iters = max(total_iters - warm_iters, 1)
    sched.add(_ScaledSchedule(optim.Poly(2.0, poly_iters),
                              args.maxLr / base_lr if base_lr else 1.0),
              poly_iters)
    method = optim.LarsSGD if args.optim == "lars" else optim.SGD
    return method(base_lr, momentum=args.momentum,
                  weight_decay=args.weightDecay, schedule=sched)


class _ScaledSchedule(optim.LearningRateSchedule):
    """An inner schedule times a constant (the post-warmup maxLr)."""

    def __init__(self, inner, scale: float):
        self.inner = inner
        self.scale = scale

    def bind(self, base_lr: float):
        self.inner.bind(base_lr)

    def rate(self, step, epoch=0):
        return self.scale * self.inner.rate(step, epoch)


def main(argv: Optional[list] = None) -> dict:
    init_logging()
    p = base_parser("resnet_train", batch_size=8192, max_epoch=90, lr=0.1)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--classNum", type=int, default=1000)
    p.add_argument("--imageSize", type=int, default=224)
    p.add_argument("--maxLr", type=float, default=3.2)
    p.add_argument("--warmupEpoch", type=int, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weightDecay", type=float, default=1e-4)
    p.add_argument("--optim", default="lars", choices=["lars", "sgd"])
    p.add_argument("--dataset", default="imagenet",
                   choices=["imagenet", "cifar10"])
    p.add_argument("--fused", action="store_true",
                   help="each residual block on the fused conv+BN "
                        "kernels (every depth and dataset)")
    p.add_argument("--streaming", action="store_true",
                   help="stream shards instead of caching their records in "
                        "host memory (full-ImageNet scale)")
    args = p.parse_args(argv)

    if args.folder and args.dataset == "cifar10":
        train_ds, val_ds = cifar10_datasets(args.folder, args.batchSize)
    elif args.folder:
        train_ds = imagenet_tfrecord_dataset(
            args.folder, "train", args.batchSize, args.imageSize,
            cache=not args.streaming)
        val_ds = imagenet_tfrecord_dataset(
            args.folder, "validation", args.batchSize, args.imageSize,
            cache=not args.streaming)
    else:
        n = args.syntheticSize or 1024
        res = args.imageSize if args.dataset == "imagenet" else 32
        x, y = synthetic_imagenet(n, res, args.classNum)
        xv, yv = synthetic_imagenet(n // 4, res, args.classNum, 1)
        train_ds = DataSet.from_arrays(x, y, batch_size=args.batchSize)
        val_ds = DataSet.from_arrays(xv, yv, batch_size=args.batchSize)

    # zero gamma on the last BatchNorm of each residual block is part of
    # the recipe (models/resnet.py builds it)
    model = ResNet(class_num=args.classNum, depth=args.depth,
                   dataset=args.dataset, fused=args.fused,
                   device=args.device,
                   generator=torch.Generator().manual_seed(42))
    opt = optim.Optimizer.apply(
        model, train_ds, nn.ClassNLLCriterion(logits=True),
        end_trigger=optim.Trigger.max_epoch(args.maxEpoch),
        device=args.device)
    opt.set_optim_method(make_recipe_optim(args,
                                           train_ds.batches_per_epoch()))
    opt.set_compute_dtype(torch.bfloat16)  # the bf16 hot loop
    methods = [optim.Top1Accuracy(), optim.Top5Accuracy()]
    opt.set_validation(optim.Trigger.every_epoch(), val_ds, methods)
    configure(opt, args)
    trained = opt.optimize()
    return report_validation(opt, trained, val_ds, methods)


if __name__ == "__main__":
    main()
