"""Shared plumbing of the port's training drivers (counterpart of
bigdl_tpu/models/train_utils.py:19-92): the common options, logging, the
option block applied to an Optimizer, the final validation pass, the
synthetic ImageNet stand-in and the CIFAR-10 datasets.  ``--device``
chooses where to train (the card unless ``--device cpu``).
``--checkpoint DIR`` (local or remote, e.g. ``gs://``) writes a
checkpoint at every epoch's end (in a timestamped subdirectory unless
``--overwrite``), ``--resume PATH`` starts from one (either package's);
``--summary DIR`` writes the training scalars to a TensorBoard event
file under ``DIR/<driver name>/train``."""
from __future__ import annotations

import argparse
import logging

import numpy as np

from bigdl_tpu_torch.optim.triggers import Trigger


def base_parser(name: str, batch_size: int, max_epoch: int,
                lr: float) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=name)
    p.add_argument("-f", "--folder", default=None,
                   help="data directory (driver-specific layout); "
                        "synthetic data when omitted")
    p.add_argument("-b", "--batchSize", type=int, default=batch_size)
    p.add_argument("--maxEpoch", type=int, default=max_epoch)
    p.add_argument("--learningRate", type=float, default=lr)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir (local or gs://...), written every "
                        "epoch")
    p.add_argument("--overwrite", action="store_true",
                   help="overwrite checkpoint instead of timestamped dirs")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from")
    p.add_argument("--summary", default=None, help="TensorBoard log dir")
    p.add_argument("--syntheticSize", type=int, default=None,
                   help="synthetic dataset size when no --folder")
    p.add_argument("--device", default=None,
                   help="'cpu' to train on the CPU; the card by default")
    p.set_defaults(app_name=name)
    return p


def configure(opt, args):
    """Apply the common option block to a configured Optimizer: the
    checkpoints, the resume and, with ``--summary``, a ``TrainSummary``
    (no validation summary, as bigdl_tpu/models/train_utils.py:47-50),
    named after the driver."""
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        opt.over_write_checkpoint(args.overwrite)
    if args.resume:
        opt.resume_from(args.resume)
    if args.summary:
        from bigdl_tpu_torch.visualization import TrainSummary

        opt.set_train_summary(TrainSummary(
            args.summary, getattr(args, "app_name", "bigdl")))
    return opt


def init_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s",
    )


def report_validation(opt, model, dataset, methods) -> dict:
    """The final evaluation pass over ``dataset`` with the trained
    weights (``opt.final_params``/``final_state``); returns ``{method
    name: value}``, leaving out a method that saw no batch."""
    from bigdl_tpu_torch.optim.optimizer import evaluate

    log = logging.getLogger("bigdl_tpu_torch.train")
    out = {}
    for method, res in evaluate(model, opt.final_params, opt.final_state,
                                dataset, methods):
        if res is None:  # the set is smaller than one batch
            log.warning("%s: no validation batches (val set < batch size)",
                        method.name)
            continue
        log.info("%s: %s", method.name, res)
        out[method.name] = res.result()[0]
    return out


def synthetic_imagenet(n: int, res: int, classes: int, seed: int = 0):
    """A synthetic ImageNet stand-in, NHWC f32 images with a per-class
    mean shift so that small runs can learn, made with ``RandomState(seed)``
    (the JAX drivers' data, value for value)."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, res, res, 3).astype(np.float32)
    y = rs.randint(0, classes, (n,))
    x += y[:, None, None, None] / (4.0 * classes)
    return x, y


def cifar10_datasets(folder, batch_size, synthetic_n=1024, seed=0):
    """(train, validation) datasets of CIFAR-10 normalized by the training
    set's mean and std, from the batches under ``folder``, else the
    synthetic stand-in (bigdl_tpu/models/train_utils.py:95-112)."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.cifar import (TRAIN_MEAN, TRAIN_STD,
                                               load_cifar10)

    mean = np.asarray(TRAIN_MEAN, np.float32)
    std = np.asarray(TRAIN_STD, np.float32)
    x, y = load_cifar10(folder, train=True, synthetic_n=synthetic_n,
                        seed=seed)
    xv, yv = load_cifar10(folder, train=False,
                          synthetic_n=max(synthetic_n // 4, 1), seed=seed)
    return (DataSet.from_arrays((x - mean) / std, y, batch_size=batch_size),
            DataSet.from_arrays((xv - mean) / std, yv,
                                batch_size=batch_size))
