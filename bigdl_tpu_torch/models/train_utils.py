"""Shared plumbing of the port's training drivers (counterpart of
bigdl_tpu/models/train_utils.py:19-58): the common options, logging and
the option block applied to an Optimizer.  ``--device`` chooses where to
train (the card unless ``--device cpu``).  ``--checkpoint DIR`` writes a
checkpoint at every epoch's end (in a timestamped subdirectory unless
``--overwrite``), ``--resume PATH`` starts from one (either package's);
summaries are not ported yet: ``--summary`` raises
``NotImplementedError``."""
from __future__ import annotations

import argparse
import logging

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
                   help="checkpoint dir (local), written every epoch")
    p.add_argument("--overwrite", action="store_true",
                   help="overwrite checkpoint instead of timestamped dirs")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from")
    p.add_argument("--summary", default=None,
                   help="TensorBoard log dir (not ported yet)")
    p.add_argument("--syntheticSize", type=int, default=None,
                   help="synthetic dataset size when no --folder")
    p.add_argument("--device", default=None,
                   help="'cpu' to train on the CPU; the card by default")
    return p


def configure(opt, args):
    """Apply the common option block to a configured Optimizer."""
    if args.summary:
        raise NotImplementedError(
            "--summary is not ported yet: it needs visualization/")
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        opt.over_write_checkpoint(args.overwrite)
    if args.resume:
        opt.resume_from(args.resume)
    return opt


def init_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s",
    )
