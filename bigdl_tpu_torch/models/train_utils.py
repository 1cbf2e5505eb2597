"""Shared plumbing of the port's training drivers (counterpart of
bigdl_tpu/models/train_utils.py:19-58): the common options, logging and
the option block applied to an Optimizer.  ``--device`` chooses where to
train (the card unless ``--device cpu``).  Checkpoints and summaries are
not ported yet: ``--checkpoint``, ``--resume`` and ``--summary`` raise
``NotImplementedError``."""
from __future__ import annotations

import argparse
import logging


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
                   help="checkpoint dir (not ported yet)")
    p.add_argument("--overwrite", action="store_true",
                   help="overwrite checkpoint instead of timestamped dirs")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from (not ported yet)")
    p.add_argument("--summary", default=None,
                   help="TensorBoard log dir (not ported yet)")
    p.add_argument("--syntheticSize", type=int, default=None,
                   help="synthetic dataset size when no --folder")
    p.add_argument("--device", default=None,
                   help="'cpu' to train on the CPU; the card by default")
    return p


def configure(opt, args):
    """Apply the common option block to a configured Optimizer."""
    for flag in ("checkpoint", "resume", "summary"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet: it comes with the port's "
                "checkpoint slice")
    return opt


def init_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s",
    )
