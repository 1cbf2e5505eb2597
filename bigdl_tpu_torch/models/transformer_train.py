"""Transformer language-model training driver (counterpart of
bigdl_tpu/models/transformer_train.py):

    python -m bigdl_tpu_torch.models.transformer_train -f /path/to/ptb \\
        -b 8 --seqLen 512 --hiddenSize 256 --numLayers 4

trains ``nn.Transformer`` (causal, weight-tied) with Adam, gradient
clipping by the global L2 norm, bf16 compute, validation every epoch and
a final perplexity, on the card unless ``--device cpu``.  Every attention
forward runs the flash kernel (``csrc/flash_attention.cu``).
``--folder`` expects ``ptb.train.txt``/``ptb.valid.txt`` (one sentence
per line); without it a synthetic Zipf corpus stands in.  Pipeline,
expert, tensor and sequence parallelism (``--pp/--ep/--tp/--sp``,
``--moeExperts``) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import logging
import math
import os
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.text import (Dictionary, ptb_batchify,
                                          read_sentences)
from bigdl_tpu_torch.models.train_utils import (base_parser, configure,
                                                init_logging)

logger = logging.getLogger("bigdl_tpu_torch.train")

INIT_SEED = 42  # the JAX loop initialises with PRNGKey(42)


def _load_corpus(folder: Optional[str], vocab_size: int, synth_tokens: int):
    """(train_ids, valid_ids, vocab_size) from PTB text files, or from a
    synthetic Zipf corpus made with ``RandomState(0)``
    (bigdl_tpu/models/ptb_train.py:30-46)."""
    if folder:
        train_s = read_sentences(os.path.join(folder, "ptb.train.txt"))
        valid_s = read_sentences(os.path.join(folder, "ptb.valid.txt"))
        toks = [s.split() for s in train_s]
        d = Dictionary(iter(toks), vocab_size=vocab_size - 1)
        train = np.concatenate([d.to_indices(t + ["<eos>"]) for t in toks])
        valid = np.concatenate(
            [d.to_indices(s.split() + ["<eos>"]) for s in valid_s])
        return train, valid, d.vocab_size + 1
    rs = np.random.RandomState(0)
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    train = rs.choice(vocab_size, synth_tokens, p=p)
    valid = rs.choice(vocab_size, max(synth_tokens // 10, 200), p=p)
    return train, valid, vocab_size


def _window_dataset(ids, batch: int, steps: int):
    """The batchified windows flattened into samples, re-batched by the
    DataSet (which reshuffles them every epoch)."""
    xs, ys = ptb_batchify(ids, batch, steps)
    return DataSet.from_arrays(
        xs.reshape(-1, steps), ys.reshape(-1, steps), batch_size=batch)


def main(argv: Optional[list] = None) -> dict:
    init_logging()
    p = base_parser("transformer_train", batch_size=8, max_epoch=5,
                    lr=1e-3)
    p.add_argument("--seqLen", type=int, default=512)
    p.add_argument("--vocabSize", type=int, default=10001)
    p.add_argument("--hiddenSize", type=int, default=256)
    p.add_argument("--numHeads", type=int, default=8)
    p.add_argument("--filterSize", type=int, default=1024)
    p.add_argument("--numLayers", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--gradClip", type=float, default=1.0)
    for flag in ("--pp", "--ep", "--tp", "--sp"):
        p.add_argument(flag, type=int, default=1,
                       help="parallel degree (not ported yet)")
    p.add_argument("--moeExperts", type=int, default=0,
                   help="MoE experts (not ported yet)")
    p.add_argument("--microBatches", type=int, default=0,
                   help="pipeline microbatches (not ported yet)")
    args = p.parse_args(argv)
    parallel = {f: getattr(args, f) for f in ("pp", "ep", "tp", "sp")
                if getattr(args, f) > 1}
    if parallel or args.moeExperts:
        raise NotImplementedError(
            f"{parallel or {'moeExperts': args.moeExperts}}: pipeline, "
            "expert, tensor and sequence parallelism are not ported yet")

    train_ids, valid_ids, vocab = _load_corpus(
        args.folder, args.vocabSize,
        args.syntheticSize or 16 * args.seqLen * args.batchSize)
    train_ds = _window_dataset(train_ids, args.batchSize, args.seqLen)
    val_ds = _window_dataset(valid_ids, args.batchSize, args.seqLen)

    model = nn.Transformer(
        vocab_size=vocab, hidden_size=args.hiddenSize,
        num_heads=args.numHeads, filter_size=args.filterSize,
        num_layers=args.numLayers, dropout=args.dropout, causal=True)
    model.initialize(torch.Generator().manual_seed(INIT_SEED))
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(logits=True))
    opt = optim.Optimizer.apply(
        model, train_ds, crit,
        end_trigger=optim.Trigger.max_epoch(args.maxEpoch),
        device=args.device)
    opt.set_optim_method(optim.Adam(args.learningRate))
    opt.set_gradient_clipping_by_l2_norm(args.gradClip)
    opt.set_validation(optim.Trigger.every_epoch(), val_ds,
                       [optim.Loss(crit)])
    opt.set_compute_dtype(torch.bfloat16)
    configure(opt, args)
    opt.optimize()

    results = optim.evaluate(model, opt.final_params, opt.final_state,
                             val_ds, [optim.Loss(crit)])
    val_loss = results[0][1].result()[0]
    ppl = math.exp(min(val_loss, 30.0))
    logger.info("validation loss %.4f perplexity %.2f", val_loss, ppl)
    return {"val_loss": val_loss, "perplexity": ppl}


if __name__ == "__main__":
    main()
