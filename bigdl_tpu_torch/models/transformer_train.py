"""Transformer language-model training driver (counterpart of
bigdl_tpu/models/transformer_train.py):

    python -m bigdl_tpu_torch.models.transformer_train -f /path/to/ptb \\
        -b 8 --seqLen 512 --hiddenSize 256 --numLayers 4

trains ``nn.Transformer`` (causal, weight-tied) with Adam, gradient
clipping by the global L2 norm, bf16 compute, validation every epoch and
a final perplexity, on the card unless ``--device cpu``.  Every attention
forward runs the flash kernel (``csrc/flash_attention.cu``).
``--folder`` expects ``ptb.train.txt``/``ptb.valid.txt`` (one sentence
per line); without it a synthetic Zipf corpus stands in.  ``--summary
DIR`` writes the training scalars to a TensorBoard event file.

Parallelism, as the JAX driver plans it, under ``torchrun`` (one process
per device; the world is the mesh):

    torchrun --standalone --nproc_per_node 2 -m \
        bigdl_tpu_torch.models.transformer_train --tp 2

``--pp N`` pipelines the LM over N stages (``--microBatches``, default
2N, clamped to the per-data-rank batch) with ZeRO-1 off, composed with
``--tp`` and ``--ep``; ``--ep N`` (or ``--moeExperts``) swaps every FFN
for a Switch MoE with its banks over the ``expert`` axis; ``--tp`` shards
attention, FFN and embedding over ``model``; ``--sp`` splits the
sequence over ``seq`` with ring attention.  The data axis takes the
ranks left over.  The combinations JAX's driver refuses exit alike.
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


def _plan(args, vocab: int):
    """``(model, mesh, param_shardings, DistriOptimizer options)`` of the
    parallelism flags, as the JAX driver plans them; the model
    initialised from ``INIT_SEED``."""
    from bigdl_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                               MeshConfig, make_mesh)

    dims = dict(vocab_size=vocab, hidden_size=args.hiddenSize,
                num_heads=args.numHeads, filter_size=args.filterSize,
                num_layers=args.numLayers, dropout=args.dropout,
                causal=True)
    mesh = param_shardings = None
    distri_kwargs = {}
    if args.pp > 1:
        from bigdl_tpu_torch.parallel.pipeline import \
            pipelined_transformer_lm
        from bigdl_tpu_torch.parallel.tensor_parallel import \
            TRANSFORMER_RULES

        mesh = make_mesh(MeshConfig(data=-1, pipe=args.pp, model=args.tp,
                                    expert=args.ep), args.device)
        # each data rank needs >= 1 row per microbatch: M must divide
        # batch / data-parallel degree
        per_shard = max(args.batchSize // mesh.shape[DATA_AXIS], 1)
        m_req = args.microBatches or 2 * args.pp
        m = next(d for d in range(min(m_req, per_shard), 0, -1)
                 if per_shard % d == 0)
        if m != m_req:
            logger.info("clamping pipeline microbatches %d -> %d (batch %d "
                        "over %d-way dp)", m_req, m, args.batchSize,
                        mesh.shape[DATA_AXIS])
        moe = args.moeExperts or (2 * args.ep if args.ep > 1 else 0)
        model = pipelined_transformer_lm(
            mesh=mesh, num_microbatches=m, data_axis=DATA_AXIS,
            moe_experts=moe, **dims)
        model.initialize(torch.Generator().manual_seed(INIT_SEED))
        param_shardings = model.param_shardings(
            mesh, tp_rules=TRANSFORMER_RULES if args.tp > 1 else None,
            expert_axis=EXPERT_AXIS if args.ep > 1 else None)
        # the trunk is pipe-sharded: the optimizer state follows it
        distri_kwargs = {"zero1": False}
        return model, mesh, param_shardings, distri_kwargs
    if args.ep > 1 or args.moeExperts:
        from bigdl_tpu_torch.parallel.expert import \
            transformer_expert_shardings

        mesh = make_mesh(MeshConfig(data=-1, expert=args.ep), args.device)
        model = nn.Transformer(moe_experts=args.moeExperts or 2 * args.ep,
                               moe_mesh=mesh, **dims)
        param_shardings = transformer_expert_shardings(
            mesh, dict(model.named_parameters()))
    elif args.tp > 1 or args.sp > 1:
        from bigdl_tpu_torch.parallel.tensor_parallel import (
            TRANSFORMER_RULES, make_param_shardings)

        mesh = make_mesh(MeshConfig(data=-1, model=args.tp, seq=args.sp),
                         args.device)
        model = nn.Transformer(seq_mesh=mesh if args.sp > 1 else None,
                               **dims)
        if args.sp > 1:
            distri_kwargs = {"seq_dim": 1}
        param_shardings = make_param_shardings(
            mesh, dict(model.named_parameters()), TRANSFORMER_RULES)
    else:
        model = nn.Transformer(**dims)
    model.initialize(torch.Generator().manual_seed(INIT_SEED))
    return model, mesh, param_shardings, distri_kwargs


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
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (ranks on the pipe mesh "
                        "axis; the remaining ranks become data)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (ranks on the expert mesh "
                        "axis); implies a Switch-MoE FFN")
    p.add_argument("--moeExperts", type=int, default=0,
                   help="number of MoE experts (default 2*ep when --ep)")
    p.add_argument("--microBatches", type=int, default=0,
                   help="pipeline microbatches (default 2*pp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (attention/FFN weights "
                        "over the 'model' mesh axis)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree (sequence dim over the "
                        "'seq' mesh axis)")
    args = p.parse_args(argv)
    if args.sp > 1 and (args.pp > 1 or args.ep > 1 or args.moeExperts):
        raise SystemExit("--sp (ring attention) composes with --tp/dp "
                         "only, not --pp/--ep")
    if args.tp > 1 and (args.ep > 1 or args.moeExperts):
        raise SystemExit("--tp composes with --pp/--sp/dp; tp x ep is "
                         "not wired yet")
    if args.sp > 1 and args.seqLen % args.sp:
        raise SystemExit(f"--seqLen {args.seqLen} must divide over "
                         f"--sp {args.sp} sequence shards")
    if args.ep > 1 and (args.moeExperts or 2 * args.ep) % args.ep:
        raise SystemExit(
            f"--moeExperts {args.moeExperts} must divide over --ep "
            f"{args.ep} expert shards (else the banks silently "
            "replicate while the mesh still spends devices on 'expert')")

    train_ids, valid_ids, vocab = _load_corpus(
        args.folder, args.vocabSize,
        args.syntheticSize or 16 * args.seqLen * args.batchSize)
    train_ds = _window_dataset(train_ids, args.batchSize, args.seqLen)
    val_ds = _window_dataset(valid_ids, args.batchSize, args.seqLen)

    model, mesh, param_shardings, distri_kwargs = _plan(args, vocab)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(logits=True))
    opt = optim.Optimizer.apply(
        model, train_ds, crit,
        end_trigger=optim.Trigger.max_epoch(args.maxEpoch),
        device=args.device, mesh=mesh, param_shardings=param_shardings,
        **distri_kwargs)
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
