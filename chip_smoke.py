#!/usr/bin/env python3
"""GPU smoke run of bigdl_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # all phases, exit 0 only if all pass
    python3 chip_smoke.py --quick    # build + kernel checks (all seven)

Phases:
1. device: require CUDA, print the card's name and power limit, build the
   port's CUDA kernels from bigdl_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, in parallel) and print the build time; count the
   wgmma instructions (HGMMA) in the SASS of the six bf16 wgmma kernels
   (fused_matmul_bn, fused_matmul_bn_dgrad, fused_matmul_bn_wgrad,
   fused_conv3x3_bn, fused_conv3x3_bn_dgrad, flash_attention) and the
   integer ones (IGMMA) in int8_matmul's, and fail if any has none;
2. kernels: at ResNet-50's batch-32 shapes in bf16, plus a ragged-M
   matmul, batch-1 convs and an f32 case of each, hold every kernel
   against its plain PyTorch version on the card: the forward kernels'
   (y, ssum, ssq) and, with random cotangents, the backward kernels'
   (dx, d_ps, d_pb) and dW; time the kernel, the plain version and one
   library call for the same function (CUDA-graph replay) and compute
   the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s); every bf16 case of kernels 1-5 runs
   twice and must give bit-equal results (split reductions and column
   sums are summed in a fixed order); a NaN in one row of x must reach
   the outputs of kernels 1-5 exactly where it reaches the plain
   versions' (bf16 and f32; the prologue's ReLU keeps a NaN, the
   dgrads' mask zeroes g there, so only d_ps carries it); kernels 1-5
   are also checked and timed beside their library calls at the
   batch-256 shapes of the train step; at a channel width of 12 (a
   FusedBottleneck of width 12) kernels 1-5 each launch once on
   channels zero-padded to 16 (one operand copy) and agree with their
   plain versions in bf16 and f32, while the main paths below pad
   nothing (fm.COPIES stays 0 in serving, the train steps and
   optimize());
3. serve: fused ResNet-50 (space-to-depth stem, 1000 classes) with
   random weights from --seed and randomised BatchNorm, carried in
   through load_jax_variables, served by ServingEngine in bf16 to 4
   client threads; every answer is held against a plain-path forward of
   the same model on the card.  The engine's warmup captures one CUDA
   graph per declared bucket (batch 1, 8 and 32): each capture must
   launch 36 fused_matmul_bn and 13 fused_conv3x3_bn, the launch
   counters must rise by exactly that for each capture and its warm-up
   calls and by nothing while serving, and every batch must be one
   replay with no compile after warmup;
4. train: the same model trained with make_train_step (SGD 0.1, momentum
   0.9, bf16 compute and features, as bench.py's step): exact launch
   counts per step with remat on and off, one step at batch 32 held
   against the plain path in bf16 (loss, running statistics, finite
   gradients) and in f32 (loss, every gradient, running statistics),
   two fused blocks at ResNet-50 shapes against the plain path in f32
   (output, every gradient, running statistics), ten
   steps on one batch with a falling loss, images/s, ms per step and
   the host's time to enqueue a step and peak memory at batch 256 with
   remat on and off (and where the step's device time goes, from
   torch.profiler), and the user entry point
   Optimizer.apply(...).optimize() for 5 iterations on 160 images, which
   prints the reference log lines and must end with a finite loss, in
   one captured step (one capture, five replays, the step's launches
   once per capture and warm-up call);
5. lm: the flash-attention kernel held against its plain version (O and
   lse) at the LM's (8, 8, 512, 32) and (8, 8, 4096, 32) causal shapes
   as MultiHeadAttention gives them, the FLASH shape, a ragged T, KV
   longer than Q, f32, a causal (1, 8, 8192, 128), head dims 12 and
   8 (zero-padded to 32 by the wrapper), one head of 256 as the LM at
   --numHeads 1 gives it (bf16 and f32, causal and not) and a head dim
   of 200 (zero-padded to 256), one launch each, timed beside its plain
   version and SDPA;
   the default Transformer LM (10001 tokens, hidden 256, 8 heads, filter
   1024, 4 layers) with random weights from --seed carried in through
   load_jax_variables: one Adam + clipping train step in bf16 and in f32
   held against the plain attention path (use_flash=False), exactly 4
   flash launches per forward, ms per step, tokens/s and peak memory at
   batch 8 and T 512 and 4096 with a profiler breakdown, and the user
   entry point transformer_train.main([]), whose loss must fall, in two
   compiled calls (the train step and the evaluation forward): 4 flash
   launches per capture and warm-up call, and a replay per iteration and
   validation batch; then the LM with one head of 256 (--numHeads 1): a
   bf16 step against the plain attention path and
   transformer_train.main(['--numHeads', '1', '--maxEpoch', '1']);
6. quant: the int8 kernel held bit for bit against its plain version
   (bf16 and f32 output, each case twice, so a split-K workspace left
   dirty would show) at every shape of one quantized ResNet-50 forward at
   batch 32 (and at batches 1 and 8, the served ones), at
   tools/kernel_shapes.INT8's shapes (the int8 KV score shape with w_q as
   a transposed view), the large-FC MLP's and two ragged ones (a (K, N)
   w_q copied K-major, x and y padded), with no operand copy where w_q
   has the layers' K-major layout; timed beside its plain version and
   torch._int_mm (before --quick stops); then the unfused ResNet-50 (conv7
   stem, 1000 classes) with random weights from --seed carried in through
   load_jax_variables and quantized: exactly 34 int8 launches per dynamic
   forward, none in weight_only mode and no operand copy (forward,
   serving, the MLP), the kernel path against the
   plain path in bf16 and f32, the quantization error against the float
   model, save_quantized/load_quantized with every leaf held equal, 512
   requests from 4 threads through PredictionService (34 int8 launches
   per bucket capture and warm-up call, none while serving, a replay per
   batch) plus a few through predict_serialized, each answer held
   against the same image alone on the plain path, the three forwards
   of tools/quant_bench.py (ResNet-50 at batch 32 and the large-FC MLP
   at batch 8, which must launch the kernel 3 times) and a profiler
   breakdown of the dynamic-int8 forward;
7. graphs: every main path compiled (utils/graphs.py: CUDA graphs)
   against eager, with cuDNN held to deterministic algorithms: the
   fused and the dynamic-int8 ResNet-50 forwards bit-equal at every
   declared bucket, each capture's launches and, by torch.profiler, the
   kernels one replay runs exactly 36 + 13 and 34; 512 requests served
   eagerly and compiled (images/s, p50, p99), the batch-32 forwards'
   wall time eager and compiled beside their device time; three
   ResNet-50 train steps at batch 32 (remat on and off) and three LM
   steps (dropout 0.1, the loop's seeds) compiled bit-equal to eager in
   losses, parameters, running statistics and optimizer state, with the
   kernels of a capture and of a replay exact (the train step's launch
   counts; 4 flash); dropout masks replayed with two seeds differ and
   equal the eager masks; ms per step eager and compiled at batch 256
   (remat on and off) and for the LM at T 512 and 4096;
8. decode: the same LM (random weights from --seed, dropout 0) in f32
   and bf16: a prompt batch of 2 x 48 prefilled, then 64 decode_steps,
   held at every position against the uncached forward (kernel 6, 4
   launches), and extend in chunks of 16 against it and prefill;
   generate (batch 2, beam 4, 128 steps) compiled in one capture and 128
   replays, bit-equal to its eager run; greedy generate cached against
   use_cache=False (kernel 6 in every step, 4 per replay) up to the
   first near-tie, and ms per generated token of both at T 128; the
   server's programs (8 slots of 512, prompts of 5 to 200 in buckets of
   64 and 256, 64 tokens each): compiled prefill, write_slot and greedy
   ticks bit-equal to the same programs eager, no capture while serving,
   ms per tick and tokens/s, the paged tick (f32 pool, PageAllocator)
   giving the dense grid's tokens, the sampling tick repeating under the
   same keys with its greedy rows equal to the greedy tick's; the LM
   with 2 heads of 128 over an int8 paged pool: extend_paged chunks of
   16 each launching kernel 7 32 times (4 layers x 4 slots x 2 heads,
   no operand copy), logits bit-equal to the plain route, none in a
   decode step, kernel 7's device ms per chunk (profiler sum over its
   launches) and kernel 7 alone timed at (16, 128, 512) beside its
   bound and _int_mm; then the decode engine (DecodeEngine, 8 slots of
   512, prompt buckets 64 and 256, 32 requests of 5 to 200 tokens with
   budgets of 16 to 96): continuous against static batching (tokens/s
   as the median of 7 rounds and its spread, tick p50/p95, slot
   occupancy; no capture while serving, equal tokens, continuous
   faster), greedy tokens against direct decode_step rollouts, sampling
   repeated per seed, paged at 16 slots on the dense grid's bytes (7
   rounds), the same pool with page zeroing (the page reset one more
   program), chunked prefill of prompts of 300 and 420 tokens
   against learned buckets, the int8 pool of the 2-head LM against its
   f32 pool (bytes per page, token agreement, kernel 7's launches by
   host and profiler), and bench.py decode_ab's leg 1 (DECODE_MODEL,
   beam 1, one stream, T 128, the median of 7 searches each: cached
   must beat re-forward; the JAX 3x gate reported).  Then speculative
   decoding (greedy only; tokens/s, acceptance and the ratio to the
   greedy arm printed, not gated): a 1-layer draft of the LM and a
   self-draft (acceptance >= 0.95) at draft_k 3 on the dense engine
   (7 rounds each), bench.py decode_production_arms' speculative arm at
   its constants (DECODE_MODEL, DECODE_DRAFT_MODEL, draft_k 3, 4 slots
   of 160, its 12 requests) on a paged pool with chunks of 16 against
   its dense greedy arm, and the 2-head LM's int8 pool at draft_k 7,
   whose verify runs kernel 7 layers x slots x heads (32) times a round
   (one replay profiled; kernel 7's device ms beside the verify's;
   tokens >= 90% equal to the f32 pool's); no arm captures while
   serving; and decode_program_check captures and replays every program
   of the dense, paged, int8, chunked and speculative engines.  Two
   arms' tokens must be equal or part at a near-tie of the uncached
   forward;
9. checkpoint: the LM (T 512, dropout 0.1, Adam, bf16; kernel 6) for 8
   iterations and the fused ResNet-50 at batch 32 (kernels 1-5) for 4,
   each stopped at a checkpoint and resumed in a new LocalOptimizer:
   the restored trees equal the saved ones bit for bit and the first
   resumed loss equals the stopped run's loss of that step bit for bit,
   later losses within 5e-2 of the uninterrupted run's; a NaN step (a
   NaN learning rate in the LM, a NaN image in a ResNet-50 batch) is
   retried from the last checkpoint with the step still one capture and
   the run ends finite; transformer_train.main with --checkpoint
   --overwrite for one epoch, then --resume to two; the checkpoints'
   bytes and write ms (device trees to the file) printed; all of it on
   the synchronous loop (BIGDL_TPU_SYNC_LOOP=1), then the ResNet-50 run
   on the async loop, its checkpoints written by the background writer
   (the last file equal to the final trees bit for bit; the loop's stall,
   the snapshot, and the writer's ms printed);
10. recipe: resnet_train.main with --fused -b 256 --syntheticSize 1024
   --maxEpoch 2 --optim lars --warmupEpoch 1 (fused ResNet-50, warmup
   then poly, LARS, bf16, Top1/Top5 every epoch) on the async loop: one
   capture of the train step launching kernels 1-5 72/36/36/26/13 times,
   every read loss finite, each iteration's learning rate the recipe's
   host schedule, ms per step and data_stall against one epoch of the
   synchronous loop's data; the fused ResNet-50 step at batch 256 as 4 x
   64 with gradient accumulation (f32, one capture, 4 x the launches)
   against the same step through the plain versions within the train
   phase's f32 limits, and the peak memory of 4 x 256 accumulated against
   a direct batch 256 in bf16; the LM (T 512) for 20 steps on the async
   and the synchronous loop, losses and final trees bit-equal (cuDNN
   deterministic), a NaN step read at most a window later and retried
   from the background-written checkpoint in the same capture (the
   loop's stall per checkpoint printed), and bench.py loop_ab's A/B on
   the LM with a sleep per batch equal to its step: the async loop at
   least 1.3x the synchronous one;
11. data: 1024 + 256 seeded 224 px images written into 8 + 2 TFRecord
   shards under build/ by write_image_shards (the port's C++ record
   library built by g++ and loaded; count_tfrecords and every CRC
   checked; the threaded reader's records/s and MB/s), then phase 10's
   recipe with --folder in place of --syntheticSize, --summary and
   --checkpoint --overwrite, cached and then --streaming, on the async
   loop: one capture launching kernels 1-5 72/36/36/26/13 times a step,
   finite losses, the recipe's rates, each cached epoch every record
   once, the event file's Loss/Throughput/LearningRate at each
   iteration, the checkpoint equal to the final trees, and
   save_model/load_model of the trained model giving a bit-equal forward
   on 32 validation images; ms per step, the producer's data, the loop's
   data_stall, the time to the first batch and the peak RSS of both
   modes beside phase 10's step on arrays.
12. basic: the basic-block family.  Kernels 4 and 5 without a prologue
   (the stride-1 conv1 of every basic block) at ResNet-18's shapes at
   batch 256 and CIFAR-20's at batch 128, bf16 (each case twice,
   bit-equal) and f32, against their plain versions, timed beside the
   plain version and F.conv2d / conv2d_input with their bound; a
   stride-1 and a stride-2 FusedBasicBlock at ResNet-18 shapes against
   the plain path in f32 (output, every gradient, running statistics);
   the fused ResNet-18 train step (bf16 compute, batch 256) in one CUDA
   graph with remat on and off: kernels 1-5 6/3/3/26/13 and 3/3/3/13/13
   times per step (the capture, the host and, by profiler, a replay), no
   channel padding, ms per step, images/s and peak memory, and one step
   at batch 32 against the plain path in bf16 and f32; a captured
   ResNet-34 step at batch 32 (6/3/3/58/29); resnet_train.main with
   --fused --depth 18 -b 256 --syntheticSize 1024 --maxEpoch 2 --optim
   lars --warmupEpoch 1, and with --dataset cifar10 --depth 20 --fused
   -b 128 --maxEpoch 2 --folder over CIFAR-10 binary batches written
   under build/ from the seed and removed after (4/2/2/32/16 a step):
   one capture, finite losses; fuse_resnet_params on the card: the fused
   ResNet-18 from the unfused one's randomised tree gives its eval
   forward (bf16 within the serving tolerance, f32 within 1e-3 of the
   largest logit with the same argmax); every criterion's loss and input
   gradient on CUDA tensors against the same call on the CPU (f32,
   within 1e-5 of |cpu| + max |cpu|), ClassNLL's one-hot targets
   included; the phase's seconds.
13. telemetry: the fused ResNet-50 served in bf16 by two engines, one
   built with the tracer off, one with it on: 36 + 13 launches a capture
   and bit-equal outputs either way, each bucket's cost stamp its batch
   x the batch-1 stamp; on one engine, the tracing overhead measured as
   the JAX package's gate measures it (128 chunks of 32 requests from
   one client, the tracer flipped per chunk, the collector off, the
   median request latency of each state), held to 3%; then 8 saturated
   rounds of 1024 requests with the tracer off and 8 with it on, in
   turns: images/s, p50/p99, the log lines with GF/s and MFU, MFU while
   serving; the
   Chrome trace written under --out and parsed back (the dispatcher's
   and the drain's tracks) and every request's attribution summing to
   its latency; the bare forward's MFU; the HBM ledger sampling the card;
   the compiled train step (batch 32, bf16) bit-equal with the tracer on
   and off, its stamp about 4x the forward an image, and its MFU at
   batch 256; a decode engine forced past its largest prompt bucket,
   the changed axis named by forensics and counted by the watchdog.
14. observability: the compiled fused ResNet-50 step (bf16, batch 256)
   with numerics off and on: one capture each, kernels 1-5
   72/36/36/26/13 a step in both (capture and profiler), every kernel of
   a replay counted, trees bit-equal after 3 steps, a replay's drained
   stats within 1e-5 of the same step run eagerly and of per-leaf f64
   norms, and the stats' overhead timed as bench.py numerics_ab does
   (bursts of 10 steps in turns, the median; held to 3%); a trap layer
   before the ResNet-50 turning one batch NaN in optimize() (batch 32,
   a checkpoint each epoch): the numerics_anomaly before the
   loss_divergence, nan_provenance naming the trap (site forward), the
   recovery record, one capture and a seven-file flight bundle (the
   provenance's and a dump's seconds and bytes printed); the served
   ResNet-50 with BIGDL_TPU_DEBUG_PORT=0 (/metricsz against the engine's
   metrics, with the card's HBM gauges; /statusz, /tracez, /xrayz,
   /flightz); profiling.trace around a batch-32 forward and optimize():
   kernels 1-5 named in the device trace, the loop's spans in
   host_trace.json, get_times' per-layer table; the served and trained
   parts shipped as two hosts and merged into two lanes.

The line before the last is the JSON ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Per-shape timings and the nvcc output
go to the --out directory (default build/smoke/).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

# y, dx, dW: one bf16 rounding apart plus f32 sum order
Y_RTOL = {"bf16": 2e-2, "f32": 1e-4}
Y_ATOL = {"bf16": 1e-3, "f32": 1e-6}  # times the largest |y|
STATS_RTOL = 1e-3
# d_ps/d_pb: f32 column sums of M terms in another order, and of g that
# differs by f32 sum order: relative to the largest |d|
DSUM_ATOL = 2e-3
BATCH = 32        # kernel shapes: one ResNet-50 forward at 224x224
REQUESTS = 512    # served by 4 client threads
ITERS = 20        # timed repetitions
# served logits vs the plain path, relative to the largest |logit|:
# bf16 rounding flips from f32 sum order, carried through 53 convs
SERVE_TOL = 3e-2
# train step at batch 32, kernels vs plain path from the same weights:
# loss relative error and relative L2 error per leaf of the gradient and
# of the running statistics.  The whole model's gradient at these random
# weights is at its noise floor: scaling the input by (1 + 1e-7) moves
# the plain path's own f32 gradients by 0.025 median, 0.031 max per leaf
# (CPU, 224x224, batch 8; 1.8e-6 between the two backward formulations
# with an identical forward), and moving one pixel by 0.05 moves its
# bf16 gradients by 1.0 median, 1.28 max.  So f32 gradients are held to
# 0.1 (a guard against gross faults: a missing or mis-scaled gradient is
# 1 or more) and bf16 gradients only to being finite; the discriminating
# gradient check is per block, below.
TRAIN_F32_TOL = {"loss": 1e-4, "grad": 0.1, "state": 1e-3}
TRAIN_BF16_TOL = {"loss": 2e-2, "state": 2e-2}
# one fused block in training at ResNet-50 shapes, f32, kernels vs plain
# path: output, input gradient and every parameter gradient, relative L2
# (f32 sums in another order over 100k-sample BatchNorms; measured 5.2e-4
# and 1.2e-6 for the two blocks on an H100)
BLOCK_TOL = 2e-3
BLOCKS = ((256, 64, 1, 56), (256, 128, 2, 56))  # n_in, planes, stride, hw
TRAIN_BATCH = 256  # bench.py's batch for the throughput steps
# kernels whose bf16 results must be bit-equal from run to run (their
# split reductions are summed in a fixed order)
BIT_EQUAL = ("mm", "mm_dgrad", "mm_wgrad", "cv", "cv_dgrad")
# a NaN in x (row 37, channel 5) with a relu prologue, bf16 and f32
NAN_CASES = (("mm", (1000, 64, 256)), ("mm", (147, 2048, 512)),
             ("mm_dgrad", (1000, 64, 256)), ("mm_dgrad", (147, 2048, 512)),
             ("mm_wgrad", (1000, 64, 256)), ("mm_wgrad", (147, 2048, 512)),
             ("cv", (2, 14, 14, 64, 128)), ("cv_dgrad", (2, 14, 14, 64, 128)))
# kernels 1-5 at a channel width that is not a multiple of 8 (a
# FusedBottleneck of width 12): the wrappers zero-pad the channels to 16,
# launch once and copy the operands once (fm.COPIES)
WIDTH12_CASES = (("mm", (6272, 12, 12)), ("mm_dgrad", (6272, 12, 12)),
                 ("mm_wgrad", (6272, 12, 12)), ("cv", (2, 56, 56, 12, 12)),
                 ("cv_dgrad", (2, 56, 56, 12, 12)))
# launches per train step (make_train_step, one batch): forward kernels
# twice with remat (forward and recompute), each backward kernel once
STEP_LAUNCHES = {
    True: {"fused_matmul_bn": 72, "fused_conv3x3_bn": 26,
           "fused_matmul_bn_dgrad": 36, "fused_matmul_bn_wgrad": 36,
           "fused_conv3x3_bn_dgrad": 13},
    False: {"fused_matmul_bn": 36, "fused_conv3x3_bn": 13,
            "fused_matmul_bn_dgrad": 36, "fused_matmul_bn_wgrad": 36,
            "fused_conv3x3_bn_dgrad": 13}}
OPT_ITERS = 5      # Optimizer.optimize() iterations at batch 32
SERVE_BATCHES = (1, 8, 32)  # the engines' declared batch sizes at 224x224
# launches per forward of the fused and the dynamic-int8 ResNet-50
FUSED_FWD = {"fused_matmul_bn": 36, "fused_conv3x3_bn": 13}
INT8_FWD = {"int8_matmul": 34}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_memory(what: str):
    """Print the card's allocated and reserved memory (a phase that
    leaks live tensors leaves the captures after it less headroom)."""
    import torch

    print(f"device memory {what}: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved",
          flush=True)


def call_ms(fn):
    """Per call, eager, CUDA events: host launch cost included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(ITERS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / ITERS


def device_ms(fn, reps=10):
    """Per call on the device alone: ``reps`` calls captured in one
    CUDA graph, replayed ``ITERS`` times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(ITERS):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (ITERS * reps)


# the hand-written kernels by the symbol of the one kernel each launch
# runs (the column-sum, split-sum and reduce passes beside some are not
# counted); the f32 paths' templates tell the conv from the matmul
KERNEL_SYMBOLS = (("conv3_dgrad_wgmma", "fused_conv3x3_bn_dgrad"),
                  ("mm_dgrad_wgmma", "fused_matmul_bn_dgrad"),
                  ("conv3_wgmma", "fused_conv3x3_bn"),
                  ("wgrad_wgmma", "fused_matmul_bn_wgrad"),
                  ("wgrad_kernel<", "fused_matmul_bn_wgrad"),
                  ("mm_wgmma", "fused_matmul_bn"),
                  ("flash_fwd_", "flash_attention"),
                  ("int8_mm_kernel", "int8_matmul"))


def kernel_of(name: str):
    """The wrapper whose launch ran the device kernel ``name``, or None."""
    name = name.replace("(anonymous namespace)", "").split("(")[0]
    for sym, wrapper in KERNEL_SYMBOLS:
        if sym in name:
            return wrapper
    conv = "true>" in name
    if "fused_gemm_bn_kernel" in name:
        return "fused_conv3x3_bn" if conv else "fused_matmul_bn"
    if "fused_dgrad_kernel" in name:
        return "fused_conv3x3_bn_dgrad" if conv else "fused_matmul_bn_dgrad"
    return None


def replay_kernels(fn, by_kernel=False):
    """The hand-written kernels one call of ``fn`` (a graph replay) runs
    on the card, counted by their symbols in a torch.profiler trace, and
    the device ms of all its kernels and copies; with ``by_kernel``
    also the device ms of each hand-written kernel's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got, device_us, kernel_us = Counter(), 0.0, Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us += evt.device_time_total
            wrapper = kernel_of(evt.name)
            if wrapper is not None:
                got[wrapper] += 1
                kernel_us[wrapper] += evt.device_time_total
    if by_kernel:
        return dict(got), device_us / 1e3, {
            k: v / 1e3 for k, v in kernel_us.items()}
    return dict(got), device_us / 1e3


def kernel_ms(fn, top=6):
    """Device ms of one call of ``fn`` by torch.profiler: the total and
    the ``top`` kernels (names cut at 70 characters) by their ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got = Counter()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            got[evt.key.replace("(anonymous namespace)::", "")[:70]] += \
                getattr(evt, "device_time_total",
                        getattr(evt, "cuda_time_total", 0)) / 1e3
    return sum(got.values()), {k: round(v, 4) for k, v in
                               got.most_common(top)}


def replay_ms(graph, n=50) -> float:
    """Wall ms per replay of a CUDA graph over ``n`` back-to-back
    replays, between CUDA events."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def check_graph(what: str, compiled, want: dict, replay) -> dict:
    """The kernels of one compiled call, exactly: the launches its capture
    counted on the host and the kernels one replay runs on the card (by
    profiler) must both be ``want``."""
    ran, device = replay_kernels(replay)
    if compiled.launches != want or ran != want:
        fail(f"{what}: the capture launched {compiled.launches} and a replay "
             f"ran {ran}; expected {want}")
    return {"kernels": ran, "replay_device_ms": device}


def host_launches(per_capture: dict, captures: int) -> dict:
    """The launches the host counts for ``captures`` compiles of a call
    launching ``per_capture``: the warm-up calls and the capture."""
    from bigdl_tpu_torch.utils import graphs

    return {k: (graphs.WARMUP + 1) * captures * v
            for k, v in per_capture.items()}


def check_steady(what: str, engine, batches: int, replays: int):
    """After warmup a serving engine compiles nothing more, and serves
    every batch by one graph replay."""
    declared = len(engine.declared_buckets)
    if batches == 0 or engine.recompiles != declared or replays != batches:
        fail(f"{what}: {engine.recompiles} compiles for {declared} declared "
             f"buckets, {replays} replays for {batches} batches")


def resnet50_calls(batch: int):
    """Kernel calls of one fused ResNet-50 forward at ``batch``:
    Counter of (M, K, N, prologue) and of (B, H, W, C, Co).  The
    backward kernels run once per forward call, at the same shapes."""
    mm, cv = Counter(), Counter()
    n_in, res = 64, 56
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ro = res // s
            mm[(batch * res * res, n_in, planes, False)] += 1
            if s == 1:
                cv[(batch, res, res, planes, planes)] += 1
            mm[(batch * ro * ro, planes, 4 * planes, True)] += 1
            if s != 1 or n_in != 4 * planes:
                mm[(batch * ro * ro, n_in, 4 * planes, False)] += 1
            n_in, res = 4 * planes, ro
    return mm, cv


# ---------------------------------------------------------------- LM slice
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# flash kernel vs its plain version (same key blocks, same rounding
# points): O within one bf16 step at the largest |O| (f32: 1e-5 of it),
# lse (f32 in both types) within 1e-5 of the largest |lse|
FLASH_CASES = (  # (B, H, T, S, D), causal, dtype, as the main path gives it
    ((8, 8, 512, 512, 32), True, "bf16", "mha"),  # LM default, head view
    ((1, 2, 1024, 1024, 128), False, "bf16", ""),  # kernel_shapes FLASH
    ((2, 4, 1000, 1000, 64), True, "bf16", ""),    # ragged T
    ((2, 4, 256, 640, 64), False, "bf16", ""),     # KV longer than Q
    ((8, 8, 512, 512, 32), True, "f32", "mha"),    # evaluation's f32
    ((1, 8, 8192, 8192, 128), True, "bf16", ""),   # long context
    ((8, 8, 4096, 4096, 32), True, "bf16", "mha"),  # LM's long step
    ((2, 4, 256, 256, 12), True, "bf16", ""),  # the decode model's D
    ((2, 4, 300, 300, 8), False, "bf16", ""),  # D padded to 32
    # --numHeads 1 of the LM driver: one head of 256, as the step and the
    # evaluation forward give it, causal and not
    ((8, 1, 512, 512, 256), True, "bf16", "mha"),
    ((8, 1, 512, 512, 256), False, "bf16", "mha"),
    ((8, 1, 512, 512, 256), True, "f32", "mha"),
    ((8, 1, 512, 512, 256), False, "f32", "mha"),
    ((2, 4, 384, 384, 200), True, "bf16", ""),  # D padded to 256
)
LM = dict(vocab_size=10001, hidden_size=256, num_heads=8, filter_size=1024,
          num_layers=4)  # bigdl_tpu/models/transformer_train.py defaults
LM_BATCH, LM_SEQ, LM_LONG_SEQ = 8, 512, 4096
# one LM train step, flash kernel vs the plain attention path
# (use_flash=False: f32 scores, one softmax), same weights, same dropout
# seeds: loss relative error and, per leaf, the relative L2 error of
# Adam's m (0.1 x the clipped gradient).  f32 differs by sum order only;
# bf16 rounds p against a running max in the kernel and against the
# row max in the plain path (0.066 max at the CPU tests' size against
# JAX); a missing or mis-scaled gradient is 1 or more.
LM_F32_TOL = {"loss": 1e-5, "grad": 1e-3}
LM_BF16_TOL = {"loss": 2e-2, "grad": 0.25}


def flash_bound(shape, causal, dt):
    """(bytes ms, operations ms) of kernel 6's formula in the package
    (``flash_cost``: q, k, v read once, O and the f32 lse written once;
    4*B*H*T*S*D operations, halved under causal) over the memory rate
    and the bf16 tensor-core peak (f32: the f32 peak)."""
    from bigdl_tpu_torch.ops.flash_attention import flash_cost

    ops, nbytes = flash_cost(*shape, causal, 2 if dt == "bf16" else 4)
    peak = PEAK_BF16_FLOPS if dt == "bf16" else PEAK_F32_FLOPS
    return nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3


def flash_phase(gen, timing: bool):
    """Hold the flash kernel against flash_attention_plain at every case
    and, with ``timing``, time the kernel, the plain version and SDPA
    (the yardstick, never on the port's path).  Returns the case rows
    and the largest bf16 |O| error."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rows, max_err = [], 0.0
    for shape, causal, dt, layout in FLASH_CASES:
        b, h, t, s, d = shape
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32

        def rand(n):
            if layout == "mha":  # (N, T, H, D) viewed as (N, H, T, D)
                return torch.randn((b, n, h, d), generator=gen, device=dev
                                   ).to(dtype).transpose(1, 2)
            return torch.randn((b, h, n, d), generator=gen, device=dev
                               ).to(dtype)

        q, k, v = rand(t), rand(s), rand(s)
        fa.reset_launches()
        o, lse = fa.flash_attention_lse(q, k, v, causal)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        po, pl = fa.flash_attention_plain(q, k, v, causal)
        err = (o.float() - po.float()).abs().max().item()
        lse_err = (lse - pl).abs().max().item()
        scale = po.float().abs().max().item()
        tol = (2.0 ** (math.floor(math.log2(scale)) - 7) if dt == "bf16"
               else 1e-5 * scale)
        name = f"flash_attention{shape} causal={causal} {dt} {layout}"
        if (not torch.isfinite(o.float()).all() or err > tol
                or lse_err > 1e-5 * pl.abs().max().item() or launches != 1):
            fail(f"{name}: kernel disagrees with the plain version: max "
                 f"|dO| {err:.4g} (limit {tol:.4g}), max |dlse| "
                 f"{lse_err:.4g}; {launches} launches (expected 1)")
        if dt == "bf16":
            max_err = max(max_err, err)
        r = {"shape": list(shape), "causal": causal, "dtype": dt,
             "layout": layout or "contiguous", "max_abs_err": err,
             "lse_err": lse_err, "launches": launches}
        if timing:
            sm = 1.0 / math.sqrt(d)
            r.update(
                ms=device_ms(lambda: fa.flash_attention_lse(q, k, v, causal)),
                plain_ms=device_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal), reps=2),
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=sm)))
            r["bytes_ms"], r["ops_ms"] = flash_bound(shape, causal, dt)
            r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
            print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                  f"SDPA {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}); "
                  f"max |dO| {err:.3g}", flush=True)
        rows.append(r)
        del q, k, v, o, lse, po, pl
    print(f"flash kernel checks passed: {len(rows)} cases, max bf16 "
          f"|kernel - plain| {max_err:.4g}", flush=True)
    return rows, max_err


def lm_variables(model, seed, embed_scale=1.0):
    """Random LM weights made with numpy from ``seed``, shaped as the
    model's JAX tree: the embedding N(0, d^-1/2) as the LM initialises
    it (times ``embed_scale``), (in, out) weights N(0, 1/in), LayerNorm
    weights 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    import numpy as np

    from bigdl_tpu_torch.utils import export_variables

    rs = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            shape = np.shape(v)
            if k == "weight" and len(shape) == 2:  # embedding
                a = embed_scale * rs.randn(*shape) * shape[1] ** -0.5
            elif len(shape) == 2:
                a = rs.randn(*shape) / math.sqrt(shape[0])
            elif k == "weight":
                a = 1.0 + 0.1 * rs.randn(*shape)
            else:
                a = 0.1 * rs.randn(*shape)
            out[k] = a.astype(np.float32)
        return out

    return {"params": fill(export_variables(model)["params"]), "state": {}}


def lm_phase(args):
    """The LM slice's main path: one train step against the plain
    attention path in bf16 and f32, exact launches per forward, ms per
    step, tokens/s and peak memory at T 512 and 4096 with a profiler
    breakdown, then ``transformer_train.main([])``.  Returns the
    results and the main path's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import transformer_train
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim import Adam, make_train_step
    from bigdl_tpu_torch.utils import graphs, load_jax_variables

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(logits=True))
    model = nn.Transformer(**LM, dropout=0.1).to(dev)
    variables = lm_variables(model, args.seed)
    load_jax_variables(model, variables)
    reference = nn.Transformer(**LM, dropout=0.1, use_flash=False).to(dev)
    load_jax_variables(reference, variables)
    rs = np.random.RandomState(args.seed + 5)

    def batch(t):
        return [torch.from_numpy(rs.randint(0, LM["vocab_size"],
                                            (LM_BATCH, t))).to(dev)
                for _ in range(2)]

    def trees(m):
        params = {k: p.detach().clone() for k, p in m.named_parameters()}
        return params, {}, {"__all__": Adam(1e-3).init_state(params)}

    def steps(m, dtype):
        return make_train_step(m, crit, {"__all__": Adam(1e-3)},
                               grad_clip_norm=1.0, compute_dtype=dtype)

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()

    # one step, kernel path vs plain attention path, and launches
    x, y = batch(LM_SEQ)
    parity = {}
    for what, dtype, tol in (("bf16", bf16, LM_BF16_TOL),
                             ("f32", None, LM_F32_TOL)):
        fa.reset_launches()
        pk, _, ok, lk = steps(model, dtype)(*trees(model), 1, args.seed, x,
                                            y, [1e-3])
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        pp, _, op_, lp = steps(reference, dtype)(*trees(reference), 1,
                                                 args.seed, x, y, [1e-3])
        if launches != LM["num_layers"]:
            fail(f"LM {what} train step launched the flash kernel "
                 f"{launches} times, expected {LM['num_layers']}")
        mk, mp = ok["__all__"]["m"], op_["__all__"]["m"]
        bad = [k for k in pk if not (torch.isfinite(pk[k]).all()
                                     and torch.isfinite(mk[k]).all())]
        if bad or not math.isfinite(lk.item()):
            fail(f"LM {what} step: non-finite loss, gradients or "
                 f"parameters {bad[:4]}")
        grad = {k: rel(mk[k], mp[k]) for k in mk}
        err = {"loss": abs(lk.item() - lp.item()) / abs(lp.item()),
               "grad": max(grad.values())}
        worst = max(grad, key=grad.get)
        parity[what] = {"loss": lk.item(), "plain_loss": lp.item(), **err,
                        "grad_median": sorted(grad.values())[len(grad) // 2],
                        "worst_leaf": worst}
        print(f"LM step parity, {what} (flash kernel vs plain attention): "
              f"loss {lk.item():.6g} vs {lp.item():.6g} (rel "
              f"{err['loss']:.3g}); gradient rel L2 per leaf max "
              f"{err['grad']:.3g} ({worst}), median "
              f"{parity[what]['grad_median']:.3g}; {launches} launches",
              flush=True)
        over = {k: (err[k], t) for k, t in tol.items() if err[k] > t}
        if over:
            fail(f"LM {what} step disagrees with the plain path: "
                 f"(error, limit) {over}")
    with torch.no_grad():
        fa.reset_launches()
        logits = model.eval()(x)
        torch.cuda.synchronize()
    if fa.LAUNCHES["flash_attention"] != LM["num_layers"] or not bool(
            torch.isfinite(logits.float()).all()) or tuple(
            logits.shape) != (LM_BATCH, LM_SEQ, LM["vocab_size"]):
        fail(f"LM eval forward: {fa.LAUNCHES} launches, logits "
             f"{tuple(logits.shape)}")
    del logits, reference

    # speed and memory at the trainer's step (bf16 compute, dropout)
    step = steps(model, bf16)
    speed = {}
    for t in (LM_SEQ, LM_LONG_SEQ):
        x, y = batch(t)
        tr = trees(model)
        for i in range(3):
            *tr, loss = step(*tr, i + 1, i, x, y, [1e-3])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(10):
            *tr, loss = step(*tr, i + 4, i + 3, x, y, [1e-3])
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / 10
        speed[t] = {"ms_per_step": ms,
                    "tokens_per_s": LM_BATCH * t / ms * 1e3,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "loss": loss.item()}
        if not math.isfinite(speed[t]["loss"]):
            fail(f"LM: non-finite loss at T {t}")
        print(f"LM train step at batch {LM_BATCH}, T {t}: {ms:.3f} ms, "
              f"{speed[t]['tokens_per_s']:.0f} tokens/s, peak memory "
              f"{speed[t]['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        del tr

    # where one step's device time goes: the whole step under the
    # profiler, and the flash backward (plain PyTorch) alone at the same
    # shapes, so that its matrix products are not counted twice
    def device_kernels(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = Counter()
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                got[evt.key] += getattr(evt, "device_time_total",
                                        getattr(evt, "cuda_time_total",
                                                0)) / 1e3
        return got

    def is_matmul(key):
        return any(w in key.lower() for w in ("gemm", "xmma", "cutlass",
                                              "nvjet", "splitk"))

    x, y = batch(LM_SEQ)
    tr = trees(model)
    step_k = device_kernels(lambda: step(*tr, 1, 0, x, y, [1e-3]))
    hd = LM["hidden_size"] // LM["num_heads"]
    qkv = [torch.randn((LM_BATCH, LM_SEQ, LM["num_heads"], hd), device=dev
                       ).to(bf16).transpose(1, 2) for _ in range(3)]
    o, lse = fa.flash_attention_lse(*qkv, True)
    g = torch.randn_like(o)
    bwd_k = device_kernels(lambda: [fa._flash_backward(
        *qkv, o, lse, g, True, hd ** -0.5) for _ in range(LM["num_layers"])])
    total = sum(step_k.values())
    flash_fwd = sum(v for k, v in step_k.items() if "flash_fwd_" in k)
    bwd = sum(bwd_k.values())
    bwd_mm = sum(v for k, v in bwd_k.items() if is_matmul(k))
    mm = sum(v for k, v in step_k.items() if is_matmul(k)) - bwd_mm
    breakdown = {"kernel 6 (flash forward, 4 calls)": flash_fwd,
                 "flash backward (plain PyTorch, 4 calls, timed alone)": bwd,
                 "matrix products outside the flash backward": mm,
                 "the rest (log-softmax, LayerNorm, dropout, Adam, casts, "
                 "embedding)": total - flash_fwd - bwd - mm}
    breakdown = {k: round(v, 3) for k, v in breakdown.items()}
    print(f"one LM step at batch {LM_BATCH}, T {LM_SEQ}, device ms by part "
          f"(torch.profiler, {total:.3f} ms in all): {breakdown}",
          flush=True)
    top = {k: round(v, 3) for k, v in step_k.most_common(10)}
    del qkv, o, lse, g, model, tr

    # the user entry point, as a user runs it: its flash launches are the
    # main path's count
    train_ids, valid_ids, _ = transformer_train._load_corpus(
        None, LM["vocab_size"], 16 * LM_SEQ * LM_BATCH)
    n_train = transformer_train._window_dataset(
        train_ids, LM_BATCH, LM_SEQ).batches_per_epoch()
    n_val = transformer_train._window_dataset(
        valid_ids, LM_BATCH, LM_SEQ).batches_per_epoch()
    epochs = 5  # the driver's --maxEpoch default
    # two compiled calls (the train step and the evaluation forward, one
    # batch shape each): each capture launches the kernel once per layer,
    # and every iteration and validation batch is a replay
    replays = epochs * n_train + epochs * n_val + n_val
    want = host_launches({"flash_attention": LM["num_layers"]}, 2)[
        "flash_attention"]
    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "Loss is " in msg:
                losses.append(msg)

    grab = Losses()
    logging.getLogger("bigdl_tpu_torch.optim").addHandler(grab)
    fa.reset_launches()
    graphs.reset_counts()
    t0 = time.perf_counter()
    res = transformer_train.main([])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fa.LAUNCHES["flash_attention"]
    counts = dict(graphs.COUNTS)
    logging.getLogger("bigdl_tpu_torch.optim").removeHandler(grab)
    # "... Loss is 9.2103. compute: ..." (optimizer.py's log line)
    train_losses = [float(m.split("Loss is ")[1].split(". ")[0])
                    for m in losses if m.startswith("[Epoch")]
    val_lines = [m for m in losses if m.startswith("Loss is Loss(")]
    if launches != want or counts["captures"] != 2 or \
            counts["replays"] != replays:
        fail(f"transformer_train.main([]) launched the flash kernel "
             f"{launches} times in {counts['captures']} captures and "
             f"{counts['replays']} replays, expected {want} in 2 captures "
             f"(the train step and the evaluation forward; "
             f"{graphs.WARMUP + 1} calls each) and {replays} replays (5 x "
             f"{n_train} iterations + 6 x {n_val} validation batches)")
    if not (math.isfinite(res["val_loss"]) and train_losses
            and res["val_loss"] < train_losses[0]
            and len(val_lines) == epochs):
        fail(f"transformer_train.main([]): loss did not fall or validation "
             f"missing: first train loss {train_losses[:1]}, "
             f"{len(val_lines)} validations, result {res}")
    print(f"transformer_train.main([]): {epochs} epochs of {n_train} "
          f"iterations in {main_s:.1f} s, first loss {train_losses[0]}, "
          f"validation {val_lines[0]} -> {val_lines[-1]}, final "
          f"{res}; flash launches {launches} in {counts['captures']} "
          f"captures ({counts['capture_seconds']:.2f} s), "
          f"{counts['replays']} replays", flush=True)
    # --numHeads 1: one head of 256 (kernel 6 at D 256).  A bf16 step
    # against the plain attention path, then transformer_train for one epoch:
    # the compiled step and evaluation forward, 4 launches per capture
    wide = dict(LM, num_heads=1)
    m1 = nn.Transformer(**wide, dropout=0.1).to(dev)
    v1 = lm_variables(m1, args.seed)
    load_jax_variables(m1, v1)
    r1 = nn.Transformer(**wide, dropout=0.1, use_flash=False).to(dev)
    load_jax_variables(r1, v1)
    x, y = batch(LM_SEQ)
    fa.reset_launches()
    _, _, ok, lk = steps(m1, bf16)(*trees(m1), 1, args.seed, x, y, [1e-3])
    torch.cuda.synchronize()
    launches1 = fa.LAUNCHES["flash_attention"]
    _, _, op_, lp = steps(r1, bf16)(*trees(r1), 1, args.seed, x, y, [1e-3])
    grad = {k: rel(ok["__all__"]["m"][k], op_["__all__"]["m"][k])
            for k in ok["__all__"]["m"]}
    err = {"loss": abs(lk.item() - lp.item()) / abs(lp.item()),
           "grad": max(grad.values())}
    print(f"LM step parity at --numHeads 1 (D 256), bf16: loss "
          f"{lk.item():.6g} vs {lp.item():.6g} (rel {err['loss']:.3g}); "
          f"gradient rel L2 per leaf max {err['grad']:.3g}; {launches1} "
          "launches", flush=True)
    if launches1 != LM["num_layers"] or not math.isfinite(lk.item()) or \
            any(err[k] > t for k, t in LM_BF16_TOL.items()):
        fail(f"LM step at --numHeads 1: {launches1} launches, errors {err} "
             f"(limits {LM_BF16_TOL})")
    del m1, r1, ok, op_
    fa.reset_launches()
    graphs.reset_counts()
    t0 = time.perf_counter()
    res1 = transformer_train.main(["--numHeads", "1", "--maxEpoch", "1"])
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_main = {"seconds": wide_s, "result": res1,
                 "launches": fa.LAUNCHES["flash_attention"],
                 "graphs": dict(graphs.COUNTS), "parity": err}
    print(f"transformer_train.main(['--numHeads', '1', '--maxEpoch', '1']):"
          f" {wide_s:.1f} s, {res1}; flash launches "
          f"{wide_main['launches']} in {wide_main['graphs']['captures']} "
          f"captures, {wide_main['graphs']['replays']} replays", flush=True)
    if wide_main["launches"] != want or \
            wide_main["graphs"]["captures"] != 2 or \
            wide_main["graphs"]["replays"] != n_train + 2 * n_val or \
            not math.isfinite(res1["val_loss"]):
        fail(f"transformer_train --numHeads 1: {wide_main}, expected "
             f"{want} launches in 2 captures and {n_train + 2 * n_val} "
             "replays")
    return {"parity": parity, "speed": speed, "breakdown": breakdown,
            "step_top_kernels": top, "main": {
                "seconds": main_s, "result": res, "launches": launches,
                "graphs": counts,
                "train_losses": train_losses, "validation": val_lines},
            "num_heads_1": wide_main}


# ------------------------------------------------------------ quant slice
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)
QUANT_BATCH = 32         # the quantized ResNet-50 forward kernel 7 is timed at
MLP = (8192, 8192, 1000)  # tools/quant_bench.py's large-FC MLP widths
MLP_BATCH = 8
# kernel 7 beyond one quantized ResNet-50 forward: (M, K, N), w_q's layout
# ("nk": the (K, N) view of a contiguous (N, K) tensor, as the quantized
# layers hold their weights and int8_scores will pass k_q.T; "kn": a
# contiguous (K, N) tensor, which the wrapper copies K-major), what it is
INT8_EXTRA = (
    ((4096, 768, 3072), "nk", "kernel_shapes.INT8, FFN in"),
    ((4096, 3072, 768), "nk", "kernel_shapes.INT8, FFN out"),
    ((8, 128, 4096), "nk", "kernel_shapes.INT8, int8 KV scores (k_q.T view)"),
    ((8, 8192, 8192), "nk", "large-FC MLP hidden layers"),
    ((8, 8192, 1000), "nk", "large-FC MLP head"),
    ((37, 200, 1000), "kn", "ragged M, K and N; w_q copied K-major, x "
     "padded"),
    ((300, 100, 37), "kn", "ragged K and N; w_q copied, x and y padded"),
)
# the served batches of the quantized ResNet-50: their int8 shapes are
# held against the plain version too (not timed)
INT8_SERVED_BATCHES = (1, 8)
# whole quantized ResNet-50, kernel path vs plain path on the same images:
# the kernel is bit-equal to its plain version, so this is 0 unless cuDNN
# picks another algorithm for a library conv; of the largest |logit|
QUANT_PARITY_TOL = 1e-3
# a served answer vs the same image's plain-path forward alone, relative
# L2 per image: the per-tensor activation scales depend on the batch-mates
# (measured on the CPU at 224x224 in bf16, batch of 8 vs alone: 0.57% to
# 0.98% per image; the quantization error itself is 1.1%)
SERVE_QUANT_TOL = 0.05


def int8_calls(batch: int) -> Counter:
    """(M, K, N) of the int8 matmuls of one quantized ResNet-50 forward:
    every bottleneck's conv1 and conv3 (1x1, stride 1), layer1's stride-1
    projection and the fc; the stride-2 projections, the 3x3 convs and
    the stem are library convs."""
    calls = Counter()
    n_in, res = 64, 56
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ro = res // s
            calls[(batch * res * res, n_in, planes)] += 1
            calls[(batch * ro * ro, planes, 4 * planes)] += 1
            if s == 1 and n_in != 4 * planes:
                calls[(batch * res * res, n_in, 4 * planes)] += 1
            n_in, res = 4 * planes, ro
    calls[(batch, 2048, 1000)] += 1
    return calls


def int8_bound(shape, out_size=2):
    """(bytes ms, operations ms) of kernel 7's formula in the package
    (``int8_cost``: x, w_q and the f32 scale read once, y of
    ``out_size``-byte elements, bf16 by default, written once; 2*M*N*K
    int8 operations) over the memory rate and the int8 peak."""
    from bigdl_tpu_torch.ops.int8_matmul import int8_cost

    ops, nbytes = int8_cost(*shape, out_size)
    return nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3


def int8_phase(gen, timing: bool):
    """Hold kernel 7 against int8_matmul_dequant_plain at every shape of
    one quantized ResNet-50 forward at batch 32 (and, untimed, at the
    served batches 1 and 8) and at INT8_EXTRA, bf16 and f32 out, each
    twice (the split-K workspace must come back clean), requiring max
    |d| = 0 and, where w_q has the layers' K-major layout and the shape
    is aligned, no operand copy; with ``timing``, time the kernel, the
    plain version and torch._int_mm plus the same epilogue (the
    yardstick, never on the port's path).  Returns the rows of the timed
    cases."""
    import torch

    from bigdl_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")

    def randint8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)

    cases = [(shape, "nk", f"ResNet-50 forward, {c} call(s)", c, True)
             for shape, c in sorted(int8_calls(QUANT_BATCH).items())]
    cases += [(shape, layout, what, 0, True)
              for shape, layout, what in INT8_EXTRA]
    cases += [(shape, "nk", f"ResNet-50 forward at batch {b}", 0, False)
              for b in INT8_SERVED_BATCHES
              for shape in sorted(int8_calls(b))]
    rows, checked = [], 0
    for (m, k, n), layout, what, count, timed in cases:
        x = randint8(m, k)
        w = randint8(n, k).t() if layout == "nk" else randint8(k, n)
        s = (torch.rand(n, generator=gen, device=dev) + 0.05) * 1e-4
        for dtype in (torch.bfloat16, torch.float32):
            ref = im.int8_matmul_dequant_plain(x, w, s, dtype)
            for run in range(2):
                im.reset_launches()
                y = im.int8_matmul_dequant(x, w, s, dtype)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                if err != 0 or not torch.equal(y, ref):
                    fail(f"int8_matmul{(m, k, n)} {layout} {dtype} run "
                         f"{run + 1}: kernel differs from the plain "
                         f"version, max |d| {err:.4g}")
                copies = (im.LAUNCHES["int8_matmul_w_relayout"],
                          im.LAUNCHES["int8_matmul_pad"])
                if layout == "nk" and k % 16 == 0 and n % 8 == 0 \
                        and copies != (0, 0):
                    fail(f"int8_matmul{(m, k, n)} {layout}: operand copies "
                         f"(relayout, pad) {copies} for an aligned K-major "
                         "weight")
            checked += 1
        if not timed:
            continue
        r = {"shape": [m, k, n], "layout": layout, "what": what,
             "calls_per_forward": count, "max_abs_err": 0.0,
             "plan": im._int8_plan(m, k, n, im._sms(dev))._asdict()}
        if timing:
            # _int_mm wants M > 16 and K, N multiples of 8; it is timed at
            # the shape padded up to one it takes
            mp, kp, np_ = (-(-max(m, 17) // 8) * 8, -(-k // 8) * 8,
                           -(-n // 8) * 8)
            xp = torch.zeros((mp, kp), dtype=torch.int8, device=dev)
            xp[:m, :k] = x
            wp = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
            wp[:k, :n] = w
            r["library_shape"] = [mp, kp, np_]

            def library():
                acc = torch._int_mm(xp, wp)
                return (acc[:m, :n].float() * s).to(torch.bfloat16)

            try:  # cuBLASLt refuses some padded shapes ((304, 104, 40)
                library()  # on an H100): then there is no library call
                library_ms = device_ms(library)
            except RuntimeError as e:
                print(f"  _int_mm refused {(mp, kp, np_)}: {e}", flush=True)
                library_ms = None
            r.update(
                ms=device_ms(lambda: im.int8_matmul_dequant(x, w, s)),
                plain_ms=device_ms(lambda: im.int8_matmul_dequant_plain(
                    x, w, s), reps=2),
                library_ms=library_ms)
            r["bytes_ms"], r["ops_ms"] = int8_bound((m, k, n))
            r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
            pad = "" if [mp, kp, np_] == [m, k, n] else \
                f" (_int_mm at {(mp, kp, np_)})"
            lib = "none" if library_ms is None else f"{library_ms:.4f}"
            print(f"  int8_matmul{(m, k, n)} {layout} [{what}]: "
                  f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, _int_mm "
                  f"{lib}{pad}, bound {r['bound_ms']:.4f})", flush=True)
            del xp, wp
        rows.append(r)
        del x, w, s
    print(f"int8 kernel checks passed: {checked // 2} shapes, bf16 and "
          "f32 output, each twice, max |kernel - plain| 0", flush=True)
    return rows


def quant_phase(args, out):
    """The quantization slice's main path on the unfused ResNet-50 at 224:
    launches per forward, the kernel path against the plain path, the
    quantization error, save_quantized/load_quantized and 512 requests
    through PredictionService (the main path's launches), then the
    counterpart of tools/quant_bench.py with a profiler breakdown."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.ops import int8_matmul as im
    from bigdl_tpu_torch.optim import PredictionService
    from bigdl_tpu_torch.utils import (export_variables, flatten, graphs,
                                       load_jax_variables, random_variables)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    model = ResNet50(1000)  # unfused, conv7 stem
    variables = random_variables(export_variables(model), args.seed)
    load_jax_variables(model, variables)
    t0 = time.perf_counter()
    qmodel, qvars = nn.quantize(model, variables)
    quantize_s = time.perf_counter() - t0
    wmodel, _ = nn.quantize(model, variables, weight_only=True)
    rs = np.random.RandomState(args.seed + 6)
    images = rs.randn(REQUESTS, 224, 224, 3).astype(np.float32)
    xb = torch.from_numpy(images[:QUANT_BATCH]).to(dev)
    res = {"quantize_s": quantize_s}

    def rel_l2(a, b):  # per row, of b
        return ((a.float() - b.float()).norm(dim=-1)
                / b.float().norm(dim=-1).clamp_min(1e-30))

    def no_copies(what):
        """The layers' weights are K-major and the main path's shapes
        aligned: kernel 7 must not copy an operand."""
        copies = {key: im.LAUNCHES[key] for key in
                  ("int8_matmul_w_relayout", "int8_matmul_pad")}
        if any(copies.values()):
            fail(f"{what}: kernel 7 copied operands {copies}")
        res.setdefault("operand_copies", {})[what] = copies

    # launches per forward, and the shapes the wrapper was given
    with torch.inference_mode():
        im.reset_launches()
        with im.record_calls() as calls:
            qmodel(xb.to(bf16))
            torch.cuda.synchronize()
        fwd_launches = im.LAUNCHES["int8_matmul"]
        seen = Counter(c[:3] for c in calls)
        if fwd_launches != 34 or seen != int8_calls(QUANT_BATCH):
            fail(f"quantized ResNet-50 forward: {fwd_launches} int8 "
                 f"launches at shapes {dict(seen)}, expected 34 at "
                 f"{dict(int8_calls(QUANT_BATCH))}")
        no_copies("quantized ResNet-50 forward")
        im.reset_launches()
        wmodel(xb.to(bf16))
        torch.cuda.synchronize()
        wo_launches = im.LAUNCHES["int8_matmul"]
        if wo_launches != 0:
            fail(f"weight_only forward launched the int8 kernel "
                 f"{wo_launches} times")
    res["launches"] = {"dynamic_forward": fwd_launches,
                       "weight_only_forward": wo_launches}

    # the kernel path against the plain path, and the quantization error
    # against the float model in bf16 (parameters cast, as quant_bench)
    res["parity"] = {}
    with torch.inference_mode():
        for name, dtype in (("bf16", bf16), ("f32", torch.float32)):
            yk = qmodel(xb.to(dtype)).float()
            nn.use_plain_ops(qmodel, True)
            yp = qmodel(xb.to(dtype)).float()
            nn.use_plain_ops(qmodel, False)
            err = (yk - yp).abs().max().item()
            scale = yp.abs().max().item()
            res["parity"][name] = {"max_abs_err": err, "max_abs_logit": scale}
            print(f"quantized ResNet-50 at batch {QUANT_BATCH}, {name}: "
                  f"kernel path vs plain path max |d logit| {err:.4g} (max "
                  f"|logit| {scale:.4g})", flush=True)
            if (tuple(yk.shape) != (QUANT_BATCH, 1000)
                    or not torch.isfinite(yk).all()
                    or err > QUANT_PARITY_TOL * scale):
                fail(f"quantized ResNet-50 {name}: kernel path disagrees "
                     f"with the plain path ({err:.4g} > {QUANT_PARITY_TOL} x "
                     f"{scale:.4g}) or bad logits {tuple(yk.shape)}")
        for p in model.parameters():
            p.data = p.data.to(bf16)
        yq = qmodel(xb.to(bf16)).float()
        yf = model(xb.to(bf16)).float()
        qerr = rel_l2(yq, yf)
        res["quant_error"] = {
            "rel_l2_median": qerr.median().item(),
            "rel_l2_max": qerr.max().item(),
            "top1_agreement": (yq.argmax(-1) == yf.argmax(-1)
                               ).float().mean().item()}
    print(f"quantization error vs the float model in bf16: relative L2 per "
          f"image median {res['quant_error']['rel_l2_median']:.4g}, max "
          f"{res['quant_error']['rel_l2_max']:.4g}; top-1 agreement "
          f"{res['quant_error']['top1_agreement']:.3f}", flush=True)

    # the user path: save, load into a fresh float model, serve
    path = out / "resnet50_int8.npz"
    nn.save_quantized(str(path), qmodel, qvars)
    res["file_bytes"] = path.stat().st_size
    qmodel2, qvars2 = nn.load_quantized(str(path), ResNet50(1000))
    path.unlink()  # 26 MB; the output directory keeps only results
    fa, fb = flatten(qvars["params"]), flatten(qvars2["params"])
    loaded = flatten(export_variables(qmodel2)["params"])
    if sorted(fa) != sorted(fb) or any(
            fa[k].dtype != fb[k].dtype or not np.array_equal(fa[k], fb[k])
            or not np.array_equal(loaded[k], fa[k]) for k in fa):
        fail("load_quantized did not give back the saved leaves")
    nbytes = {"int8_params": sum(a.nbytes for a in fa.values()),
              "f32_params": sum(a.nbytes for a in
                                flatten(variables["params"]).values())}
    if nbytes["int8_params"] >= 0.3 * nbytes["f32_params"]:
        fail(f"quantized parameters {nbytes}: not < 0.3 x the f32 bytes")
    res["bytes"] = nbytes
    im.reset_launches()
    graphs.reset_counts()
    svc = PredictionService(qmodel2, qvars2, buckets=[(224, 224, 3)],
                            batch_sizes=SERVE_BATCHES, input_dtype=bf16)
    answers = [None] * REQUESTS
    errors = []
    n_clients = 4

    def client(idx):
        try:
            qs = [(i, svc.predict_async(images[i]))
                  for i in range(idx, REQUESTS, n_clients)]
            for i, q in qs:
                v = q.get(timeout=300)
                if isinstance(v, Exception):
                    raise v
                answers[i] = v
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    serve_launches = im.LAUNCHES["int8_matmul"]
    no_copies("quantized serving")
    batches = svc.metrics.batches
    check_steady("quantized serve", svc.engine, batches,
                 graphs.COUNTS["replays"])
    captures = svc.engine.recompiles
    p50, p99 = svc.metrics.latency_ms(50), svc.metrics.latency_ms(99)
    log_line = svc.engine.log_line()
    ser = svc.decode_response(svc.predict_serialized(
        svc.encode_request(images[:4])))
    svc.close()
    if errors:
        fail(f"PredictionService client errors: {errors[:3]}")
    if serve_launches != host_launches(INT8_FWD, captures)["int8_matmul"] \
            or any(g.launches != INT8_FWD
                   for g in svc.engine._compiled.values()):
        fail(f"served {batches} batches with {serve_launches} int8 launches "
             f"over {captures} captures, expected {INT8_FWD} per capture "
             "and none per replay")
    got = np.stack(answers)
    if got.shape != (REQUESTS, 1000) or not np.isfinite(got).all() or \
            ser.shape != (4, 1000) or not np.isfinite(ser).all():
        fail(f"served answers {got.shape}, serialized {ser.shape}, or "
             "non-finite values")
    # each answer against the plain-path forward of the same image alone
    nn.use_plain_ops(qmodel2, True)
    with torch.inference_mode():
        alone = torch.cat([qmodel2(torch.from_numpy(images[i:i + 1]).to(dev)
                                   .to(bf16)).float().cpu()
                           for i in range(REQUESTS)])
    spread = rel_l2(torch.from_numpy(got), alone)
    ser_spread = rel_l2(torch.from_numpy(ser), alone[:4])
    top1 = (torch.from_numpy(got).argmax(-1) == alone.argmax(-1)
            ).float().mean().item()
    res["serve"] = {
        "requests": REQUESTS, "threads": n_clients, "batches": batches,
        "launches": serve_launches, "images_per_s": REQUESTS / wall,
        "p50_ms": p50, "p99_ms": p99,
        "rel_l2_vs_alone_median": spread.median().item(),
        "rel_l2_vs_alone_max": spread.max().item(),
        "serialized_rel_l2_max": ser_spread.max().item(),
        "top1_agreement_vs_alone": top1}
    print(f"quantized serve: {REQUESTS} requests from {n_clients} threads in "
          f"{batches} batches through PredictionService after "
          f"save_quantized/load_quantized, {REQUESTS / wall:.1f} images/s, "
          f"p50 {p50:.2f} ms, p99 {p99:.2f} ms; int8 launches "
          f"{serve_launches} over {captures} captures; vs each image alone "
          f"on the plain path: "
          f"relative L2 median {spread.median().item():.4g}, max "
          f"{spread.max().item():.4g}, top-1 agreement {top1:.3f}; "
          f"predict_serialized max {ser_spread.max().item():.4g}; parameters "
          f"{nbytes['int8_params']} bytes int8 vs {nbytes['f32_params']} f32",
          flush=True)
    print(log_line, flush=True)
    if spread.max().item() > SERVE_QUANT_TOL or \
            ser_spread.max().item() > SERVE_QUANT_TOL:
        fail(f"served answers differ from the image alone by relative L2 "
             f"{spread.max().item():.4g} (serialized "
             f"{ser_spread.max().item():.4g}) > {SERVE_QUANT_TOL}")
    del svc, qmodel2, alone, got

    # tools/quant_bench.py's three forwards, eager, CUDA events
    def fwd_ms(m, x):
        with torch.inference_mode():
            for _ in range(3):
                m(x)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(ITERS):
                m(x)
            b.record()
            b.synchronize()
        return a.elapsed_time(b) / ITERS

    xb16 = xb.to(bf16)
    bench = {"resnet50": {"batch": QUANT_BATCH,
                          "bf16_ms": fwd_ms(model, xb16),
                          "weight_only_ms": fwd_ms(wmodel, xb16),
                          "dynamic_int8_ms": fwd_ms(qmodel, xb16)}}
    mlp = nn.Sequential(nn.Linear(MLP[0], MLP[1]), nn.ReLU(),
                        nn.Linear(MLP[1], MLP[1]), nn.ReLU(),
                        nn.Linear(MLP[1], MLP[2])).to(dev).eval()
    mvars = random_variables(export_variables(mlp), args.seed + 7)
    load_jax_variables(mlp, mvars)
    mq, _ = nn.quantize(mlp, mvars)
    mw, _ = nn.quantize(mlp, mvars, weight_only=True)
    for p in mlp.parameters():
        p.data = p.data.to(bf16)
    xm = torch.randn((MLP_BATCH, MLP[0]), generator=torch.Generator(
        device=dev).manual_seed(args.seed), device=dev).to(bf16)
    with torch.inference_mode():
        im.reset_launches()
        ym = mq(xm)
        torch.cuda.synchronize()
    mlp_launches = im.LAUNCHES["int8_matmul"]
    no_copies("quantized MLP forward")
    if mlp_launches != 3 or not torch.isfinite(ym.float()).all():
        fail(f"quantized MLP forward: {mlp_launches} int8 launches "
             "(expected 3) or non-finite output")
    res["launches"]["mlp_forward"] = mlp_launches
    bench["large_fc_mlp"] = {"batch": MLP_BATCH,
                             "bf16_ms": fwd_ms(mlp, xm),
                             "weight_only_ms": fwd_ms(mw, xm),
                             "dynamic_int8_ms": fwd_ms(mq, xm)}
    res["quant_bench"] = bench
    for name, b in bench.items():
        print(f"quant_bench {name} at batch {b['batch']}: bf16 "
              f"{b['bf16_ms']:.3f} ms, weight_only int8 "
              f"{b['weight_only_ms']:.3f} ms, dynamic int8 "
              f"{b['dynamic_int8_ms']:.3f} ms", flush=True)
    del mlp, mq, mw, mvars

    # where the dynamic-int8 forward's device time goes: kernel 7, the
    # library int8 convs and the activation quantization passes (their
    # record_function ranges, kernels of the ops inside), the rest
    with torch.inference_mode():
        qmodel(xb16)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            qmodel(xb16)
            torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    parts = Counter()
    for evt in prof.events():
        if evt.name in ("int8.quantize_activation", "int8.library_conv"):
            if evt.device_type != cuda_t:
                parts[evt.name] += evt.device_time_total / 1e3
        elif evt.device_type == cuda_t:
            parts["total"] += evt.device_time_total / 1e3
            if "int8_mm_kernel" in evt.name:
                parts["kernel7"] += evt.device_time_total / 1e3
    breakdown = {
        "kernel 7 (int8 matmul, 34 calls)": parts["kernel7"],
        "library int8 convs (20 calls, f32 over int8 values, with the "
        "casts)": parts["int8.library_conv"],
        "activation quantization (54 passes: amax, divide, round, clamp, "
        "cast)": parts["int8.quantize_activation"],
        "the rest (BatchNorm, ReLU, residual adds, pools, dequant of the "
        "conv route)": parts["total"] - parts["kernel7"]
        - parts["int8.library_conv"] - parts["int8.quantize_activation"]}
    res["breakdown"] = {k: round(v, 3) for k, v in breakdown.items()}
    res["breakdown_total_ms"] = parts["total"]
    print(f"dynamic-int8 ResNet-50 forward at batch {QUANT_BATCH}, device ms "
          f"by part (torch.profiler, {parts['total']:.3f} ms in all): "
          f"{res['breakdown']}", flush=True)
    return res


# ----------------------------------------------------------- graphs phase
GRAPH_STEPS = 3   # compiled train steps held bit-equal to eager ones
TIMED_STEPS = 10  # steps timed per mode at the throughput shapes


def host_ms(fn, reps=20):
    """Wall ms per call of ``fn`` on the host, each call waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def serve_images(engine, images, n_clients=4):
    """``images`` submitted to ``engine`` by ``n_clients`` threads;
    returns the answers and the seconds it took."""
    import numpy as np

    answers = [None] * len(images)
    errors = []

    def client(idx):
        try:
            futs = [(i, engine.submit(images[i]))
                    for i in range(idx, len(images), n_clients)]
            for i, f in futs:
                answers[i] = f.result(300)
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"client errors: {errors[:3]}")
    return np.stack(answers), wall


def step_ms(step, trees, first, rng, x, y, lrs):
    """ms per step over TIMED_STEPS steps between CUDA events (after
    three untimed ones), the host's time to enqueue one, peak memory and
    the device time of one more step; ``rng(i)`` is step i's seed."""
    import torch

    for i in range(3):
        *trees, loss = step(*trees, first + i, rng(i), x, y, lrs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t_host = time.perf_counter()
    for i in range(3, 3 + TIMED_STEPS):
        *trees, loss = step(*trees, first + i, rng(i), x, y, lrs)
    host_ms = (time.perf_counter() - t_host) * 1e3 / TIMED_STEPS
    b.record()
    b.synchronize()
    if not math.isfinite(loss.item()):
        fail("non-finite loss in a timed train step")
    # a graph's memory is reserved for it at capture, not allocated per
    # replay: the reserved peak compares the two modes
    r = {"ms_per_step": a.elapsed_time(b) / TIMED_STEPS,
         "host_enqueue_ms": host_ms,
         "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    # the device's share: one more step under the profiler
    _, r["device_ms"] = replay_kernels(
        lambda: step(*trees, first + 13, rng(13), x, y, lrs))
    return r


def same_steps(what, step, compiled, fresh, seeds, x, y, lrs):
    """GRAPH_STEPS steps of ``compiled`` against as many eager ones from
    the same trees: losses, parameters, running statistics and optimizer
    state bit for bit.  Returns the compiled trees."""
    import torch

    from bigdl_tpu_torch.utils import graphs

    eager, comp = fresh(), fresh()
    le, lc = [], []
    for i in range(GRAPH_STEPS):
        *eager, loss = step(*eager, i + 1, seeds(i), x, y, lrs)
        le.append(loss.item())
        *comp, loss = compiled(*comp, i + 1, seeds(i), x, y, lrs)
        lc.append(loss.item())
    pairs = list(zip(graphs.leaves(eager), graphs.leaves(comp)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    worst = max(((a.float() - b.float()).abs().max().item()
                 for a, b in pairs if a.numel()), default=0.0)
    print(f"graphs: {what}, {GRAPH_STEPS} compiled steps vs eager: losses "
          f"{lc} vs {le}; {differ} of {len(pairs)} tree leaves differ "
          f"(max |d| {worst:.3g})", flush=True)
    if le != lc or differ:
        fail(f"{what}: compiled steps are not bit-equal to eager ones")
    return comp


def graphs_phase(args):
    """Phase 7: every main path compiled (CUDA graphs) against eager on
    the card: answers and steps bit for bit, dropout masks that follow
    the seed, the kernels of each capture and replay, no compile in
    steady state, and wall times eager and compiled.  Returns the
    results."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn.dropout import keep_mask
    from bigdl_tpu_torch.optim import (SGD, Adam, CompiledTrainStep,
                                       make_train_step)
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.utils import (export_variables, graphs,
                                       load_jax_variables, random_variables)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    # eager and replayed calls must run the same library algorithms
    torch.backends.cudnn.deterministic = True
    res = {}
    rs = np.random.RandomState(args.seed + 8)
    images = rs.randn(REQUESTS, 224, 224, 3).astype(np.float32)

    # 7.1 the fused and the dynamic-int8 ResNet-50 forwards, served
    # eagerly and compiled, one graph per declared bucket
    fused = ResNet50(1000, stem="space_to_depth", fused=True)
    load_jax_variables(fused, random_variables(export_variables(fused),
                                               args.seed))
    unfused = ResNet50(1000)
    uv = random_variables(export_variables(unfused), args.seed)
    load_jax_variables(unfused, uv)
    quantized, _ = nn.quantize(unfused, uv)
    del unfused
    for name, model, per_capture in (("fused", fused, FUSED_FWD),
                                     ("dynamic int8", quantized, INT8_FWD)):
        kw = dict(buckets=[(224, 224, 3)], batch_sizes=SERVE_BATCHES,
                  input_dtype=bf16)
        eager = ServingEngine(model, warmup=False, **kw)
        for b in eager.declared_buckets:  # each bucket's forward eager
            eager._compiled[(b.batch, b.dims)] = eager._forward
        _, e_wall = serve_images(eager, images)
        eager.close()
        graphs.reset_counts()
        engine = ServingEngine(model, **kw)
        _, c_wall = serve_images(engine, images)
        check_steady(f"graphs, {name} serve", engine, engine.metrics.batches,
                     graphs.COUNTS["replays"])
        r = {"served_images_per_s": {"eager": REQUESTS / e_wall,
                                     "compiled": REQUESTS / c_wall},
             "p50_ms": {"eager": eager.metrics.latency_ms(50),
                        "compiled": engine.metrics.latency_ms(50)},
             "p99_ms": {"eager": eager.metrics.latency_ms(99),
                        "compiled": engine.metrics.latency_ms(99)},
             "captures": engine.recompiles,
             "capture_seconds": engine.metrics.recompile_seconds,
             "replays": graphs.COUNTS["replays"], "buckets": {}}
        for (batch, dims), g in sorted(engine._compiled.items()):
            xb = torch.randn((batch,) + dims, generator=gen,
                             device=dev).to(bf16)
            yg = g(xb).clone()
            if not torch.equal(yg, engine._forward(xb)):
                fail(f"{name} forward at batch {batch}: the replay is not "
                     "bit-equal to the eager forward")
            r["buckets"][batch] = check_graph(
                f"{name} forward at batch {batch}", g, per_capture,
                lambda: g(xb))
        g32 = engine._compiled[(32, (224, 224, 3))]
        x32 = torch.randn((32, 224, 224, 3), generator=gen,
                          device=dev).to(bf16)
        r["forward_32"] = {
            "eager_ms": call_ms(lambda: engine._forward(x32)),
            "compiled_ms": call_ms(lambda: g32(x32)),
            "device_ms": device_ms(lambda: engine._forward(x32), reps=1)}
        # what the dispatcher does per batch of 32 besides the replay:
        # pad the requests into one array, copy it to the card
        chunk, dims = list(images[:32]), (224, 224, 3)
        xp = engine.grid.pad_batch(chunk, dims, 32, np.float32)
        r["dispatch_32"] = {
            "pad_ms": host_ms(lambda: engine.grid.pad_batch(
                chunk, dims, 32, np.float32)),
            "h2d_ms": host_ms(lambda: engine._to_device(xp))}
        engine.close()
        res[name] = r
        f, sv = r["forward_32"], r["served_images_per_s"]
        print(f"graphs: {name} ResNet-50, every bucket's replay bit-equal to "
              f"the eager forward, kernels per capture and per replay "
              f"{per_capture}; forward at batch 32 eager {f['eager_ms']:.3f}"
              f" ms, compiled {f['compiled_ms']:.3f} ms, device "
              f"{f['device_ms']:.3f} ms (the dispatcher pads a batch of 32 "
              f"in {r['dispatch_32']['pad_ms']:.3f} ms and copies it to the "
              f"card in {r['dispatch_32']['h2d_ms']:.3f} ms); served "
              f"{REQUESTS} requests eager "
              f"{sv['eager']:.1f} images/s (p50 {r['p50_ms']['eager']:.2f}, "
              f"p99 {r['p99_ms']['eager']:.2f} ms), compiled "
              f"{sv['compiled']:.1f} images/s (p50 "
              f"{r['p50_ms']['compiled']:.2f}, p99 "
              f"{r['p99_ms']['compiled']:.2f} ms); {r['captures']} captures "
              f"in {r['capture_seconds']:.2f} s, {r['replays']} replays",
              flush=True)
    del fused, quantized, eager, engine, g, g32
    torch.cuda.empty_cache()

    # 7.2 the ResNet-50 train step (bench.py's: SGD 0.1, momentum 0.9,
    # bf16): compiled against eager at batch 32, its kernels, then ms per
    # step at batch 256
    model = ResNet50(1000, stem="space_to_depth", fused=True).to(dev)
    load_jax_variables(model, random_variables(export_variables(model),
                                               args.seed))
    crit = nn.ClassNLLCriterion(logits=True)
    step = make_train_step(model, crit, {"__all__": SGD(0.1, momentum=0.9)},
                           compute_dtype=bf16)

    def fresh():
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = {k: b.detach().clone() for k, b in model.named_buffers()}
        return params, state, {"__all__": SGD(0.1, momentum=0.9)
                               .init_state(params)}

    def set_remat(on):
        for blk in model.modules():
            if isinstance(blk, nn.FusedBottleneck):
                blk.remat = on

    def no_seed(i):
        return None

    res["resnet50_step"] = {}
    for batch in (BATCH, TRAIN_BATCH):
        x = torch.rand((batch, 224, 224, 3), generator=gen,
                       device=dev).to(bf16)
        t = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
        for remat in (True, False):
            set_remat(remat)
            what = f"ResNet-50 step at batch {batch}, remat " + \
                ("on" if remat else "off")
            if batch == BATCH:
                compiled = CompiledTrainStep(step)
                trees = same_steps(what, step, compiled, fresh, no_seed, x,
                                   t, [0.1])
                check_graph(what, next(iter(compiled.graphs.values())),
                            STEP_LAUNCHES[remat],
                            lambda: compiled(*trees, 4, None, x, t, [0.1]))
                del trees, compiled
                continue
            r = {}
            for mode in ("eager", "compiled"):
                fn = step if mode == "eager" else CompiledTrainStep(step)
                r[mode] = step_ms(fn, fresh(), 1, no_seed, x, t, [0.1])
                del fn
                torch.cuda.empty_cache()
            r["images_per_s"] = {m: batch / r[m]["ms_per_step"] * 1e3
                                 for m in ("eager", "compiled")}
            res["resnet50_step"]["remat_on" if remat else "remat_off"] = r
            print(f"graphs: {what}: eager {r['eager']['ms_per_step']:.2f} ms "
                  f"(the host enqueues one in "
                  f"{r['eager']['host_enqueue_ms']:.2f} ms, device "
                  f"{r['eager']['device_ms']:.2f} ms), compiled "
                  f"{r['compiled']['ms_per_step']:.2f} ms (host "
                  f"{r['compiled']['host_enqueue_ms']:.2f} ms, device "
                  f"{r['compiled']['device_ms']:.2f} ms); "
                  f"{r['images_per_s']['eager']:.1f} -> "
                  f"{r['images_per_s']['compiled']:.1f} images/s; peak "
                  f"reserved memory "
                  f"{r['eager']['peak_reserved_bytes'] / 2**30:.2f} / "
                  f"{r['compiled']['peak_reserved_bytes'] / 2**30:.2f} GiB",
                  flush=True)
        del x, t
    del model, step
    torch.cuda.empty_cache()

    # 7.3 the LM step (the trainer's: Adam, clipping, bf16, dropout 0.1,
    # the loop's seeds): compiled against eager, its kernels, dropout
    # masks from seed tensors, then ms per step at T 512 and 4096
    lm = nn.Transformer(**LM, dropout=0.1).to(dev)
    load_jax_variables(lm, lm_variables(lm, args.seed))
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(logits=True))
    step = make_train_step(lm, crit, {"__all__": Adam(1e-3)},
                           grad_clip_norm=1.0, compute_dtype=bf16)

    def lm_fresh():
        params = {k: p.detach().clone() for k, p in lm.named_parameters()}
        return params, {}, {"__all__": Adam(1e-3).init_state(params)}

    def loop_seed(i):
        return nn.split_rng(7, i)  # the training loop's seeds

    res["lm_step"] = {}
    for seq in (LM_SEQ, LM_LONG_SEQ):
        x, y = (torch.randint(0, LM["vocab_size"], (LM_BATCH, seq),
                              generator=gen, device=dev) for _ in range(2))
        if seq == LM_SEQ:
            what = f"LM step at batch {LM_BATCH}, T {seq}, dropout 0.1"
            compiled = CompiledTrainStep(step)
            trees = same_steps(what, step, compiled, lm_fresh, loop_seed, x,
                               y, [1e-3])
            check_graph(what, next(iter(compiled.graphs.values())),
                        {"flash_attention": LM["num_layers"]},
                        lambda: compiled(*trees, 4, loop_seed(3), x, y,
                                         [1e-3]))
            del trees, compiled
        r = {mode: step_ms(step if mode == "eager" else CompiledTrainStep(
            step), lm_fresh(), 1, loop_seed, x, y, [1e-3])
             for mode in ("eager", "compiled")}
        r["tokens_per_s"] = {m: LM_BATCH * seq / r[m]["ms_per_step"] * 1e3
                             for m in ("eager", "compiled")}
        res["lm_step"][seq] = r
        print(f"graphs: LM step at batch {LM_BATCH}, T {seq}: eager "
              f"{r['eager']['ms_per_step']:.3f} ms (host "
              f"{r['eager']['host_enqueue_ms']:.3f} ms, device "
              f"{r['eager']['device_ms']:.3f} ms), compiled "
              f"{r['compiled']['ms_per_step']:.3f} ms (host "
              f"{r['compiled']['host_enqueue_ms']:.3f} ms, device "
              f"{r['compiled']['device_ms']:.3f} ms); "
              f"{r['tokens_per_s']['eager']:.0f} -> "
              f"{r['tokens_per_s']['compiled']:.0f} tokens/s", flush=True)
        torch.cuda.empty_cache()

    shape = (LM_BATCH, LM_SEQ, LM["hidden_size"])
    seed = torch.zeros((), dtype=torch.int64, device=dev)
    masks = graphs.compile(lambda s: keep_mask(shape, 0.1, s, dev), (seed,))
    seeds = [loop_seed(0), loop_seed(1)]
    got = [masks(torch.tensor(s, device=dev)).clone() for s in seeds]
    if torch.equal(got[0], got[1]) or not all(
            torch.equal(m, keep_mask(shape, 0.1, s, dev))
            for m, s in zip(got, seeds)):
        fail("dropout: the replayed masks of two seeds are equal, or differ "
             "from the eager masks of the same seeds")
    keep = [m.float().mean().item() for m in got]
    res["dropout"] = {"keep_rates": keep, "replays": masks.replays}
    print(f"graphs: dropout masks replayed with two seeds differ and equal "
          f"the eager masks of those seeds; keep rates {keep}", flush=True)
    return res


# ----------------------------------------------------------- decode slice
DECODE_PROMPT, DECODE_STEPS, DECODE_CHUNK = 48, 64, 16
# cached logits vs the uncached forward over the same prefix, of the
# forward's largest |logit|: f32 differs by sum order only (the masked
# plain attention over the cache against kernel 6's online softmax);
# bf16 rounds the cache, kernel 6's p and the activations
DECODE_TOL = {"f32": 1e-4, "bf16": 3e-2}
GEN_BATCH, GEN_BEAM, GEN_LEN = 2, 4, 128
NEAR_TIE = 1e-4       # a re-forward top-2 gap below this x max |logit|
REFORWARD_GATE = 3.0  # bench.py decode_ab leg 1's gate, reported only
TICK_SLOTS, TICK_LEN, TICK_PAGE, TICK_NEW = 8, 512, 16, 64
TICK_BUCKETS, TICK_BATCH = (64, 256), 4  # prompt buckets, prefill rows
TICK_PROMPT = (5, 200)  # the shortest and the longest prompt
TICK_LATE = 8         # ticks before the long prompts are admitted
SAMPLE_TICKS = 16
INT8_HEADS, INT8_SLOTS, INT8_EXTENT, INT8_CHUNKS = 2, 4, 512, 4


def decode_phase(args, card):
    """Phase 8, the decode slice on the LM at full width: cached decode
    against the uncached forward (kernel 6), extend against prefill,
    generate compiled against eager and cached against re-forward, the
    server's tick programs (:func:`tick_checks`) and an int8 paged pool
    on kernel 7 (:func:`int8_kv_checks`).  Returns the results."""
    import copy

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.utils import graphs, load_jax_variables

    print(f"decode phase on {card}", flush=True)
    dev = torch.device("cuda")
    rs = np.random.RandomState(args.seed + 10)
    res = {}

    def lm(heads):
        m = nn.Transformer(**dict(LM, num_heads=heads), dropout=0.0).to(dev)
        load_jax_variables(m, lm_variables(m, args.seed))
        return m.eval()

    def ints(*shape):
        return torch.from_numpy(rs.randint(0, LM["vocab_size"], shape)).to(
            dev)

    m32 = lm(LM["num_heads"])
    models = {"f32": m32, "bf16": copy.deepcopy(m32).to(torch.bfloat16)}

    # cached decode against the uncached forward; extend against prefill
    ids = ints(2, DECODE_PROMPT)
    total = DECODE_PROMPT + DECODE_STEPS
    res["cached"] = {}
    for dt, m in models.items():
        dtype = m.embed.weight.dtype
        last, cache = m.prefill(ids, m.init_cache(2, total, dtype))
        got, seq = [last], ids
        for _ in range(DECODE_STEPS):
            tok = got[-1].argmax(-1).to(torch.int32)
            seq = torch.cat([seq, tok[:, None].to(seq.dtype)], 1)
            logits, cache = m.decode_step(cache, tok)
            got.append(logits)
        fa.reset_launches()
        with torch.no_grad():
            full = m(seq).float()
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        scale = full.abs().max().item()
        err = (torch.stack(got, 1).float()
               - full[:, DECODE_PROMPT - 1:]).abs().max().item() / scale
        ext, chunks = m.init_cache(2, total, dtype), []
        for lo in range(0, DECODE_PROMPT, DECODE_CHUNK):
            lg, ext = m.extend(ext, ids[:, lo:lo + DECODE_CHUNK])
            chunks.append(lg)
        ext_err = (torch.cat(chunks, 1).float() - full[:, :DECODE_PROMPT]
                   ).abs().max().item() / scale
        pre_err = (chunks[-1][:, -1].float() - last.float()).abs().max(
        ).item() / scale
        res["cached"][dt] = {"rel_err": err, "extend_rel_err": ext_err,
                             "extend_vs_prefill_rel_err": pre_err,
                             "uncached_flash_launches": launches}
        print(f"decode {dt}: prefill of {DECODE_PROMPT} + {DECODE_STEPS} "
              f"decode_steps against the uncached forward: max |d| "
              f"{err:.3g} of the largest |logit| (limit {DECODE_TOL[dt]}); "
              f"extend in chunks of {DECODE_CHUNK}: {ext_err:.3g}, its last "
              f"logits against prefill's {pre_err:.3g}; the forward "
              f"launched kernel 6 {launches} times", flush=True)
        if launches != LM["num_layers"]:
            fail(f"decode {dt}: the uncached forward launched kernel 6 "
                 f"{launches} times, expected {LM['num_layers']}")
        if not max(err, ext_err, pre_err) <= DECODE_TOL[dt]:
            fail(f"decode {dt}: cached logits disagree with the uncached "
                 f"forward: {err:.4g}, {ext_err:.4g}, {pre_err:.4g} (limit "
                 f"{DECODE_TOL[dt]})")
        del full, cache, ext

    # generate: compiled against eager, one capture per search
    start = ints(GEN_BATCH).to(torch.int32)
    res["generate"] = {}
    for dt, m in models.items():
        graphs.reset_counts()
        seqs, scores = m.generate(start, GEN_LEN, beam_size=GEN_BEAM)
        counts = dict(graphs.COUNTS)
        # the same search eagerly: generate's body without the graph
        eseqs, escores = nn.SequenceBeamSearch(
            LM["vocab_size"], GEN_BEAM, 0.6, GEN_LEN, LM["vocab_size"] - 1
        ).search(start, m.init_cache(GEN_BATCH, GEN_LEN, m.embed.weight
                                     .dtype), fn=m._cached_logits)
        same = torch.equal(seqs, eseqs) and torch.equal(scores, escores)
        res["generate"][dt] = {"graphs": counts, "bit_equal": same,
                               "best_scores": scores[:, 0].tolist()}
        print(f"generate {dt} (batch {GEN_BATCH}, beam {GEN_BEAM}, "
              f"{GEN_LEN} steps): {counts['captures']} capture "
              f"({counts['capture_seconds']:.2f} s), {counts['replays']} "
              f"replays; compiled bit-equal to eager: {same}; best scores "
              f"{res['generate'][dt]['best_scores']}", flush=True)
        if counts["captures"] != 1 or counts["replays"] != GEN_LEN:
            fail(f"generate {dt}: {counts['captures']} captures and "
                 f"{counts['replays']} replays, expected 1 and {GEN_LEN}")
        if not same or tuple(seqs.shape) != (GEN_BATCH, GEN_BEAM,
                                             GEN_LEN + 1):
            fail(f"generate {dt}: the compiled search differs from the "
                 "eager one")

    # greedy: cached against re-forward (kernel 6 on every step)
    m = m32
    fa.reset_launches()
    useq, _ = m.generate(start, GEN_LEN, beam_size=1, use_cache=False)
    torch.cuda.synchronize()
    host = fa.LAUNCHES["flash_attention"]
    reforward = [g for key, g in m.__dict__["_generate_graphs"].items()
                 if key[-1] == m._forward_logits]
    per_step = getattr(reforward[0], "launches", {}).get("flash_attention",
                                                         0)
    cseq, _ = m.generate(start, GEN_LEN, beam_size=1)
    with torch.no_grad():
        full = m(useq[:, 0].to(torch.int64)).float()
    top2 = full[:, :GEN_LEN].topk(2, -1).values
    gap = ((top2[..., 0] - top2[..., 1]) / full.abs().max()).cpu()
    rows = []
    for row in range(GEN_BATCH):
        near = [i for i in range(GEN_LEN) if gap[row, i] < NEAR_TIE]
        first = near[0] if near else GEN_LEN
        same = torch.equal(useq[row, 0, 1:first + 1],
                           cseq[row, 0, 1:first + 1])
        rows.append({"first_near_tie_step": near[0] if near else None,
                     "equal_before_it": same,
                     "all_equal": torch.equal(useq[row], cseq[row])})
        if not same:
            fail(f"greedy generate row {row}: cached and re-forward tokens "
                 f"differ before step {first}")
    want = (graphs.WARMUP + 1) * LM["num_layers"]
    res["greedy"] = {"rows": rows, "flash_per_step": per_step,
                     "flash_host_launches": host}
    res["launches_6"] = host
    print(f"greedy generate, cached against re-forward over {GEN_LEN} "
          f"steps: {rows}; the re-forward step runs kernel 6 {per_step} "
          f"times per replay ({host} host launches in its one capture)",
          flush=True)
    if len(reforward) != 1 or per_step != LM["num_layers"] or host != want:
        fail(f"generate(use_cache=False): kernel 6 {per_step} times per "
             f"step, {host} in all; expected {LM['num_layers']} and {want}")

    # cached against re-forward: ms per generated token, compiled
    timing = {}
    for use_cache in (True, False):
        m.generate(start, GEN_LEN, beam_size=GEN_BEAM, use_cache=use_cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            m.generate(start, GEN_LEN, beam_size=GEN_BEAM,
                       use_cache=use_cache)
        torch.cuda.synchronize()
        timing["cached" if use_cache else "reforward"] = \
            (time.perf_counter() - t0) * 1e3 / (3 * GEN_LEN)
    ratio = timing["reforward"] / timing["cached"]
    res["generate_ms_per_token"] = dict(timing, ratio=ratio)
    print(f"generate at T {GEN_LEN} (batch {GEN_BATCH}, beam {GEN_BEAM}, "
          f"compiled), ms per generated token: cached "
          f"{timing['cached']:.4f}, re-forward {timing['reforward']:.4f}, "
          f"ratio {ratio:.2f} (bench.py's gate, {REFORWARD_GATE}x, "
          f"{'met' if ratio >= REFORWARD_GATE else 'not met'}; reported, "
          "not enforced)", flush=True)
    if ratio <= 1.0:
        fail(f"cached generate ({timing['cached']:.4f} ms per token) is "
             f"not faster than re-forward ({timing['reforward']:.4f})")
    # where one search step's device time goes (a replay of each graph)
    for name, fn in (("cached", m._cached_logits),
                     ("reforward", m._forward_logits)):
        g = next(g for key, g in m.__dict__["_generate_graphs"].items()
                 if key[-1] == fn and g._static[0].shape[1] == GEN_BEAM)
        total, top = kernel_ms(g.graph.replay)
        step = {"replay_ms": replay_ms(g.graph), "device_ms": total,
                "top_kernels": top}
        res["generate_ms_per_token"][name + "_step"] = step
        print(f"generate step ({name}), one replay: {step}", flush=True)
    del models, full

    res["ticks"] = tick_checks(m32, rs)
    m2 = lm(INT8_HEADS)
    res["int8"] = int8_kv_checks(m2, rs)
    res["engine"] = engine_checks(m32, m2, rs, args.seed)
    return res


# the decode engine (serving/decode.py DecodeEngine) on the full-width LM
ENGINE_SLOTS, ENGINE_LEN = 8, 512
ENGINE_BUCKETS, ENGINE_BATCH = (64, 256), (1, 4)
ENGINE_REQUESTS = 32
# rounds of the traffic on one engine in the arms whose tokens/s are
# compared (continuous, static, paged): the median and the spread
ENGINE_ROUNDS = 7
ENGINE_BUDGETS = (16, 32, 64, 96)  # bench.py decode_ab's budgets
ENGINE_PAGE = 16
ENGINE_CHUNK = 64  # chunked prefill of prompts past the largest bucket
ENGINE_LONG = (300, 420)  # prompts past 256
ENGINE_INT8_REQUESTS = 8
# bench.py decode_ab leg 1: tools/kernel_shapes.py DECODE_MODEL, beam 1,
# one stream, T 128, the median of 7 compiled searches
DECODE_MODEL = dict(vocab_size=32, hidden_size=48, num_heads=4,
                    filter_size=96, num_layers=2)
AB_LEN, AB_REPS = 128, 7
# speculative decoding: draft tokens per round on the full-width LM, and
# at the int8 pool (Tq 8: kernel 7's row tile); the self-draft's least
# acceptance (its draft and verify differ only by f32 sum order)
SPEC_K, INT8_SPEC_K, SELF_DRAFT_ACCEPT = 3, 7, 0.95
# the rollback arms: a self-draft wrong where the row's length is a
# multiple of ROLL_EVERY; its acceptance is fixed by the lengths alone,
# up to flips at near-ties of the Tq-1 draft step and the verify (the
# least fault seen on the CPU, a draft cache that does not follow the
# host's lengths, moves it from 0.63 to 0.14)
ROLL_EVERY, ROLL_ACCEPT_SLACK = 3, 0.02
# bench.py decode_production_arms' constants (tools/kernel_shapes.py:
# DECODE_SLOTS, DECODE_MAX_LEN, DECODE_PROMPT_BUCKETS,
# DECODE_PREFILL_BATCH, DECODE_PAGE, DECODE_CHUNK, DECODE_DRAFT_K,
# DECODE_DRAFT_MODEL) and its 12 requests
BENCH_SLOTS, BENCH_LEN, BENCH_BUCKETS, BENCH_BATCH = 4, 160, (8, 16), \
    (1, 2, 4)
BENCH_PAGE, BENCH_CHUNK, BENCH_DRAFT_K, BENCH_REQUESTS = 16, 16, 3, 12
DECODE_DRAFT_MODEL = dict(DECODE_MODEL, num_layers=1)


def engine_checks(model, model2, rs, seed, dev="cuda"):
    """The decode engine as its users run it, on the f32 LM at full
    width (``model``; ``model2`` has 2 heads of 128): continuous against
    static batching on mixed traffic, greedy tokens against direct
    decode_step rollouts, sampling per seed, paged at twice the slots on
    the dense grid's bytes, chunked prefill against the bucketed path,
    the int8 pool against the f32 pool, and bench.py decode_ab's leg 1.
    Token streams of two arms must be equal or part where the uncached
    forward's top two logits are within NEAR_TIE of each other.  The
    arms whose tokens/s are compared serve their traffic ENGINE_ROUNDS
    times on one engine and give the median and the spread."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops import int8_matmul as im
    from bigdl_tpu_torch.serving import (DecodeEngine, ServingMetrics,
                                         decode_program_check,
                                         default_num_pages)
    from bigdl_tpu_torch.utils import graphs, load_jax_variables

    dev = torch.device(dev)
    vocab = LM["vocab_size"]
    lens = np.linspace(TICK_PROMPT[0], TICK_PROMPT[1],
                       ENGINE_REQUESTS).astype(int)
    rs.shuffle(lens)
    traffic = [(rs.randint(0, vocab, int(t)), ENGINE_BUDGETS[i % 4], {})
               for i, t in enumerate(lens)]
    res = {"traffic": {"requests": ENGINE_REQUESTS,
                       "prompt_tokens": [int(lens.min()), int(lens.max())],
                       "budgets": list(ENGINE_BUDGETS)},
           "near_tie_partings": []}

    class Peaks(ServingMetrics):
        """ServingMetrics keeping the most slots active at once and the
        most pages held."""
        active = 0.0
        pages = 0

        def record_slot_occupancy(self, frac):
            self.active = max(self.active, frac)
            super().record_slot_occupancy(frac)

        def record_pages(self, in_use):
            self.pages = max(self.pages, int(in_use))
            super().record_pages(in_use)

    def serve(what, m, reqs, learned=0, profiled=False, rounds=1,
              probe=None, **kw):
        """Serve ``reqs`` ``rounds`` times on a fresh engine; the first
        round's tokens and the numbers (tokens/s: the median of the
        rounds and its spread; with ``profiled``, also the hand-written
        kernels the serving ran, by torch.profiler; ``probe(engine)``,
        a dict, runs before the engine closes).  Fails unless warmup
        captured exactly the declared programs and serving captured
        ``learned`` (a learned bucket's prefill and write) more."""
        kw = {"slots": ENGINE_SLOTS, "max_len": ENGINE_LEN,
              "prompt_buckets": ENGINE_BUCKETS,
              "prefill_batch_sizes": ENGINE_BATCH, **kw}
        metrics = Peaks()
        eng = DecodeEngine(m, metrics=metrics, device=dev, **kw)
        try:
            declared, warm = eng.declared_programs(), eng.recompiles
            captures = graphs.COUNTS["captures"]
            outs, walls, kernels = [], [], None

            def run():
                futs = [eng.submit(p, n, **sk) for p, n, sk in reqs]
                got = [[int(t) for t in f.result(300)] for f in futs]
                if not outs:
                    outs.extend(got)

            for _ in range(rounds):
                t0 = time.perf_counter()
                if profiled:
                    kernels = replay_kernels(run)[0]
                else:
                    run()
                walls.append(time.perf_counter() - t0)
            tokens = sum(len(o) for o in outs)  # each round: no EOS
            rates = [tokens / w for w in walls]
            snap = metrics.snapshot()
            rec = {"slots": eng.slots, "layout": eng.kv_layout,
                   "kv_dtype": eng.kv_dtype, "rounds": rounds,
                   "wall_s": walls, "tokens": tokens,
                   "declared_programs": declared,
                   "steady_state_captures": eng.recompiles - warm,
                   "graph_captures_while_serving":
                       graphs.COUNTS["captures"] - captures,
                   "tokens_per_s": statistics.median(rates),
                   "tokens_per_s_rounds": rates,
                   "tokens_per_s_spread": [min(rates), max(rates)],
                   "p50_tick_ms": snap["p50_tick_ms"],
                   "p95_tick_ms": snap["p95_tick_ms"],
                   "slot_occupancy": snap["slot_occupancy"],
                   "peak_active_slots": round(metrics.active * eng.slots),
                   "prefill_chunks": snap["prefill_chunks"],
                   "page_evictions": snap["page_evictions"],
                   "peak_pages": metrics.pages,
                   "cache_bytes": eng._cache_bytes_total(),
                   "page_bytes": eng._page_bytes_total() if eng.paged
                   else None,
                   "kernels": kernels,
                   "draft_k": eng.draft_k,
                   "spec_acceptance_rate": snap["spec_acceptance_rate"],
                   "spec_proposed": metrics.spec_proposed,
                   "spec_rejected": metrics.spec_proposed
                   - metrics.spec_accepted,
                   "log_line": eng.log_line()}
            if probe is not None:
                rec.update(probe(eng))
        finally:
            eng.close(timeout=120)
        if warm != declared or rec["steady_state_captures"] != learned \
                or rec["graph_captures_while_serving"] != learned:
            fail(f"engine {what}: {warm} captures at warmup for "
                 f"{declared} declared programs, "
                 f"{rec['steady_state_captures']} while serving "
                 f"({rec['graph_captures_while_serving']} graphs), "
                 f"expected {learned}")
        print(f"engine {what}: {tokens} tokens a round, {rounds} "
              f"round(s) of {min(walls):.3f}-{max(walls):.3f} s, "
              f"{rec['tokens_per_s']:.1f} tokens/s (median; spread "
              f"{min(rates):.1f}-{max(rates):.1f}); tick p50 "
              f"{rec['p50_tick_ms']:.3f} ms, p95 {rec['p95_tick_ms']:.3f} "
              f"ms; slot occupancy {rec['slot_occupancy']:.3f}, peak "
              f"{rec['peak_active_slots']} of {eng.slots} slots; "
              f"{declared} programs captured at warmup, "
              f"{rec['steady_state_captures']} while serving; "
              f"{rec['log_line']}", flush=True)
        return outs, rec

    def agree(what, m, prompt, a, b):
        """True where ``a == b``; False where they part at a near-tie of
        ``m``'s uncached forward over the common prefix; fails
        otherwise."""
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if n is None:
            if len(a) != len(b):
                fail(f"engine {what}: {len(a)} tokens against {len(b)}")
            return True
        seq = torch.tensor([list(prompt) + a[:n]], device=dev)
        with torch.no_grad():
            logits = m(seq)[0, -1].float()
        top2 = logits.topk(2).values
        gap = ((top2[0] - top2[1]) / logits.abs().max()).item()
        if gap >= NEAR_TIE:
            fail(f"engine {what}: tokens part at step {n} ({a[n]} against "
                 f"{b[n]}) where the top two logits are {gap:.3g} of the "
                 f"largest apart (a near-tie is below {NEAR_TIE})")
        res["near_tie_partings"].append({"arm": what, "step": n,
                                         "gap": gap})
        return False

    def same_tokens(what, m, reqs, outs, ref):
        return sum(agree(what, m, p, a, b)
                   for (p, _, _), a, b in zip(reqs, outs, ref))

    # continuous against static batching
    cont_out, res["continuous"] = serve("continuous", model, traffic,
                                        rounds=ENGINE_ROUNDS)
    stat_out, res["static"] = serve("static", model, traffic,
                                    rounds=ENGINE_ROUNDS, continuous=False)
    res["continuous_equal_static"] = same_tokens(
        "static vs continuous", model, traffic, stat_out, cont_out)
    ratio = res["continuous"]["tokens_per_s"] / res["static"][
        "tokens_per_s"]
    res["continuous_vs_static"] = ratio
    # the slowest continuous round against the fastest static one
    worst = res["continuous"]["tokens_per_s_spread"][0] / res["static"][
        "tokens_per_s_spread"][1]
    res["continuous_vs_static_worst"] = worst
    print(f"engine: continuous {res['continuous']['tokens_per_s']:.1f} "
          f"against static {res['static']['tokens_per_s']:.1f} tokens/s "
          f"(medians of {ENGINE_ROUNDS} rounds, {ratio:.3f}x; slowest "
          f"continuous round against fastest static {worst:.3f}x); slot "
          "occupancy "
          f"{res['continuous']['slot_occupancy']:.3f} against "
          f"{res['static']['slot_occupancy']:.3f}; "
          f"{res['continuous_equal_static']} of {ENGINE_REQUESTS} streams "
          "equal", flush=True)
    if ratio <= 1.0:
        fail(f"engine: continuous batching ({ratio:.3f}x static) is not "
             "faster than static batching")

    # greedy tokens against direct decode_step rollouts (batch 1, exact
    # prompt length), up to the rollout's first near-tie
    direct = []
    for i in range(4):
        prompt, n, _ = traffic[i]
        with torch.no_grad():
            logits, cache = model.prefill(
                torch.tensor(prompt[None], device=dev),
                model.init_cache(1, ENGINE_LEN, torch.float32))
            toks, gaps = [], []
            for j in range(n):
                top2 = logits[0].topk(2).values
                gaps.append(((top2[0] - top2[1])
                             / logits[0].abs().max()).item())
                toks.append(int(logits[0].argmax()))
                if j + 1 < n:
                    logits, cache = model.decode_step(cache, torch.tensor(
                        [toks[-1]], dtype=torch.int32, device=dev))
        first = next((j for j, g in enumerate(gaps) if g < NEAR_TIE), n)
        ok = cont_out[i][:first] == toks[:first]
        direct.append({"tokens": n, "first_near_tie": first,
                       "equal_before_it": ok,
                       "all_equal": cont_out[i] == toks})
        if not ok:
            fail(f"engine: request {i}'s tokens differ from its direct "
                 f"decode_step rollout before step {first}")
    res["direct_rollouts"] = direct
    print(f"engine: greedy tokens against direct decode_step rollouts: "
          f"{direct}", flush=True)

    # sampling: the same seed twice gives the same tokens, another seed
    # other tokens, and the greedy rows of the same grid stay exact
    prompt = traffic[0][0]
    sk = dict(temperature=0.8, top_k=50, top_p=0.95)
    samp = [(prompt, 48, dict(sk, seed=7)), (prompt, 48, dict(sk, seed=7)),
            (prompt, 48, dict(sk, seed=8)), (prompt, traffic[0][1], {})]
    s_out, res["sampling"] = serve("sampling", model, samp)
    res["sampling"].update(same_seed_equal=s_out[0] == s_out[1],
                           other_seed_differs=s_out[0] != s_out[2])
    if s_out[0] != s_out[1] or s_out[0] == s_out[2]:
        fail("engine sampling: seed 7 twice gave different tokens or seed "
             "8 the same ones")
    agree("sampled grid's greedy row", model, prompt, s_out[3], cont_out[0])

    # paged: twice the slots on the dense grid's bytes
    dense_bytes = res["continuous"]["cache_bytes"]
    # the dense grid's tokens in pages, and the trash page
    pages = default_num_pages(ENGINE_SLOTS, ENGINE_LEN, ENGINE_PAGE)
    p_out, res["paged"] = serve("paged", model, traffic,
                                rounds=ENGINE_ROUNDS,
                                slots=2 * ENGINE_SLOTS, kv_layout="paged",
                                page_size=ENGINE_PAGE, num_pages=pages)
    res["paged_equal_dense"] = same_tokens("paged vs dense", model,
                                           traffic, p_out, cont_out)
    print(f"engine paged: {2 * ENGINE_SLOTS} slots on {pages} pages of "
          f"{res['paged']['page_bytes']} bytes ({res['paged']['cache_bytes']}"
          f" bytes; the dense grid {dense_bytes}), peak "
          f"{res['paged']['peak_active_slots']} active slots and "
          f"{res['paged']['peak_pages']} pages, "
          f"{res['paged']['page_evictions']} evictions; "
          f"{res['paged_equal_dense']} of {ENGINE_REQUESTS} streams equal "
          "to dense", flush=True)
    if res["paged"]["cache_bytes"] > dense_bytes + res["paged"][
            "page_bytes"] + 4 * (2 * ENGINE_SLOTS) * LM["num_layers"] or \
            res["paged"]["peak_active_slots"] <= ENGINE_SLOTS:
        fail(f"engine paged: {res['paged']['cache_bytes']} bytes (dense "
             f"{dense_bytes}), peak {res['paged']['peak_active_slots']} "
             f"active slots (dense {ENGINE_SLOTS})")

    # the same pool with page zeroing on (BIGDL_TPU_PAGE_ZERO): the page
    # reset is one more declared program, run at every retirement
    zreqs = traffic[:ENGINE_SLOTS]
    before = os.environ.get("BIGDL_TPU_PAGE_ZERO")
    os.environ["BIGDL_TPU_PAGE_ZERO"] = "1"
    try:
        z_out, res["paged_zeroing"] = serve(
            "paged, pages zeroed", model, zreqs, slots=2 * ENGINE_SLOTS,
            kv_layout="paged", page_size=ENGINE_PAGE, num_pages=pages)
    finally:
        if before is None:
            del os.environ["BIGDL_TPU_PAGE_ZERO"]
        else:
            os.environ["BIGDL_TPU_PAGE_ZERO"] = before
    res["paged_zeroing_equal_dense"] = same_tokens(
        "paged with page zeroing vs dense", model, zreqs, z_out,
        cont_out[:ENGINE_SLOTS])
    print(f"engine paged with page zeroing: "
          f"{res['paged_zeroing']['declared_programs']} programs declared "
          f"(the paged arm {res['paged']['declared_programs']}); "
          f"{res['paged_zeroing_equal_dense']} of {len(zreqs)} streams "
          "equal to dense", flush=True)
    if res["paged_zeroing"]["declared_programs"] != \
            res["paged"]["declared_programs"] + 1:
        fail("engine paged with page zeroing: the page reset is not one "
             "more declared program")

    # chunked prefill of prompts past the largest bucket against the
    # bucketed path (one learned bucket per length)
    longs = [(rs.randint(0, vocab, t), 32, {}) for t in ENGINE_LONG]
    longs += traffic[:2]
    c_out, res["chunked"] = serve("chunked", model, longs,
                                  prefill_chunk=ENGINE_CHUNK)
    b_out, res["bucketed"] = serve("bucketed (learned buckets)", model,
                                   longs, learned=2 * len(ENGINE_LONG))
    res["chunked_equal_bucketed"] = same_tokens(
        "chunked vs bucketed", model, longs, c_out, b_out)
    want_chunks = sum(-(-t // ENGINE_CHUNK) for t in ENGINE_LONG)
    if res["chunked"]["prefill_chunks"] != want_chunks:
        fail(f"engine chunked: {res['chunked']['prefill_chunks']} chunks, "
             f"expected {want_chunks}")
    print(f"engine chunked prefill: prompts of {ENGINE_LONG} tokens in "
          f"{want_chunks} chunks of {ENGINE_CHUNK}; "
          f"{res['chunked_equal_bucketed']} of {len(longs)} streams equal "
          "to the bucketed path", flush=True)

    # the int8 pool (the LM with 2 heads of 128) against the f32 pool
    reqs8 = traffic[:ENGINE_INT8_REQUESTS]
    f_out, res["int8_f32_pool"] = serve(
        "f32 pool, 2 heads", model2, reqs8, slots=INT8_SLOTS,
        kv_layout="paged", page_size=ENGINE_PAGE)
    im.reset_launches()
    int8_kw = dict(slots=INT8_SLOTS, kv_layout="paged",
                   page_size=ENGINE_PAGE, kv_dtype="int8")
    q_out, res["int8"] = serve("int8 pool, 2 heads", model2, reqs8,
                               **int8_kw)
    # the kernels two requests run, by torch.profiler (apart: it slows
    # the host's loop many times over)
    _, profiled = serve("int8 pool, 2 heads, profiled", model2, reqs8[:2],
                        profiled=True, **int8_kw)
    host7 = im.LAUNCHES["int8_matmul"]
    counts = profiled["kernels"]
    agree8 = sum(int(a == b) for fo, qo in zip(f_out, q_out)
                 for a, b in zip(fo, qo)) / sum(len(fo) for fo in f_out)
    res["int8"].update(kernel7_host_launches=host7,
                       kernel7_profiler_launches=counts.get("int8_matmul", 0),
                       token_agreement=agree8,
                       f32_page_bytes=res["int8_f32_pool"]["page_bytes"])
    print(f"engine int8 pool: {res['int8']['page_bytes']} bytes per page "
          f"against {res['int8_f32_pool']['page_bytes']} in f32 (cache "
          f"{res['int8']['cache_bytes']} against "
          f"{res['int8_f32_pool']['cache_bytes']} bytes); tokens "
          f"{100 * agree8:.1f}% equal to the f32 pool's; kernel 7 launched "
          f"{host7} times (host) and {counts.get('int8_matmul', 0)} "
          "(profiler): the engine's ticks are single tokens and its "
          "prefill chunks go to a dense staging cache, as in JAX",
          flush=True)
    if 2 * res["int8"]["page_bytes"] > res["int8_f32_pool"]["page_bytes"] \
            or agree8 < 0.9 or host7 or counts.get("int8_matmul", 0):
        fail(f"engine int8 pool: {res['int8']['page_bytes']} bytes per page"
             f" (f32 {res['int8_f32_pool']['page_bytes']}), tokens "
             f"{agree8:.3f} equal (limit 0.9), kernel 7 {host7} launches")

    # speculative decoding (greedy only): tokens must be the greedy
    # arms' (or part at a near-tie); no trained draft exists, so
    # acceptance and tokens/s are reported, not gated, but for the
    # self-draft's acceptance
    def draft_of(cfg, seed_off):
        d = nn.Transformer(**cfg, dropout=0.0).to(dev)
        load_jax_variables(d, lm_variables(d, seed + seed_off))
        return d.eval()

    def spec_line(what, rec, base, base_what):
        rec["vs_greedy"] = rec["tokens_per_s"] / base["tokens_per_s"]
        print(f"engine speculative, {what}: {rec['tokens_per_s']:.1f} "
              f"tokens/s ({rec['vs_greedy']:.3f}x {base_what}'s "
              f"{base['tokens_per_s']:.1f}); draft_k {rec['draft_k']}, "
              f"acceptance {rec['spec_acceptance_rate']:.4f} "
              f"({rec['spec_rejected']} of {rec['spec_proposed']} draft "
              f"tokens rejected); round p50 {rec['p50_tick_ms']:.3f} ms, "
              f"p95 {rec['p95_tick_ms']:.3f} ms; "
              f"{rec['declared_programs']} programs captured at warmup, "
              f"{rec['steady_state_captures']} while serving", flush=True)

    draft1 = draft_of(dict(LM, num_layers=1), 5)
    sp_out, res["spec"] = serve("speculative, 1-layer draft", model,
                                traffic, rounds=ENGINE_ROUNDS,
                                draft=(draft1, None), draft_k=SPEC_K)
    res["spec"]["equal_streams"] = same_tokens(
        "speculative (1-layer draft) vs continuous", model, traffic,
        sp_out, cont_out)
    spec_line("1-layer draft of the LM", res["spec"], res["continuous"],
              "continuous")
    ss_out, res["spec_self"] = serve("speculative, self-draft", model,
                                     traffic, rounds=ENGINE_ROUNDS,
                                     draft=(model, None), draft_k=SPEC_K)
    res["spec_self"]["equal_streams"] = same_tokens(
        "speculative (self-draft) vs continuous", model, traffic, ss_out,
        cont_out)
    spec_line("self-draft", res["spec_self"], res["continuous"],
              "continuous")
    if res["spec_self"]["spec_acceptance_rate"] < SELF_DRAFT_ACCEPT:
        fail(f"engine speculative self-draft: acceptance "
             f"{res['spec_self']['spec_acceptance_rate']:.4f} (limit "
             f"{SELF_DRAFT_ACCEPT})")

    # rollback: rejected drafts' K/V left above the length, paged windows
    # across a page, the draft cache following the host's lengths.  The
    # LM's embedding is drawn 10x smaller: at full scale a random
    # weight-tied LM repeats each row's last token whatever its cache
    # holds, so its tokens cannot show a faulty rollback.  The draft is
    # that LM itself, wrong at every position (acceptance 0) or at every
    # ROLL_EVERY-th (accepted in part); tokens must be the LM's greedy
    # ones on the dense and the paged engine
    class Rolled(torch.nn.Module):
        """``model`` as its own draft, its logits rolled by one (so its
        proposal is its argmax + 1) where the row's cache length is a
        multiple of ``every``."""

        def __init__(self, model, every):
            super().__init__()
            self.m, self.every, self.embed = model, every, model.embed

        def init_cache(self, *a, **kw):
            return self.m.init_cache(*a, **kw)

        def prefill(self, *a, **kw):
            return self.m.prefill(*a, **kw)

        def extend(self, *a, **kw):
            return self.m.extend(*a, **kw)

        def decode_step(self, cache, tokens):
            at = next(iter(cache.values()))["length"]
            logits, cache = self.m.decode_step(cache, tokens)
            wrong = (at % self.every == 0)[:, None]
            return torch.where(wrong, logits.roll(1, -1), logits), cache

    def rolled_acceptance(reqs, every, k):
        """The acceptance the lengths give: a round from host length L
        accepts the drafts before the first position L + i that is a
        multiple of ``every``; the prefill gave the first token."""
        proposed = accepted = 0
        for p, n, _ in reqs:
            at, got = len(p), 1
            while got < n:
                a = next((i for i in range(k) if (at + i) % every == 0), k)
                proposed, accepted = proposed + k, accepted + a
                at, got = at + a + 1, got + a + 1
        return accepted / proposed

    lm01 = nn.Transformer(**LM, dropout=0.0).to(dev)
    load_jax_variables(lm01, lm_variables(lm01, seed + 8, embed_scale=0.1))
    lm01.eval()
    g01, res["greedy_embed01"] = serve("greedy, the LM with its embedding "
                                       "x0.1", lm01, traffic)
    for every in (1, ROLL_EVERY):
        want = rolled_acceptance(traffic, every, SPEC_K)
        for layout in ("dense", "paged"):
            lkw = {"kv_layout": "paged", "page_size": ENGINE_PAGE} \
                if layout == "paged" else {}
            what = f"rollback, {layout}, draft wrong at every {every}"
            o, rec = serve(what, lm01, traffic, draft=(Rolled(lm01, every),
                                                       None),
                           draft_k=SPEC_K, **lkw)
            rec.update(predicted_acceptance=want, equal_streams=same_tokens(
                f"{what} vs greedy", lm01, traffic, o, g01))
            res[f"rollback_{layout}_every_{every}"] = rec
            spec_line(f"{what} (predicted acceptance {want:.4f})", rec,
                      res["greedy_embed01"], "greedy")
            acc = rec["spec_acceptance_rate"]
            if abs(acc - want) > ROLL_ACCEPT_SLACK or (
                    acc != 0 if every == 1 else not 0 < acc < 1):
                fail(f"engine {what}: acceptance {acc:.4f}, predicted "
                     f"{want:.4f} (slack {ROLL_ACCEPT_SLACK})")

    # bench.py decode_production_arms' speculative arm at its constants
    # (DECODE_MODEL, DECODE_DRAFT_MODEL, draft_k 3, 4 slots of 160,
    # chunks of 16, its traffic), on a paged pool of pages of 16,
    # against the dense greedy arm of the same configuration
    bsmall = draft_of(DECODE_MODEL, 0)
    bdraft = draft_of(DECODE_DRAFT_MODEL, 7)
    brs = np.random.RandomState(1)
    breqs = [(brs.randint(1, 8, ((15, 12, 40, 7)[i % 4],)),
              (24, 48, 32, 40)[i % 4], {}) for i in range(BENCH_REQUESTS)]
    bkw = dict(slots=BENCH_SLOTS, max_len=BENCH_LEN,
               prompt_buckets=BENCH_BUCKETS,
               prefill_batch_sizes=BENCH_BATCH, prefill_chunk=BENCH_CHUNK)
    bd_out, res["bench_dense"] = serve(
        "bench.py arms' dense greedy (DECODE_MODEL)", bsmall, breqs,
        rounds=ENGINE_ROUNDS, **bkw)
    bs_out, res["spec_paged_chunked"] = serve(
        "speculative, paged, chunked (DECODE_MODEL, DECODE_DRAFT_MODEL)",
        bsmall, breqs, rounds=ENGINE_ROUNDS, draft=(bdraft, None),
        draft_k=BENCH_DRAFT_K, kv_layout="paged", page_size=BENCH_PAGE,
        **bkw)
    res["spec_paged_chunked"]["equal_streams"] = same_tokens(
        "speculative paged chunked vs dense greedy", bsmall, breqs, bs_out,
        bd_out)
    spec_line("bench.py's arm (DECODE_MODEL, paged, chunked)",
              res["spec_paged_chunked"], res["bench_dense"], "dense greedy")
    if not res["spec_paged_chunked"]["prefill_chunks"]:
        fail("engine speculative paged chunked: no prompt was chunked")

    # the 2-head LM on an int8 pool of 512 at draft_k 7: the verify's
    # QK^T (Tq 8, D 128) goes to kernel 7, one launch per (layer, slot,
    # head) and round; one verify replay profiled
    def verify_probe(eng):
        prog = eng._programs[("verify",)]
        replay = getattr(prog, "graph", None)
        with eng._lock:
            ran, device, by_k = replay_kernels(
                replay.replay if replay is not None else lambda: None,
                by_kernel=True)
        return {"verify_kernels": ran, "verify_device_ms": device,
                "kernel7_ms_per_round": by_k.get("int8_matmul", 0.0),
                "kernel7_per_capture": getattr(prog, "launches", {}).get(
                    "int8_matmul", 0)}

    draft2 = draft_of(dict(LM, num_heads=INT8_HEADS, num_layers=1), 6)
    want7 = LM["num_layers"] * INT8_SLOTS * INT8_HEADS
    qs_out, res["int8_spec"] = serve(
        f"int8 pool, 2 heads, draft_k {INT8_SPEC_K}", model2, reqs8,
        probe=verify_probe, draft=(draft2, None), draft_k=INT8_SPEC_K,
        **int8_kw)
    q = res["int8_spec"]
    q["token_agreement"] = sum(
        int(a == b) for fo, qo in zip(f_out, qs_out)
        for a, b in zip(fo, qo)) / sum(len(fo) for fo in f_out)
    spec_line(f"int8 pool of the 2-head LM, draft_k {INT8_SPEC_K}", q,
              res["int8"], "the int8 greedy arm")
    print(f"engine speculative int8: one verify replay runs kernel 7 "
          f"{q['verify_kernels'].get('int8_matmul', 0)} times (capture "
          f"{q['kernel7_per_capture']}; layers x slots x heads = {want7}), "
          f"kernel 7 {q['kernel7_ms_per_round']:.4f} device ms of the "
          f"verify's {q['verify_device_ms']:.4f} per round; tokens "
          f"{100 * q['token_agreement']:.1f}% equal to the f32 pool's",
          flush=True)
    if q["verify_kernels"].get("int8_matmul", 0) != want7 or \
            q["kernel7_per_capture"] != want7 or q["token_agreement"] < 0.9:
        fail(f"engine speculative int8: kernel 7 "
             f"{q['verify_kernels'].get('int8_matmul', 0)} launches per "
             f"verify replay, {q['kernel7_per_capture']} in its capture "
             f"(expected {want7}), tokens {q['token_agreement']:.3f} equal "
             "(limit 0.9)")

    # every program an engine dispatches, captured and replayed once
    lines = []
    fails = decode_program_check(
        model, slots=ENGINE_SLOTS, max_len=ENGINE_LEN,
        prompt_buckets=ENGINE_BUCKETS, prefill_batch_sizes=ENGINE_BATCH,
        page_size=ENGINE_PAGE, kv_dtype="int8", prefill_chunk=ENGINE_CHUNK,
        draft_model=draft1, draft_k=SPEC_K, device=dev, log=lines.append)
    res["program_check"] = {"failures": fails, "lines": lines}
    print(f"decode_program_check: {len(lines)} programs (dense, paged, "
          f"int8, chunk, draft), {fails} failures", flush=True)
    if fails:
        fail(f"decode_program_check: {[x for x in lines if 'FAIL' in x]}")

    # bench.py decode_ab leg 1 at its own configuration
    small = nn.Transformer(**DECODE_MODEL, dropout=0.0).to(dev)
    load_jax_variables(small, lm_variables(small, seed))
    small.eval()
    ids0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    seqs, reps = {}, {}
    for cached in (True, False):
        seqs[cached] = small.generate(ids0, AB_LEN, beam_size=1,
                                      use_cache=cached)[0][0, 0].tolist()
    for _ in range(AB_REPS):  # the two in turns
        for cached in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            small.generate(ids0, AB_LEN, beam_size=1, use_cache=cached)
            torch.cuda.synchronize()
            reps.setdefault(cached, []).append(time.perf_counter() - t0)
    times = {c: statistics.median(r) for c, r in reps.items()}
    equal = agree("decode_ab leg 1, cached vs re-forward", small, [0],
                  seqs[True][1:], seqs[False][1:])
    ratio = times[False] / times[True]
    res["decode_ab_leg1"] = {"t_decode": AB_LEN, "cached_s": times[True],
                             "reforward_s": times[False], "ratio": ratio,
                             "cached_s_reps": reps[True],
                             "reforward_s_reps": reps[False],
                             "gate": REFORWARD_GATE, "equal": equal}
    spread = {c: f"{1e3 * min(r):.3f}-{1e3 * max(r):.3f}"
              for c, r in reps.items()}
    print(f"bench.py decode_ab leg 1 (DECODE_MODEL, beam 1, one stream, T "
          f"{AB_LEN}, median of {AB_REPS} compiled searches each, in "
          f"turns): cached {1e3 * times[True]:.3f} ms (spread "
          f"{spread[True]}), re-forward {1e3 * times[False]:.3f} ms (spread "
          f"{spread[False]}), ratio {ratio:.2f} (the JAX gate "
          f"{REFORWARD_GATE}x {'met' if ratio >= REFORWARD_GATE else 'not met'}"
          f"; reported, not enforced); sequences equal: {equal}",
          flush=True)
    if ratio <= 1.0:
        fail(f"decode_ab leg 1: cached generate ({times[True]:.4f} s) is "
             f"not faster than re-forward ({times[False]:.4f} s)")
    return res


# checkpoints, retry and resume (optim/optimizer.py LocalOptimizer)
CKPT_STEPS, CKPT_AT = 8, 4  # the LM's uninterrupted steps; the checkpoint
CKPT_LM_SAMPLES = 48        # 6 batches of 8 an epoch: the resume crosses one
CKPT_NAN_AT = 4             # the LM's lr is NaN in step 5: step 6's loss
CKPT_RN_STEPS, CKPT_RN_AT, CKPT_RN_SAMPLES = 4, 2, 128  # ResNet-50, batch 32


class _NanOnce:
    """A learning-rate schedule whose rate is NaN once, at ``neval`` ``at``:
    that step's update makes every parameter NaN, so the next loss is."""

    def __init__(self, at):
        self.at, self.fired = at, False

    def bind(self, base_lr):
        pass

    def rate(self, step, epoch=0):
        if step == self.at and not self.fired:
            self.fired = True
            return float("nan")
        return 1.0


def checkpoint_phase(args, card):
    """Phase 9, checkpoints in the training loop on the card: the LM at
    T 512 (kernel 6) and the fused ResNet-50 at batch 32 (kernels 1-5),
    each stopped at a checkpoint and resumed in a new LocalOptimizer: the
    restored trees are the saved ones bit for bit (a resumed run stopped
    before its first step writes the blob again) and the first resumed
    loss equals the stopped run's loss of that step bit for bit (same
    trees, batch and seed through one forward); so do the later losses
    the uninterrupted run's (the phase runs with cuDNN deterministic, and
    a later loss reads the restored optimizer counters and schedule
    position through the updates).  A NaN step (the LM: a NaN
    learning rate; ResNet-50: a NaN image in a batch) restores the last
    checkpoint into the compiled step's trees and the run ends finite,
    with one capture.  Then the LM driver's --checkpoint and --resume.
    Under the async loop (the default) the same ResNet-50 run writes its
    checkpoints on the background writer: the file equals the final
    trees bit for bit and the loop's stall is the snapshot.  The rest
    runs with BIGDL_TPU_SYNC_LOOP=1, whose writes are timed from the
    device trees to the file.  Returns the results."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import ResNet50, transformer_train
    from bigdl_tpu_torch.optim import (SGD, Adam, Optimizer, Trigger,
                                       optimizer as optmod)
    from bigdl_tpu_torch.utils import (export_variables, flatten,
                                       load_jax_variables, load_pytree,
                                       random_variables)

    print(f"checkpoint phase on {card}", flush=True)
    # the checkpoints (ResNet-50's are 205 MB each) stay in the checkout's
    # git-ignored build/ and are removed at the end
    root = ROOT / "build" / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    writes = []  # every checkpoint written: path, bytes, ms
    real_save, real_ckpt = optmod.save_pytree, \
        optmod.LocalOptimizer._maybe_checkpoint

    def timed_save(path, blob):
        real_save(path, blob)
        writes.append({"path": path, "bytes": os.path.getsize(
            path if path.endswith(".npz") else path + ".npz")})

    def timed_ckpt(self, *a, **kw):
        n, t0 = len(writes), time.perf_counter()
        real_ckpt(self, *a, **kw)
        if len(writes) > n and self._sync_loop:  # the device-to-host
            # copy, encoding, write
            writes[-1]["ms"] = (time.perf_counter() - t0) * 1e3

    optmod.save_pytree = timed_save
    optmod.LocalOptimizer._maybe_checkpoint = timed_ckpt
    prev_loop = os.environ.get("BIGDL_TPU_SYNC_LOOP")
    os.environ["BIGDL_TPU_SYNC_LOOP"] = "1"  # synchronous writes, timed
    res = {}
    try:
        rs = np.random.RandomState(args.seed + 20)
        xs = rs.randint(0, LM["vocab_size"], (CKPT_LM_SAMPLES, LM_SEQ))
        ys = rs.randint(0, LM["vocab_size"], (CKPT_LM_SAMPLES, LM_SEQ))
        lm_v = None

        def lm_opt(end, d, trigger=None, resume=None, schedule=None):
            nonlocal lm_v
            m = nn.Transformer(**LM)  # dropout 0.1, as the driver
            if lm_v is None:
                lm_v = lm_variables(m, args.seed)
            load_jax_variables(m, lm_v)
            return (Optimizer.apply(
                m, DataSet.from_arrays(xs, ys, batch_size=LM_BATCH),
                nn.TimeDistributedCriterion(
                    nn.ClassNLLCriterion(logits=True)),
                end_trigger=Trigger.max_iteration(end))
                .set_optim_method(Adam(1e-3, schedule=schedule))
                .set_gradient_clipping_by_l2_norm(1.0)
                .set_compute_dtype(torch.bfloat16))

        def rn_opt(end, d, images=None):
            m = ResNet50(1000, stem="space_to_depth", fused=True)
            load_jax_variables(m, rn_v)
            return (Optimizer.apply(
                m, DataSet.from_arrays(rn_x if images is None else images,
                                       rn_y, batch_size=BATCH),
                nn.ClassNLLCriterion(logits=True),
                end_trigger=Trigger.max_iteration(end))
                .set_optim_method(SGD(0.1, momentum=0.9))
                .set_compute_dtype(torch.bfloat16))

        def run(make, name, end, every=None, at=None, resume=None,
                stop=False, **kw):
            """One LocalOptimizer run in its own directory: its loss per
            iteration (read by the checkpoint trigger, which fires every
            ``every`` iterations or at iteration ``at``)."""
            d = root / name
            opt = make(end, d, **kw)
            losses = []

            def trig(state):
                losses.append(state["loss"])
                n = state["neval"]
                return (every is not None and n % every == 0) or n == at

            opt.set_checkpoint(str(d), Trigger(trig))
            if resume is not None:
                opt.resume_from(str(resume))
            if stop:
                opt.request_stop()
            opt.optimize()
            torch.cuda.synchronize()
            return opt, losses, d

        def same_blob(a, b):
            for key in ("params", "model_state", "opt_states"):
                fa, fb = flatten(a[key]), flatten(b[key])
                if fa.keys() != fb.keys() or any(
                        not np.array_equal(fa[k], fb[k]) for k in fa):
                    return False
            return dict(a["driver_state"]) == dict(b["driver_state"])

        def resume_check(what, make, steps, at, **kw):
            """Uninterrupted to ``steps``; stopped after ``at + 1`` with a
            checkpoint at ``at``; restored and written again with no step;
            resumed to ``steps``."""
            full, full_l, _ = run(make, f"{what}_full", steps, **kw)
            part, part_l, pd = run(make, f"{what}_part", at + 1, at=at,
                                   **kw)
            saved = load_pytree(str(pd / "model"))
            _, _, rd = run(make, f"{what}_restored", steps,
                           resume=pd / "model", stop=True, **kw)
            restored = same_blob(load_pytree(str(rd / "model")), saved)
            resumed, res_l, _ = run(make, f"{what}_resumed", steps,
                                    resume=pd / "model", **kw)
            first = res_l[0] == part_l[at]
            later = res_l[1:] == full_l[at + 1:]
            caps = [o.train_step.captures for o in (full, part, resumed)]
            r = {"steps": steps, "checkpoint_at": at,
                 "uninterrupted_losses": full_l, "stopped_losses": part_l,
                 "resumed_losses": res_l, "restored_bit_equal": restored,
                 "first_resumed_loss_bit_equal": first,
                 "later_losses_bit_equal": later, "captures": caps,
                 "resumed_replays": resumed.train_step.replays}
            print(f"{what} resume: checkpoint at iteration {at}, restored "
                  f"trees bit-equal {restored}; first resumed loss "
                  f"{res_l[0]!r} against the stopped run's {part_l[at]!r} "
                  f"(bit-equal {first}); later losses bit-equal to the "
                  f"uninterrupted run's {later}; captures "
                  f"{caps}, {r['resumed_replays']} replays resumed",
                  flush=True)
            if not restored or not first or not later or caps != \
                    [1, 1, 1] or len(res_l) != steps - at:
                fail(f"{what} resume: {r}")
            del full, part, resumed
            torch.cuda.empty_cache()
            return r

        def nan_check(what, make, steps, every, **kw):
            opt, losses, _ = run(make, f"{what}_nan", steps, every=every,
                                 **kw)
            st = opt._loop_state
            r = {"retries": opt._retries, "neval": st["neval"],
                 "final_loss": st["loss"], "losses": losses,
                 "captures": opt.train_step.captures,
                 "replays": opt.train_step.replays}
            print(f"{what} NaN step: {opt._retries} retry from the last "
                  f"checkpoint, ended at iteration {st['neval']} with loss "
                  f"{st['loss']:.4f}; {r['captures']} capture, "
                  f"{r['replays']} replays", flush=True)
            if opt._retries != 1 or st["neval"] != steps or not \
                    math.isfinite(st["loss"]) or r["captures"] != 1:
                fail(f"{what} NaN retry: {r}")
            del opt
            torch.cuda.empty_cache()
            return r

        from bigdl_tpu_torch.ops import flash_attention as fa
        fa.reset_launches()
        res["lm"] = resume_check("LM", lm_opt, CKPT_STEPS, CKPT_AT)
        res["lm"]["flash_launches"] = fa.LAUNCHES["flash_attention"]
        res["lm_nan"] = nan_check("LM", lm_opt, CKPT_STEPS, 2,
                                  schedule=_NanOnce(CKPT_NAN_AT))

        rs = np.random.RandomState(args.seed + 21)
        rn_x = rs.rand(CKPT_RN_SAMPLES, 224, 224, 3).astype(np.float32)
        rn_y = rs.randint(0, 1000, CKPT_RN_SAMPLES)
        rn_v = random_variables(export_variables(
            ResNet50(1000, stem="space_to_depth", fused=True)), args.seed)
        res["resnet50"] = resume_check("ResNet-50", rn_opt, CKPT_RN_STEPS,
                                       CKPT_RN_AT)
        # a NaN image in batch 3 of epoch 0 (the identity order), one that
        # the batch the run goes on to after the retry (epoch 1's first,
        # RandomState(seed 0 + 1)'s permutation) does not hold
        again = set(np.random.RandomState(1).permutation(
            CKPT_RN_SAMPLES)[:BATCH])
        bad = rn_x.copy()
        bad[next(i for i in range(2 * BATCH, 3 * BATCH)
                 if i not in again), 7, 7, 1] = np.nan
        res["resnet50_nan"] = nan_check("ResNet-50", rn_opt, CKPT_RN_STEPS,
                                        1, images=bad)
        del bad

        # the async loop: the writer thread writes, the loop snapshots
        os.environ["BIGDL_TPU_SYNC_LOOP"] = "0"
        try:
            aopt, _, ad = run(rn_opt, "async-resnet50", CKPT_RN_STEPS,
                              every=2)
        finally:
            os.environ["BIGDL_TPU_SYNC_LOOP"] = "1"
        blob = load_pytree(str(ad / "model"))
        want = export_variables(aopt.model, aopt.final_params,
                                aopt.final_state)
        same = all(flatten(blob[bk]).keys() == flatten(want[wk]).keys()
                   and all(np.array_equal(flatten(blob[bk])[k], a)
                           for k, a in flatten(want[wk]).items())
                   for bk, wk in (("params", "params"),
                                  ("model_state", "state")))
        am = aopt.metrics
        res["resnet50_async"] = {
            "snapshot_ms": am.get("checkpoint_snapshot") * 1e3,
            "snapshots": am.count("checkpoint_snapshot"),
            "wait_ms": am.get("checkpoint_wait") * 1e3,
            "pin_ms": am.get("checkpoint_pin") * 1e3,
            "write_ms": am.get("checkpoint_write") * 1e3,
            "writes": am.count("checkpoint_write"),
            "file_equals_final_trees": same,
            "neval": int(blob["driver_state"]["neval"]),
            "captures": aopt.train_step.captures}
        print(f"ResNet-50 under the async loop: checkpoints every 2 "
              f"iterations written by the writer thread "
              f"({res['resnet50_async']['writes']} writes, "
              f"{res['resnet50_async']['write_ms']:.2f} ms each on the "
              f"writer); the loop's stall: snapshot "
              f"{res['resnet50_async']['snapshot_ms']:.2f} ms, wait for the "
              f"previous write {res['resnet50_async']['wait_ms']:.2f} ms, "
              f"pinning once {res['resnet50_async']['pin_ms']:.2f} ms; the "
              f"last file equals the final trees bit for bit {same}",
              flush=True)
        if not same or res["resnet50_async"]["neval"] != CKPT_RN_STEPS or \
                res["resnet50_async"]["writes"] != CKPT_RN_STEPS // 2 or \
                res["resnet50_async"]["captures"] != 1:
            fail(f"ResNet-50 async checkpoints: {res['resnet50_async']}")
        del aopt, rn_x
        torch.cuda.empty_cache()

        # the LM driver: one epoch with a checkpoint, then resumed to two
        d = root / "driver"
        first = transformer_train.main(["--checkpoint", str(d),
                                        "--overwrite", "--maxEpoch", "1"])
        blob = load_pytree(str(d / "model"))
        second = transformer_train.main(["--resume", str(d / "model"),
                                         "--maxEpoch", "2"])
        res["driver"] = {"epoch_1": first, "epoch_2": second,
                         "checkpoint_neval":
                             int(blob["driver_state"]["neval"])}
        print(f"transformer_train.main: --checkpoint ... --maxEpoch 1 "
              f"{first}, checkpoint at iteration "
              f"{res['driver']['checkpoint_neval']}; --resume ... "
              f"--maxEpoch 2 {second}", flush=True)
        if not all(math.isfinite(r["val_loss"]) for r in (first, second)):
            fail(f"transformer_train --checkpoint/--resume: {res['driver']}")
    finally:
        optmod.save_pytree = real_save
        optmod.LocalOptimizer._maybe_checkpoint = real_ckpt
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
        if prev_loop is None:
            os.environ.pop("BIGDL_TPU_SYNC_LOOP", None)
        else:
            os.environ["BIGDL_TPU_SYNC_LOOP"] = prev_loop
    # the synchronous writes, timed on the loop thread
    res["writes"] = [dict(w, path=str(Path(w["path"]).relative_to(root)))
                     for w in writes if "ms" in w]
    by = {}
    for w in res["writes"]:
        by.setdefault(w["path"].split("_")[0], []).append(w)
    res["write_summary"] = {k: {"bytes": v[-1]["bytes"],
                                "ms_median": statistics.median(
                                    x["ms"] for x in v), "writes": len(v)}
                            for k, v in by.items()}
    print(f"checkpoint writes (bytes, median ms from the device trees to "
          f"the file): {res['write_summary']}", flush=True)
    return res


# the ResNet-50 recipe on the async loop (models/resnet_train.py), gradient
# accumulation, and the async loop against the synchronous one
RECIPE_ARGV = ["--fused", "-b", "256", "--syntheticSize", "1024",
               "--maxEpoch", "2", "--imageSize", "224", "--optim", "lars",
               "--warmupEpoch", "1"]
RECIPE_BATCH, RECIPE_ITERS_PER_EPOCH = 256, 4  # 1024 images / 256
RECIPE_RES = 224
ACCUM, ACCUM_MICRO = 4, 64  # the accumulated step: 4 x 64 = batch 256
LOOP_STEPS = 20      # the LM per loop, async against sync
LOOP_NAN_AT = 12     # the LM's lr is NaN in step 13: step 14's loss
LOOP_CKPT_EVERY = 10
LOOP_AB_STEPS, LOOP_AB_FROM = 30, 3  # bench.py loop_ab: 30 steps, timed
LOOP_AB_GATE = 1.3   # from the 3rd on; tests/test_async_engine.py:40-51


class _Sleepy:
    """A dataset whose training batches each take ``seconds`` of host
    time (bench.py loop_ab's SleepPerBatch)."""

    def __init__(self, base, seconds):
        self.base, self.seconds = base, seconds

    def batches_per_epoch(self):
        return self.base.batches_per_epoch()

    def data(self, train):
        for b in self.base.data(train):
            time.sleep(self.seconds)
            yield b


def recipe_phase(args, card, dev="cuda"):
    """Phase 10: (a) ``resnet_train.main(RECIPE_ARGV)`` on the async loop:
    one capture of the train step, kernels 1-5 72/36/36/26/13 times in
    it, every read loss finite, each iteration's learning rate the
    recipe's host schedule, Top1/Top5, ms per step (CUDA events between
    the steps of epoch 2) and the loop's data_stall beside the producer's
    data, then the same for one epoch of the synchronous loop; (b) the
    fused ResNet-50 step at batch 256 as 4 x 64 (f32), compiled, against
    the same accumulated step through the kernels' plain versions from
    the same weights (BatchNorm randomised): loss, gradients and running
    statistics within the train phase's f32 limits, 4 x the launches per
    step in one capture, and the peak memory of 4 x 256 accumulated
    (bf16 compute) against a direct batch 256; (c) the LM (T 512) for 20
    steps on each loop with cuDNN deterministic: losses and final trees
    bit-equal; a NaN step found at most a window later and retried from
    the background-written checkpoint in the same capture, with the
    loop's stall per checkpoint; bench.py loop_ab's A/B on this LM with a
    sleep per batch equal to its step: at least 1.3x.  ``dev="cpu"``
    serves a rehearsal with the sizes shrunk and the CUDA calls patched.
    Returns the results."""
    import types

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import ResNet, resnet_train
    from bigdl_tpu_torch.ops import fused_matmul as fm
    from bigdl_tpu_torch.optim import (SGD, Adam, CompiledTrainStep,
                                       Optimizer, Trigger, make_train_step,
                                       optimizer as optmod)
    from bigdl_tpu_torch.utils import (export_variables, load_jax_variables,
                                       random_variables)

    print(f"recipe phase on {card}", flush=True)
    res = {}
    prev_loop = os.environ.pop("BIGDL_TPU_SYNC_LOOP", None)
    calls, opts = [], []
    real_call = optmod.CompiledTrainStep.__call__
    real_build = optmod.LocalOptimizer._build_step_fn

    def call(self, *a):
        """The loop's step, recorded: its step, rates, loss (a copy on
        the stream) and an event after it."""
        out = real_call(self, *a)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        calls.append({"step": a[3], "lrs": list(a[7]),
                      "loss": out[3].detach().clone(), "event": ev})
        return out

    def build(self, model):
        opts.append(self)
        return real_build(self, model)

    def step_ms(recs):
        """Median device ms between consecutive recorded steps."""
        torch.cuda.synchronize()
        return statistics.median(a["event"].elapsed_time(b["event"])
                                 for a, b in zip(recs, recs[1:])) \
            if len(recs) > 1 else float("nan")

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()

    optmod.CompiledTrainStep.__call__ = call
    optmod.LocalOptimizer._build_step_fn = build
    deterministic = torch.backends.cudnn.deterministic
    try:
        # ---------------------------------------------------- (a) recipe
        fm.reset_launches()
        t0 = time.perf_counter()
        top = resnet_train.main(RECIPE_ARGV)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        opt = opts[-1]
        step = opt.train_step
        (graph,) = step.graphs.values()
        iters = RECIPE_ITERS_PER_EPOCH * 2
        recipe_args = types.SimpleNamespace(
            learningRate=0.1, maxLr=3.2, warmupEpoch=1, maxEpoch=2,
            momentum=0.9, weightDecay=1e-4, optim="lars")
        ref = resnet_train.make_recipe_optim(recipe_args,
                                             RECIPE_ITERS_PER_EPOCH)
        want_lrs = []
        for n in range(iters):
            ref.state["neval"] = n
            ref.state["epoch"] = n // RECIPE_ITERS_PER_EPOCH
            want_lrs.append(ref.current_rate())
        got_lrs = [c["lrs"][0] for c in calls]
        losses = [c["loss"].item() for c in calls]
        m = opt.metrics
        rec = {"seconds": main_s, "result": top,
               "captures": step.captures, "replays": step.replays,
               "launches_per_step": dict(graph.launches),
               "capture_seconds": graph.capture_seconds,
               "lrs": got_lrs, "losses": losses,
               "ms_per_step": step_ms(calls[RECIPE_ITERS_PER_EPOCH:]),
               "data_ms": m.get("data") * 1e3,
               "data_stall_ms": m.get("data_stall") * 1e3,
               "data_stall_ms_last": m.last("data_stall") * 1e3,
               "dispatch_ms_last": m.last("dispatch") * 1e3,
               "sync_ms": m.get("sync") * 1e3,
               "summary": m.summary()}
        rec["images_per_s"] = RECIPE_BATCH / rec["ms_per_step"] * 1e3
        print(f"resnet_train.main({' '.join(RECIPE_ARGV)}): {main_s:.1f} s, "
              f"{top}; {step.captures} capture of the train step "
              f"({graph.capture_seconds:.2f} s), {step.replays} replays, "
              f"launches per step {rec['launches_per_step']}; "
              f"{rec['ms_per_step']:.2f} ms per step in epoch 2 "
              f"({rec['images_per_s']:.1f} images/s); data "
              f"{rec['data_ms']:.2f} ms per batch on the prefetch thread, "
              f"data_stall {rec['data_stall_ms']:.2f} ms (the last "
              f"{rec['data_stall_ms_last']:.2f}); lrs "
              f"{[round(v, 6) for v in got_lrs]}; losses "
              f"{[round(v, 4) for v in losses]}", flush=True)
        if step.captures != 1 or graph.launches != STEP_LAUNCHES[True] \
                or len(calls) != iters:
            fail(f"recipe: {step.captures} captures, launches per step "
                 f"{graph.launches} (expected {STEP_LAUNCHES[True]}), "
                 f"{len(calls)} steps (expected {iters})")
        if got_lrs != want_lrs:
            fail(f"recipe: learning rates {got_lrs}, the schedule gives "
                 f"{want_lrs}")
        if not all(math.isfinite(v) for v in losses) or not \
                math.isfinite(opt._loop_state["loss"]) or \
                set(top) != {"Top1Accuracy", "Top5Accuracy"}:
            fail(f"recipe: losses {losses}, result {top}")
        res["recipe"] = rec
        del opt, step, graph
        opts.clear()
        calls.clear()
        torch.cuda.empty_cache()

        # the synchronous loop, one epoch, for its data phase
        os.environ["BIGDL_TPU_SYNC_LOOP"] = "1"
        sync_argv = list(RECIPE_ARGV)
        sync_argv[sync_argv.index("--maxEpoch") + 1] = "1"
        resnet_train.main(sync_argv)
        del os.environ["BIGDL_TPU_SYNC_LOOP"]
        m = opts[-1].metrics
        res["recipe_sync"] = {"data_ms": m.get("data") * 1e3,
                              "compute_ms": m.get("compute") * 1e3,
                              "ms_per_step": step_ms(calls[1:]),
                              "summary": m.summary()}
        print(f"the same recipe, one epoch on the synchronous loop: data "
              f"{res['recipe_sync']['data_ms']:.2f} ms per batch on the loop "
              f"thread, {res['recipe_sync']['ms_per_step']:.2f} ms per step "
              f"(async: data_stall {rec['data_stall_ms']:.2f} ms, "
              f"{rec['ms_per_step']:.2f} ms per step)", flush=True)
        opts.clear()
        calls.clear()
        torch.cuda.empty_cache()

        # --------------------------------------------- (b) accumulation
        crit = nn.ClassNLLCriterion(logits=True)
        model = ResNet(1000, 50, fused=True, device=dev)
        v = random_variables(export_variables(model), args.seed + 30)
        load_jax_variables(model, v)
        plain = nn.use_plain_ops(ResNet(1000, 50, fused=True, device=dev),
                                 True)
        load_jax_variables(plain, v)
        rs = np.random.RandomState(args.seed + 31)
        x = torch.from_numpy(rs.rand(ACCUM * ACCUM_MICRO, RECIPE_RES,
                                     RECIPE_RES, 3).astype(np.float32)).to(dev)
        t = torch.from_numpy(rs.randint(0, 1000, ACCUM * ACCUM_MICRO)).to(dev)

        def fresh(m_):
            p = {k: q.detach().clone() for k, q in m_.named_parameters()}
            s_ = {k: b.detach().clone() for k, b in m_.named_buffers()}
            return p, s_, {"__all__": SGD(0.1, momentum=0.9).init_state(p)}

        def sgd():
            return {"__all__": SGD(0.1, momentum=0.9)}

        fm.reset_launches()
        kstep = CompiledTrainStep(make_train_step(model, crit, sgd(),
                                                  accum_steps=ACCUM))
        pk, sk, ok, lk = kstep(*fresh(model), 1, None, x, t, [0.1])
        torch.cuda.synchronize()
        (kgraph,) = kstep.graphs.values()
        pp, sp, op_, lp = make_train_step(plain, crit, sgd(),
                                          accum_steps=ACCUM)(
            *fresh(plain), 1, None, x, t, [0.1])
        vk, vp = ok["__all__"]["velocity"], op_["__all__"]["velocity"]
        finite = math.isfinite(lk.item()) and all(
            torch.isfinite(vk[k]).all() for k in vk)
        grad = {k: rel(vk[k], vp[k]) for k in vk}
        err = {"loss": abs(lk.item() - lp.item()) / abs(lp.item()),
               "grad": max(grad.values()),
               "state": max(rel(sk[k], sp[k]) for k in sk)}
        want = {k: ACCUM * n for k, n in STEP_LAUNCHES[True].items()}
        acc = {"parity": err, "worst_grad": max(grad, key=grad.get),
               "launches_per_step": dict(kgraph.launches),
               "captures": kstep.captures,
               "loss": lk.item(), "plain_loss": lp.item()}
        print(f"accumulation {ACCUM} x {ACCUM_MICRO} (f32, kernels vs plain "
              f"path): loss {lk.item():.6g} vs {lp.item():.6g} (rel "
              f"{err['loss']:.3g}); gradient rel L2 per leaf max "
              f"{err['grad']:.3g} ({acc['worst_grad']}); running stats max "
              f"{err['state']:.3g}; {kstep.captures} capture launching "
              f"{acc['launches_per_step']}", flush=True)
        if not finite or kstep.captures != 1 or kgraph.launches != want or \
                any(err[k] > lim for k, lim in TRAIN_F32_TOL.items()):
            fail(f"accumulated step: {acc}, expected launches {want}, "
                 f"limits {TRAIN_F32_TOL}")
        del kstep, kgraph, pk, sk, ok, pp, sp, op_, vk, vp, plain
        torch.cuda.empty_cache()

        # peak memory: 4 x 256 accumulated against a direct 256 (bf16)
        peak = {}
        for k, batch in ((1, RECIPE_BATCH), (ACCUM, ACCUM * RECIPE_BATCH)):
            xb = torch.rand((batch, RECIPE_RES, RECIPE_RES, 3), device=dev)
            tb = torch.randint(0, 1000, (batch,), device=dev)
            trees = fresh(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            cstep = CompiledTrainStep(make_train_step(
                model, crit, sgd(), compute_dtype=torch.bfloat16,
                accum_steps=k))
            for i in range(3):
                *trees, loss = cstep(*trees, i + 1, None, xb, tb, [0.1])
            torch.cuda.synchronize()
            a_, b_ = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a_.record()
            for i in range(3):
                *trees, loss = cstep(*trees, i + 4, None, xb, tb, [0.1])
            b_.record()
            b_.synchronize()
            peak[f"{k}x{RECIPE_BATCH}"] = {
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "peak_over_inputs_and_trees":
                    torch.cuda.max_memory_allocated() - base,
                "ms_per_step": a_.elapsed_time(b_) / 3,
                "loss": loss.item()}
            del xb, tb, trees, cstep, loss
            torch.cuda.empty_cache()
        acc["memory"] = peak
        print(f"peak memory, bf16 compute (remat on): "
              + "; ".join(f"{k}: {r['peak_bytes'] / 2**30:.2f} GiB "
                          f"({r['peak_over_inputs_and_trees'] / 2**30:.2f} "
                          f"GiB above the batch and trees), "
                          f"{r['ms_per_step']:.2f} ms per step"
                          for k, r in peak.items()), flush=True)
        if not all(math.isfinite(r["loss"]) for r in peak.values()):
            fail(f"accumulated bf16 steps: {peak}")
        res["accumulation"] = acc
        del model
        torch.cuda.empty_cache()

        # ----------------------------------------- (c) async and sync
        torch.backends.cudnn.deterministic = True
        lm_v = None
        rs = np.random.RandomState(args.seed + 32)
        xs = rs.randint(0, LM["vocab_size"], (LM_BATCH * LOOP_STEPS, LM_SEQ))
        ys = rs.randint(0, LM["vocab_size"], (LM_BATCH * LOOP_STEPS, LM_SEQ))

        def lm_run(sync, steps, schedule=None, ckpt=None, data=None,
                   trigger=None):
            nonlocal lm_v
            os.environ["BIGDL_TPU_SYNC_LOOP"] = "1" if sync else "0"
            m_ = nn.Transformer(**LM)
            if lm_v is None:
                lm_v = lm_variables(m_, args.seed)
            load_jax_variables(m_, lm_v)
            base = DataSet.from_arrays(xs, ys, batch_size=LM_BATCH)
            o = (Optimizer.apply(
                m_, base if data is None else data(base),
                nn.TimeDistributedCriterion(
                    nn.ClassNLLCriterion(logits=True)),
                end_trigger=trigger or Trigger.max_iteration(steps),
                device=dev)
                .set_optim_method(Adam(1e-3, schedule=schedule))
                .set_gradient_clipping_by_l2_norm(1.0)
                .set_compute_dtype(torch.bfloat16))
            if ckpt is not None:
                o.set_checkpoint(str(ckpt), Trigger.several_iteration(
                    LOOP_CKPT_EVERY))
            calls.clear()
            try:
                o.optimize()
            finally:
                del os.environ["BIGDL_TPU_SYNC_LOOP"]
            torch.cuda.synchronize()
            return o, list(calls)

        runs = {}
        for sync in (False, True):
            o, recs = lm_run(sync, LOOP_STEPS)
            runs[sync] = {"losses": torch.stack([c["loss"] for c in recs]),
                          "params": o.final_params,
                          "state": o.final_state,
                          "ms_per_step": step_ms(recs[2:]),
                          "captures": o.train_step.captures,
                          "summary": o.metrics.summary()}
        same_losses = torch.equal(runs[False]["losses"],
                                  runs[True]["losses"])
        same_trees = all(
            torch.equal(runs[False][kind][k], runs[True][kind][k])
            for kind in ("params", "state") for k in runs[False][kind])
        loop = {"steps": LOOP_STEPS,
                "losses": runs[False]["losses"].tolist(),
                "losses_bit_equal": same_losses,
                "trees_bit_equal": same_trees,
                "ms_per_step": {"async": runs[False]["ms_per_step"],
                                "sync": runs[True]["ms_per_step"]},
                "summary": {"async": runs[False]["summary"],
                            "sync": runs[True]["summary"]}}
        print(f"LM (T {LM_SEQ}) for {LOOP_STEPS} steps, async and sync loops "
              f"(cuDNN deterministic): losses bit-equal {same_losses}, final "
              f"trees bit-equal {same_trees}; ms per step "
              f"{loop['ms_per_step']}; async {runs[False]['summary']}; sync "
              f"{runs[True]['summary']}", flush=True)
        if not same_losses or not same_trees or \
                runs[False]["captures"] != 1 or runs[True]["captures"] != 1:
            fail(f"async and sync loops differ: {loop}")
        step_device_ms = runs[False]["ms_per_step"]
        del runs

        # a NaN step: found at most a window later, retried from the
        # writer's checkpoint
        d = ROOT / "build" / "ckpt_loop"
        shutil.rmtree(d, ignore_errors=True)
        found = []
        real_recover = optmod.LocalOptimizer._recover_or_reraise
        real_ckpt = optmod.LocalOptimizer._maybe_checkpoint
        ckpt_ms = []

        def recover(self, e, *a):
            found.append(str(e))
            return real_recover(self, e, *a)

        def timed_ckpt(self, *a, **kw):
            t1 = time.perf_counter()
            real_ckpt(self, *a, **kw)
            if self.checkpoint_trigger(a[3]):
                ckpt_ms.append((time.perf_counter() - t1) * 1e3)

        optmod.LocalOptimizer._recover_or_reraise = recover
        optmod.LocalOptimizer._maybe_checkpoint = timed_ckpt
        try:
            o, recs = lm_run(False, LOOP_STEPS, schedule=_NanOnce(LOOP_NAN_AT),
                             ckpt=d)
        finally:
            optmod.LocalOptimizer._recover_or_reraise = real_recover
            optmod.LocalOptimizer._maybe_checkpoint = real_ckpt
            shutil.rmtree(d, ignore_errors=True)
        hit = [re.search(r"iteration (\d+), detected at iteration (\d+)", f)
               for f in found]
        m = o.metrics
        nan = {"failures": found, "retries": o._retries,
               "neval": o._loop_state["neval"],
               "final_loss": o._loop_state["loss"],
               "captures": o.train_step.captures, "steps_run": len(recs),
               "snapshot_ms": m.get("checkpoint_snapshot") * 1e3,
               "snapshots": m.count("checkpoint_snapshot"),
               "wait_ms": m.get("checkpoint_wait") * 1e3,
               "pin_ms": m.get("checkpoint_pin") * 1e3,
               "write_ms": m.get("checkpoint_write") * 1e3,
               "maybe_checkpoint_ms": ckpt_ms,
               "sync_window": o.sync_window}
        print(f"LM NaN step under the async loop: {found}; {o._retries} "
              f"retry, ended at iteration {nan['neval']} with loss "
              f"{nan['final_loss']:.4f} after {len(recs)} steps, "
              f"{nan['captures']} capture; the loop's stall per checkpoint: "
              f"the snapshot (copies into pinned host memory) "
              f"{nan['snapshot_ms']:.2f} ms over {nan['snapshots']}, the wait "
              f"for the previous write {nan['wait_ms']:.2f} ms, pinning the "
              f"buffers once {nan['pin_ms']:.2f} ms (the whole checkpoint "
              f"call, its drain included, {[round(v, 2) for v in ckpt_ms]} "
              f"ms); the writer {nan['write_ms']:.2f} ms per file (phase 9 "
              f"times the synchronous writes)", flush=True)
        if len(hit) != 1 or not hit[0] or int(hit[0].group(1)) != \
                LOOP_NAN_AT + 2 or not 0 <= int(hit[0].group(2)) - int(
                    hit[0].group(1)) <= o.sync_window or o._retries != 1 \
                or nan["captures"] != 1 or nan["neval"] != LOOP_STEPS or \
                not math.isfinite(nan["final_loss"]):
            fail(f"async NaN retry: {nan}")
        loop["nan"] = nan
        del o, recs

        # bench.py loop_ab on the LM: a sleep per batch equal to its step
        sleep_s = step_device_ms / 1e3
        walls = {}
        for sync in (True, False):
            stamp = {}

            def until(state):
                if state["neval"] == LOOP_AB_FROM:
                    stamp["t0"] = time.perf_counter()
                return state["neval"] >= LOOP_AB_STEPS

            o, _ = lm_run(sync, LOOP_AB_STEPS, trigger=Trigger(until),
                          data=lambda b: _Sleepy(b, sleep_s))
            walls["sync" if sync else "async"] = \
                time.perf_counter() - stamp["t0"]
            del o
        ab = walls["sync"] / walls["async"]
        loop["loop_ab"] = {"sleep_ms": sleep_s * 1e3, "walls_s": walls,
                           "steps_timed": LOOP_AB_STEPS - LOOP_AB_FROM,
                           "speedup": ab}
        print(f"loop A/B (bench.py loop_ab on the LM, {sleep_s * 1e3:.2f} ms "
              f"of sleep per batch = its step, steps {LOOP_AB_FROM + 1}-"
              f"{LOOP_AB_STEPS}): sync {walls['sync']:.3f} s, async "
              f"{walls['async']:.3f} s, {ab:.3f}x (gate {LOOP_AB_GATE}x)",
              flush=True)
        if ab < LOOP_AB_GATE:
            fail(f"async loop only {ab:.3f}x the synchronous one: {loop}")
        res["loop"] = loop
    finally:
        optmod.CompiledTrainStep.__call__ = real_call
        optmod.LocalOptimizer._build_step_fn = real_build
        torch.backends.cudnn.deterministic = deterministic
        os.environ.pop("BIGDL_TPU_SYNC_LOOP", None)
        if prev_loop is not None:
            os.environ["BIGDL_TPU_SYNC_LOOP"] = prev_loop
    return res


# the recipe on data files: TFRecord shards written here, read cached and
# streamed, with TensorBoard summaries, checkpoints and a model file
DATA_TRAIN, DATA_VAL = 1024, 256      # records: 4 steps of 256 an epoch
DATA_SHARDS = (8, 2)                  # train, validation
DATA_DIR = ROOT / "build" / "data_phase"


def _tagged_images(n, res, rs, first=0):
    """Seeded uint8 images whose pixel (0, 0) carries the record's index
    in its first two channels, so a batch names its records."""
    x = rs.randint(0, 256, (n, res, res, 3)).astype("uint8")
    idx = [first + i for i in range(n)]
    x[:, 0, 0, 0] = [i % 256 for i in idx]
    x[:, 0, 0, 1] = [i // 256 for i in idx]
    return x


def _record_ids(features):
    """The record indices a batch of normalized images carries (the
    inverse of make_image_parser's (x / 255 - mean) / std at pixel 0, 0)."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sharded import _IMAGENET_MEAN, _IMAGENET_STD

    p = np.rint((np.asarray(features)[:, 0, 0, :2] * _IMAGENET_STD[:2]
                 + _IMAGENET_MEAN[:2]) * 255).astype(int)
    return (p[:, 0] + 256 * p[:, 1]).tolist()


def data_phase(args, card, synthetic, dev="cuda"):
    """Phase 11: the recipe of phase 10 on data files.  DATA_TRAIN and
    DATA_VAL seeded RECIPE_RES-px images go into DATA_SHARDS TFRecord
    shards under build/ (``write_image_shards``): ``native_available()``,
    ``count_tfrecords`` and every record's CRC checked, and the threaded
    reader's records/s and MB/s timed.  Then ``resnet_train.main`` with
    ``--folder`` in place of ``--syntheticSize``, ``--summary`` and
    ``--checkpoint --overwrite``, cached and then ``--streaming``, on the
    async loop: one capture launching kernels 1-5 72/36/36/26/13 times
    per step, finite losses, the recipe's learning rates, each cached
    epoch every record once, the event file's Loss, Throughput and
    LearningRate at each iteration, the checkpoint equal to the final
    trees, and ``save_model``/``load_model`` of the trained model giving
    a bit-equal forward on a validation batch.  ms per step, the
    producer's ``data``, the loop's ``data_stall``, the time to the first
    batch and the host's peak RSS of both modes are printed beside phase
    10's step on arrays (``synthetic``).  The shards, event files and
    checkpoints are removed at the end.  ``dev="cpu"`` serves a rehearsal
    with the sizes shrunk: the plain versions run there, so it checks no
    launches.  Returns the results."""
    import resource
    import types

    import numpy as np
    import torch

    from bigdl_tpu_torch.dataset import record_io
    from bigdl_tpu_torch.dataset import sharded as tsh
    from bigdl_tpu_torch.models import ResNet, resnet_train
    from bigdl_tpu_torch.ops import fused_matmul as fm
    from bigdl_tpu_torch.optim import optimizer as optmod
    from bigdl_tpu_torch.utils import (export_variables, flatten, load_model,
                                       load_pytree, save_model)
    from bigdl_tpu_torch.visualization import read_events

    print(f"data phase on {card}", flush=True)
    if not record_io.native_available():
        fail("record_io: the C++ reader did not build or load (g++)")
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    shards = DATA_DIR / "shards"
    rs = np.random.RandomState(args.seed + 40)
    t0 = time.perf_counter()
    written = {}
    for split, n, k, first in (("train", DATA_TRAIN, DATA_SHARDS[0], 0),
                               ("validation", DATA_VAL, DATA_SHARDS[1],
                                DATA_TRAIN)):
        images = _tagged_images(n, RECIPE_RES, rs, first)
        written[split] = tsh.write_image_shards(
            str(shards), images, rs.randint(0, 1000, n), k, split)
    write_s = time.perf_counter() - t0
    counts = {s: sum(tsh.count_tfrecords(p) for p in ps)
              for s, ps in written.items()}
    if counts != {"train": DATA_TRAIN, "validation": DATA_VAL}:
        fail(f"count_tfrecords: {counts}")
    # every record's CRCs by the sequential reader; the C++ CRC against
    # the pure-Python one on one record
    t0 = time.perf_counter()
    crc_records = sum(1 for ps in written.values() for p in ps
                      for _ in record_io.read_tfrecords(p))
    crc_s = time.perf_counter() - t0
    rec = next(record_io.read_tfrecords(written["train"][0]))
    if crc_records != DATA_TRAIN + DATA_VAL or record_io.masked_crc32c(
            rec) != record_io.py_masked_crc32c(rec):
        fail(f"CRC check: {crc_records} records read")
    train_bytes = sum(os.path.getsize(p) for p in written["train"])
    t0 = time.perf_counter()
    reader = record_io.PrefetchingRecordReader(written["train"])
    got = sum(1 for _ in reader)
    read_s = time.perf_counter() - t0
    crc_errors = reader.crc_errors
    reader.close()
    parse = tsh.make_image_parser(RECIPE_RES)
    recs = list(record_io.read_tfrecords(written["train"][0]))
    t0 = time.perf_counter()
    for r in recs:
        parse(r)
    parse_ms = (time.perf_counter() - t0) / len(recs) * 1e3
    if got != DATA_TRAIN or crc_errors:
        fail(f"threaded reader: {got} records, {crc_errors} CRC errors")
    res = {"write_s": write_s, "records": counts, "train_bytes": train_bytes,
           "crc_check_s": crc_s,
           "reader": {"records_per_s": got / read_s,
                      "mb_per_s": train_bytes / read_s / 1e6,
                      "threads": 4, "seconds": read_s},
           "parse_ms_per_record": parse_ms}
    print(f"shards: {DATA_TRAIN} + {DATA_VAL} records of {RECIPE_RES}x"
          f"{RECIPE_RES}x3 uint8 in {DATA_SHARDS[0]} + {DATA_SHARDS[1]} "
          f"TFRecord files ({train_bytes / 1e6:.1f} MB of train) written in "
          f"{write_s:.2f} s; every CRC checked ({crc_s:.2f} s); the threaded "
          f"reader {res['reader']['records_per_s']:.0f} records/s, "
          f"{res['reader']['mb_per_s']:.0f} MB/s over the train shards; "
          f"make_image_parser {parse_ms:.3f} ms a record", flush=True)

    prev_loop = os.environ.pop("BIGDL_TPU_SYNC_LOOP", None)
    calls, opts, seen = [], [], {"ids": [], "first_s": []}
    real_call = optmod.CompiledTrainStep.__call__
    real_build = optmod.LocalOptimizer._build_step_fn
    real_data = tsh.ShardedFileDataSet.data
    real_load = tsh.ShardedFileDataSet._load

    def call(self, *a):
        out = real_call(self, *a)
        ev = None
        if dev == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        calls.append({"lrs": list(a[7]), "loss": out[3].detach().clone(),
                      "event": ev})
        return out

    def build(self, model):
        opts.append(self)
        return real_build(self, model)

    def data(self, train):
        """The training stream, recorded: the records of each batch and
        the time to the first batch."""
        t_start = time.perf_counter()
        for i, b in enumerate(real_data(self, train)):
            if train:
                if i == 0:
                    seen["first_s"].append(time.perf_counter() - t_start)
                seen["ids"].append(_record_ids(b.get_input()))
            yield b

    def load(self):
        """The cached mode's parse of every local record, timed."""
        first = self._records is None
        t_start = time.perf_counter()
        real_load(self)
        if first:
            seen.setdefault("load_s", []).append(
                time.perf_counter() - t_start)

    def step_ms(recs):
        if dev != "cuda" or len(recs) < 2:
            return float("nan")
        torch.cuda.synchronize()
        return statistics.median(a["event"].elapsed_time(b["event"])
                                 for a, b in zip(recs, recs[1:]))

    recipe_args = types.SimpleNamespace(
        learningRate=0.1, maxLr=3.2, warmupEpoch=1, maxEpoch=2,
        momentum=0.9, weightDecay=1e-4, optim="lars")
    ref = resnet_train.make_recipe_optim(recipe_args, RECIPE_ITERS_PER_EPOCH)
    want_lrs = []
    for n in range(2 * RECIPE_ITERS_PER_EPOCH):
        ref.state["neval"] = n
        ref.state["epoch"] = n // RECIPE_ITERS_PER_EPOCH
        want_lrs.append(ref.current_rate())
    argv = list(RECIPE_ARGV)
    at = argv.index("--syntheticSize")
    argv[at:at + 2] = ["--folder", str(shards)]
    ckpt = DATA_DIR / "ckpt"
    optmod.CompiledTrainStep.__call__ = call
    optmod.LocalOptimizer._build_step_fn = build
    tsh.ShardedFileDataSet.data = data
    tsh.ShardedFileDataSet._load = load
    deterministic = torch.backends.cudnn.deterministic
    try:
        for mode in ("cached", "streaming"):
            logs = DATA_DIR / f"logs_{mode}"
            run_argv = argv + ["--summary", str(logs), "--checkpoint",
                               str(ckpt), "--overwrite"] + (
                ["--streaming"] if mode == "streaming" else [])
            calls.clear()
            opts.clear()
            seen["ids"].clear()
            seen["first_s"].clear()
            seen["load_s"] = []
            fm.reset_launches()
            t0 = time.perf_counter()
            top = resnet_train.main(run_argv)
            if dev == "cuda":
                torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            opt = opts[-1]
            step = opt.train_step
            m = opt.metrics
            losses = [c["loss"].item() for c in calls]
            got_lrs = [c["lrs"][0] for c in calls]
            r = {"argv": run_argv, "seconds": main_s, "result": top,
                 "captures": step.captures, "replays": step.replays,
                 "losses": losses, "lrs": got_lrs,
                 "ms_per_step": step_ms(calls[RECIPE_ITERS_PER_EPOCH:]),
                 "data_ms": m.get("data") * 1e3,
                 "data_ms_last": m.last("data") * 1e3,
                 "data_stall_ms": m.get("data_stall") * 1e3,
                 "data_stall_ms_last": m.last("data_stall") * 1e3,
                 "first_batch_s": seen["first_s"][0],
                 "load_s": seen["load_s"],
                 "peak_rss_bytes": resource.getrusage(
                     resource.RUSAGE_SELF).ru_maxrss * 1024,
                 "summary": m.summary()}
            if dev == "cuda":
                (graph,) = step.graphs.values()
                r["launches_per_step"] = dict(graph.launches)
                if step.captures != 1 or graph.launches != \
                        STEP_LAUNCHES[True]:
                    fail(f"{mode} folder recipe: {step.captures} captures, "
                         f"launches per step {graph.launches} (expected "
                         f"{STEP_LAUNCHES[True]})")
            r["images_per_s"] = RECIPE_BATCH / r["ms_per_step"] * 1e3
            if len(calls) != 2 * RECIPE_ITERS_PER_EPOCH or \
                    got_lrs != want_lrs or not all(
                        math.isfinite(v) for v in losses) or \
                    set(top) != {"Top1Accuracy", "Top5Accuracy"}:
                fail(f"{mode} folder recipe: {len(calls)} steps, lrs "
                     f"{got_lrs} (want {want_lrs}), losses {losses}, "
                     f"result {top}")
            if mode == "cached":
                # each epoch's batches: every record once
                per_epoch = [sorted(i for b in seen["ids"][e:e + RECIPE_ITERS_PER_EPOCH]
                                    for i in b)
                             for e in (0, RECIPE_ITERS_PER_EPOCH)]
                if any(ids != list(range(DATA_TRAIN)) for ids in per_epoch):
                    fail("cached folder recipe: an epoch did not read every "
                         "record once")
                r["epochs_cover_every_record"] = True
            # the event file: Loss, Throughput, LearningRate per iteration
            tdir = logs / "resnet_train" / "train"
            events = [e for f in sorted(os.listdir(tdir))
                      for e in read_events(str(tdir / f))]
            steps = list(range(1, 2 * RECIPE_ITERS_PER_EPOCH + 1))
            tags = {tag: [e["step"] for e in events if e["tag"] == tag]
                    for tag in ("Loss", "Throughput", "LearningRate")}
            ev_loss = [e["value"] for e in events if e["tag"] == "Loss"]
            if any(v != steps for v in tags.values()) or not np.allclose(
                    ev_loss, losses, rtol=1e-6) or \
                    (logs / "resnet_train" / "validation").exists():
                fail(f"{mode} event file: steps {tags}, Loss {ev_loss} "
                     f"against {losses}")
            r["event_tags"] = sorted({e["tag"] for e in events if e["tag"]})
            # the checkpoint: the final trees
            blob = load_pytree(str(ckpt / "model"))
            final = export_variables(opt.model, opt.final_params,
                                     opt.final_state)
            fp, bp = flatten(final["params"]), flatten(blob["params"])
            if blob["driver_state"]["neval"] != 2 * RECIPE_ITERS_PER_EPOCH \
                    or fp.keys() != bp.keys() or not all(
                        np.array_equal(fp[k], bp[k]) for k in fp):
                fail(f"{mode} checkpoint: not the final trees")
            res[mode] = r
            print(f"resnet_train.main({' '.join(run_argv)}): {main_s:.1f} s, "
                  f"{top}; {step.captures} capture, launches per step "
                  f"{r.get('launches_per_step')}; {r['ms_per_step']:.2f} ms "
                  f"per step in epoch 2 ({r['images_per_s']:.1f} images/s; "
                  f"phase 10 on arrays {synthetic['ms_per_step']:.2f}); "
                  f"data {r['data_ms']:.2f} ms per batch on the prefetch "
                  f"thread (the last {r['data_ms_last']:.2f}; phase 10 "
                  f"{synthetic['data_ms']:.2f}), data_stall "
                  f"{r['data_stall_ms']:.2f} ms (the last "
                  f"{r['data_stall_ms_last']:.2f}); first batch after "
                  f"{r['first_batch_s']:.2f} s (cached loads, train and "
                  f"validation: {[round(v, 2) for v in r['load_s']]} s); "
                  f"peak RSS "
                  f"{r['peak_rss_bytes'] / 2**30:.2f} GiB; events "
                  f"{r['event_tags']} at steps 1-{len(steps)}; checkpoint = "
                  f"final trees; losses {[round(v, 4) for v in losses]}",
                  flush=True)
            if mode == "streaming":
                continue
            # the model file: the trained model's forward, bit for bit
            torch.backends.cudnn.deterministic = True
            path = str(DATA_DIR / "model")
            t0 = time.perf_counter()
            save_model(path, opt.model)
            save_s = time.perf_counter() - t0
            fresh = ResNet(class_num=1000, depth=50, fused=True, device=dev)
            blob = load_model(path, fresh)
            val = tsh.imagenet_tfrecord_dataset(
                str(shards), "validation", 32, RECIPE_RES, process_id=0,
                num_processes=1)
            x = torch.from_numpy(next(iter(val.data(False))).get_input()).to(
                dev)
            with torch.no_grad():
                opt.model.eval()
                fresh.eval()
                a, b = opt.model(x), fresh(x)
            torch.backends.cudnn.deterministic = deterministic
            same = torch.equal(a, b) and bool(torch.isfinite(a).all())
            res["model_file"] = {"class": blob["class"], "save_s": save_s,
                                 "bytes": os.path.getsize(path + ".npz"),
                                 "forward_bit_equal": same}
            print(f"save_model/load_model: {blob['class']}, "
                  f"{res['model_file']['bytes']} bytes in {save_s:.2f} s; "
                  f"the loaded model's forward on 32 validation images "
                  f"bit-equal {same}", flush=True)
            if not same:
                fail("save_model/load_model: the forwards differ")
            del fresh, a, b, x, blob, opt, step
            opts.clear()
            if dev == "cuda":
                torch.cuda.empty_cache()
    finally:
        optmod.CompiledTrainStep.__call__ = real_call
        optmod.LocalOptimizer._build_step_fn = real_build
        tsh.ShardedFileDataSet.data = real_data
        tsh.ShardedFileDataSet._load = real_load
        torch.backends.cudnn.deterministic = deterministic
        if prev_loop is not None:
            os.environ["BIGDL_TPU_SYNC_LOOP"] = prev_loop
        opts.clear()
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    return res


def tick_checks(model, rs):
    """The server's programs as a server uses them: TICK_SLOTS slots of
    TICK_LEN, prompts of 5 to 200 tokens prefilled in buckets and written
    into slots, greedy ticks until every row has TICK_NEW tokens (the
    long prompts admitted after TICK_LATE ticks); compiled against the
    same programs eager, dense against paged, then the sampling tick."""
    import torch

    from bigdl_tpu_torch.serving import decode as sd
    from bigdl_tpu_torch.serving.paging import (PageAllocator,
                                                default_num_pages)
    from bigdl_tpu_torch.utils import graphs

    dev = torch.device("cuda")
    s_, vocab = TICK_SLOTS, LM["vocab_size"]
    lengths = rs.randint(TICK_PROMPT[0], TICK_PROMPT[1] + 1, s_)
    lengths[:2] = TICK_PROMPT
    prompts = [rs.randint(0, vocab, n) for n in lengths]
    # admission waves: (bucket, [(row of the batch, slot)], tick)
    waves = []
    for wave, bucket in enumerate(TICK_BUCKETS):
        slots = [s for s in range(s_) if (lengths[s] > TICK_BUCKETS[0])
                 == (bucket != TICK_BUCKETS[0])]
        for lo in range(0, len(slots), TICK_BATCH):
            waves.append((bucket, slots[lo:lo + TICK_BATCH],
                          0 if wave == 0 else TICK_LATE))

    def batch(bucket, slots):
        ids = torch.zeros((TICK_BATCH, bucket), dtype=torch.int64)
        lens = torch.ones(TICK_BATCH, dtype=torch.int32)
        for r, s in enumerate(slots):
            ids[r, :lengths[s]] = torch.from_numpy(prompts[s])
            lens[r] = int(lengths[s])
        return ids.to(dev), lens.to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    def serve(prefill, write, tick, grid):
        """Run the waves; ``tick(grid, tokens, active)`` returns the next
        tokens.  Returns each slot's TICK_NEW tokens (host, once)."""
        tokens = torch.zeros(s_, dtype=torch.int32, device=dev)
        active = torch.zeros(s_, dtype=torch.bool, device=dev)
        made, hist, n_ticks = [0] * s_, [], 0
        first = {}
        pending = list(waves)
        while pending or any(0 < n < TICK_NEW for n in made):
            for w in [w for w in pending if w[2] <= n_ticks]:
                pending.remove(w)
                bucket, slots, _ = w
                last, bc = prefill[bucket](*batch(bucket, slots))
                nxt = last.argmax(-1).to(torch.int32)
                for r, s in enumerate(slots):
                    grid = write[bucket](grid, bc, scalar(r), scalar(s))
                    tokens[s] = nxt[r]
                    active[s] = True
                    made[s] = 1
                    first[s] = nxt[r].clone()
            grid, nxt = tick(grid, tokens, active)
            n_ticks += 1
            hist.append((nxt.clone(), [s for s in range(s_)
                                       if 0 < made[s] < TICK_NEW]))
            tokens = nxt
            for s in range(s_):
                if 0 < made[s] < TICK_NEW:
                    made[s] += 1
                    if made[s] == TICK_NEW:
                        active[s] = False
        out = {s: [first[s]] for s in range(s_)}
        for nxt, live in hist:
            for s in live:
                out[s].append(nxt[s])
        return ({s: torch.stack(v).tolist() for s, v in out.items()},
                n_ticks, grid)

    res = {"prompt_lengths": lengths.tolist()}
    # eager: the raw programs
    eager_prefill = sd.prefill_fn(model, TICK_LEN)
    eager_write, eager_tick = sd.write_slot_fn(), sd.decode_tick_fn(model)
    want, n_ticks, _ = serve({b: eager_prefill for b in TICK_BUCKETS},
                             {b: eager_write for b in TICK_BUCKETS},
                             eager_tick, model.init_cache(s_, TICK_LEN))
    # compiled: two prefill buckets, a write per bucket (reading its
    # prefill's outputs in place), one tick
    graphs.reset_counts()
    grid = model.init_cache(s_, TICK_LEN)
    prefill, write = {}, {}
    for b in TICK_BUCKETS:
        prefill[b] = sd.build_prefill(model, TICK_LEN, *batch(b, []))
        _, bc = prefill[b](*batch(b, []))
        write[b] = sd.build_write_slot(grid, bc, scalar(0), scalar(0))
    zeros = torch.zeros(s_, dtype=torch.int32, device=dev)
    tick = sd.build_decode_tick(model, grid, zeros, zeros.bool())
    warm = dict(graphs.COUNTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, ticks, _ = serve(prefill, write, tick, grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = dict(graphs.COUNTS)
    calls = len(waves) + s_ + ticks
    if got != want or ticks != n_ticks:
        bad = [s for s in range(s_) if got[s] != want[s]]
        fail(f"ticks: compiled tokens differ from the eager rollout in "
             f"slots {bad}")
    if after["captures"] != warm["captures"] or \
            after["replays"] - warm["replays"] != calls:
        fail(f"ticks: {after['captures'] - warm['captures']} captures and "
             f"{after['replays'] - warm['replays']} replays while serving, "
             f"expected 0 and {calls} ({len(waves)} prefills, {s_} writes, "
             f"{ticks} ticks)")
    res.update(captures=warm["captures"], ticks=ticks,
               ms_per_tick=wall * 1e3 / ticks,
               tokens_per_s=s_ * TICK_NEW / wall, wall_s=wall,
               steady_tick_ms=replay_ms(tick.graph))
    res["tick_device_ms"], res["tick_top_kernels"] = kernel_ms(
        tick.graph.replay)
    print(f"ticks: {s_} slots of {TICK_LEN}, prompts {lengths.tolist()}, "
          f"{TICK_NEW} tokens each: compiled bit-equal to the eager "
          f"programs in every slot; {warm['captures']} captures before "
          f"serving, none while serving, {calls} replays ({ticks} ticks); "
          f"{res['ms_per_tick']:.4f} ms per tick, "
          f"{res['tokens_per_s']:.1f} tokens/s (admission included); in "
          f"steady state {res['steady_tick_ms']:.4f} ms per tick "
          f"({s_ * 1e3 / res['steady_tick_ms']:.1f} tokens/s at full "
          f"occupancy), device {res['tick_device_ms']:.4f} ms, top "
          f"kernels {res['tick_top_kernels']}", flush=True)

    # paged: pages from a PageAllocator, the paged write and tick
    pages = default_num_pages(s_, TICK_LEN, TICK_PAGE)
    alloc = PageAllocator(pages, TICK_PAGE, s_, TICK_LEN)
    pool = model.init_paged_cache(pages, TICK_PAGE, s_)
    samp = (torch.zeros(s_, dtype=torch.int64, device=dev),
            torch.zeros(s_, device=dev),
            torch.zeros(s_, dtype=torch.int32, device=dev),
            torch.ones(s_, device=dev))
    table = torch.from_numpy(alloc.table).to(dev)
    pwrite = {}
    for b in TICK_BUCKETS:
        _, bc = prefill[b](*batch(b, []))
        pwrite[b] = sd.build_paged_write_slot(pool, table[0], bc,
                                              scalar(0), scalar(0))
    ptick = sd.build_paged_tick(model, pool, table, zeros, zeros.bool(),
                                *samp)

    def paged_write(b):
        def w(p, bc, row, slot):
            s = int(slot)
            alloc.ensure(s, int(lengths[s]) + TICK_NEW)
            table.copy_(torch.from_numpy(alloc.table))
            return pwrite[b](p, table[s], bc, row, slot)
        return w

    pgot, _, _ = serve(prefill, {b: paged_write(b) for b in TICK_BUCKETS},
                       lambda p, t, a: ptick(p, table, t, a, *samp)[:2],
                       pool)
    if pgot != got:
        fail(f"ticks: the paged pool's tokens differ from the dense grid's "
             f"in slots {[s for s in range(s_) if pgot[s] != got[s]]}")
    res["paged_pages_in_use"] = alloc.pages_in_use
    print(f"paged ticks (f32 pool, {pages} pages of {TICK_PAGE}, "
          f"{alloc.pages_in_use} granted): tokens equal the dense grid's",
          flush=True)

    # sampling: half the rows at temp 0.8, top_k 40, top_p 0.9
    for b, slots, _ in waves:  # every slot admitted at once
        last, bc = prefill[b](*batch(b, slots))
        for r, s in enumerate(slots):
            write[b](grid, bc, scalar(r), scalar(s))
    start = graphs.clone(grid)
    tokens0 = torch.arange(s_, dtype=torch.int32, device=dev)
    on = torch.ones(s_, dtype=torch.bool, device=dev)
    hot = torch.arange(s_, device=dev) % 2 == 0
    temp = torch.where(hot, 0.8, 0.0)
    top_k = torch.where(hot, 40, 0).to(torch.int32)
    top_p = torch.where(hot, 0.9, 1.0)
    keys = torch.arange(s_, dtype=torch.int64, device=dev) * 7919 + 1
    stick = sd.build_sampling_tick(model, grid, tokens0, on, keys, temp,
                                   top_k, top_p)

    def run(sampled):
        for lk, c in grid.items():
            for name, leaf in c.items():
                leaf.copy_(start[lk][name])
        t, k, out = tokens0, keys, []
        for _ in range(SAMPLE_TICKS):
            if sampled:
                _, t, k = stick(grid, t, on, k, temp, top_k, top_p)
                k = k.clone()
            else:
                _, t = tick(grid, t, on)
            t = t.clone()
            out.append(t)
        return torch.stack(out)

    a, b2, g = run(True), run(True), run(False)
    greedy_rows = ~hot
    if not torch.equal(a, b2) or not torch.equal(a[:, greedy_rows],
                                                 g[:, greedy_rows]):
        fail("sampling tick: the same keys gave other tokens, or its greedy "
             "rows differ from the greedy tick's")
    res["sampling"] = {"repeats": True, "greedy_rows_equal": True,
                       "distinct_sampled_tokens": len(set(
                           a[:, hot].flatten().tolist()))}
    print(f"sampling tick ({SAMPLE_TICKS} ticks, rows 0, 2, 4, 6 at temp "
          f"0.8, top_k 40, top_p 0.9): repeats under the same keys, greedy "
          f"rows equal the greedy tick's", flush=True)
    return res


def int8_kv_checks(model, rs):
    """The LM with D 128 over an int8 paged pool: each extend_paged chunk
    of DECODE_CHUNK tokens, and then a speculative verify's window of
    INT8_SPEC_K + 1, runs kernel 7 layers x slots x heads times (no
    operand copy) and gives logits and a pool bit-equal to the same call
    with the scores on the kernel's plain version; a decode step (Tq 1)
    runs it not at all.  Kernel 7's device ms per chunk is the profiler's
    sum over the chunk's kernel-7 launches; the bare call is timed at
    the chunk's product beside its plain version and _int_mm."""
    import torch

    from bigdl_tpu_torch.ops import int8_matmul as im
    from bigdl_tpu_torch.ops import paged_kv
    from bigdl_tpu_torch.serving.paging import PageAllocator

    dev = torch.device("cuda")
    s_, page = INT8_SLOTS, TICK_PAGE
    pages = s_ * INT8_EXTENT // page + 1
    alloc = PageAllocator(pages, page, s_, INT8_EXTENT)
    for s in range(s_):
        alloc.ensure(s, INT8_EXTENT)
    table = torch.from_numpy(alloc.table).to(dev)
    active = torch.ones(s_, dtype=torch.bool, device=dev)
    pool = model.init_paged_cache(pages, page, s_, kv_dtype="int8")
    ids = torch.from_numpy(rs.randint(0, LM["vocab_size"], (
        s_, INT8_CHUNKS * DECODE_CHUNK))).to(dev)
    d = LM["hidden_size"] // INT8_HEADS
    want = LM["num_layers"] * s_ * INT8_HEADS
    window = INT8_SPEC_K + 1  # a speculative verify's Tq
    for tq in (DECODE_CHUNK, window):
        if not paged_kv._int8_eligible(tq, INT8_EXTENT, d, dev):
            fail(f"int8 KV: ({tq}, {d}, {INT8_EXTENT}) is not eligible "
                 "for kernel 7")

    def checked(what, chunk, pool):
        """``extend_paged`` over ``chunk`` through kernel 7 and again with
        the scores on its plain version: both must give the same logits
        and pool, with want launches and no operand copy.  Returns the
        logits, the new pool and kernel 7's device ms (profiler sum)."""
        im.reset_launches()
        out = []
        ran, _, by_kernel = replay_kernels(lambda: out.append(
            model.extend_paged(pool, table, chunk, active)), by_kernel=True)
        (logits, new), = out
        got = dict(im.LAUNCHES)
        kernel, paged_kv.int8_matmul_dequant = \
            paged_kv.int8_matmul_dequant, im.int8_matmul_dequant_plain
        try:
            plain, pnew = model.extend_paged(pool, table, chunk, active)
        finally:
            paged_kv.int8_matmul_dequant = kernel
        if got != {"int8_matmul": want, "int8_matmul_w_relayout": 0,
                   "int8_matmul_pad": 0} or \
                ran.get("int8_matmul") != want:
            fail(f"int8 KV {what}: launches {got}, on the card "
                 f"{ran.get('int8_matmul')}, expected {want} kernel 7 "
                 "launches and no operand copy")
        # the pools alike outside the trash page 0 (several writes may
        # land there, in any order)
        if not torch.equal(logits, plain) or any(
                not torch.equal(new[lk][n][1:], pnew[lk][n][1:])
                for lk in new for n in new[lk] if n != "length"):
            fail(f"int8 KV {what}: the kernel route's logits or pool "
                 "differ from the plain route's")
        return logits, new, by_kernel["int8_matmul"]

    per_chunk, chunk_ms = [], []
    for c in range(INT8_CHUNKS):
        logits, pool, ms = checked(f"chunk {c}", ids[:, c * DECODE_CHUNK:
                                                     (c + 1) * DECODE_CHUNK],
                                   pool)
        per_chunk.append(want)
        chunk_ms.append(ms)
    # the speculative verify's window at draft_k INT8_SPEC_K: the engine's
    # QK^T of (Tq 8, D 128) against the pool of INT8_EXTENT
    logits, pool, ms = checked(f"verify window of {window}",
                               ids[:, :window], pool)
    verify = {"shape": [window, d, INT8_EXTENT], "launches": want,
              "kernel7_ms": ms, "bit_equal_to_plain": True}
    im.reset_launches()
    step, pool = model.decode_step_paged(pool, table, logits[:, -1].argmax(
        -1).to(torch.int32), active)
    torch.cuda.synchronize()
    if im.LAUNCHES["int8_matmul"] or not torch.isfinite(step).all():
        fail(f"int8 KV decode step: {im.LAUNCHES} (expected no kernel 7 "
             "launch at Tq 1), or non-finite logits")

    # kernel 7 at the chunk's product: q (Tq, D) @ k_q.T (D, L), f32 out
    x = torch.randint(-127, 128, (DECODE_CHUNK, d), device=dev).to(
        torch.int8)
    kq = torch.randint(-127, 128, (INT8_EXTENT, d), device=dev).to(
        torch.int8)
    sc = torch.rand(INT8_EXTENT, device=dev) * 1e-4
    w, wk = kq.t(), kq.t().contiguous()
    xp = torch.zeros((24, d), dtype=torch.int8, device=dev)  # _int_mm: M>16
    xp[:DECODE_CHUNK] = x

    def library():
        return torch._int_mm(xp, wk)[:DECODE_CHUNK].float() * sc

    bytes_ms, ops_ms = int8_bound((DECODE_CHUNK, d, INT8_EXTENT), 4)
    err = (im.int8_matmul_dequant(x, w, sc, torch.float32)
           - im.int8_matmul_dequant_plain(x, w, sc, torch.float32)).abs(
    ).max().item()
    r = {"shape": [DECODE_CHUNK, d, INT8_EXTENT], "max_abs_err": err,
         "ms": device_ms(lambda: im.int8_matmul_dequant(x, w, sc,
                                                        torch.float32)),
         "plain_ms": device_ms(lambda: im.int8_matmul_dequant_plain(
             x, w, sc, torch.float32), reps=2),
         "library_ms": device_ms(library), "bytes_ms": bytes_ms,
         "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
         "launches_per_chunk": per_chunk, "launches": sum(per_chunk),
         "chunk_ms": chunk_ms, "ms_per_chunk": statistics.median(chunk_ms),
         "verify_window": verify}
    print(f"int8 KV (LM with {INT8_HEADS} heads of {d}, {s_} slots of "
          f"{INT8_EXTENT}): {INT8_CHUNKS} extend_paged chunks of "
          f"{DECODE_CHUNK}, kernel 7 launches per chunk {per_chunk} (host "
          f"and profiler), no operand copy, logits bit-equal to the plain "
          f"route; a decode step launches none.  Kernel 7's device ms per "
          f"chunk {[round(t, 4) for t in chunk_ms]} (profiler sum; median "
          f"{r['ms_per_chunk']:.4f}, bound {per_chunk[-1] * r['bound_ms']:.5f}"
          f").  Kernel 7 alone at {tuple(r['shape'])}: {r['ms']:.4f} ms "
          f"(plain {r['plain_ms']:.4f}, _int_mm at (24, {d}, {INT8_EXTENT}) "
          f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by bytes, "
          f"max |d| {err}).  A verify window of {window} tokens: {want} "
          f"kernel 7 launches (host and profiler) in "
          f"{verify['kernel7_ms']:.4f} device ms, "
          "logits and pool bit-equal to the plain route", flush=True)
    if err != 0:
        fail(f"int8 KV: kernel 7 differs from its plain version at "
             f"{tuple(r['shape'])}: {err}")
    return r


# --------------------------------------------------- basic-block slice
# kernels 4 and 5 without a prologue (the stride-1 conv1 of every basic
# block): (B, H, W, C, Co) -> calls per forward
BASIC_NO_PROLOGUE = {
    "resnet18": {(256, 56, 56, 64, 64): 2, (256, 28, 28, 128, 128): 1,
                 (256, 14, 14, 256, 256): 1, (256, 7, 7, 512, 512): 1},
    "cifar20": {(128, 32, 32, 16, 16): 3, (128, 16, 16, 32, 32): 2,
                (128, 8, 8, 64, 64): 2}}
# one FusedBasicBlock at ResNet-18 shapes, kernels vs plain path (f32)
BASIC_BLOCKS = ((64, 64, 1, 56), (64, 128, 2, 56))  # n_in, n_out, stride, hw
_K15 = ("fused_matmul_bn", "fused_matmul_bn_dgrad", "fused_matmul_bn_wgrad",
        "fused_conv3x3_bn", "fused_conv3x3_bn_dgrad")
# kernels 1-5 per train step: kernel 4 once per stride-1 conv1 and per
# conv2, kernel 1 per projection, each twice with remat (the recompute)
BASIC_LAUNCHES = {k: dict(zip(_K15, v)) for k, v in {
    ("resnet18", True): (6, 3, 3, 26, 13),
    ("resnet18", False): (3, 3, 3, 13, 13),
    ("resnet34", True): (6, 3, 3, 58, 29),
    ("cifar20", True): (4, 2, 2, 32, 16)}.items()}
BASIC_RECIPE_ARGV = ["--fused", "--depth", "18", "-b", "256",
                     "--syntheticSize", "1024", "--maxEpoch", "2",
                     "--optim", "lars", "--warmupEpoch", "1"]
CIFAR_ARGV = ["--dataset", "cifar10", "--depth", "20", "--fused", "-b",
              "128", "--maxEpoch", "2"]
CIFAR_RECORDS = (256, 256)  # per data_batch_{1..5}.bin, in test_batch.bin
BASIC_RES = 224  # the ResNet-18/34 steps' images
CIFAR_DIR = ROOT / "build" / "basic_cifar"
CRITERION_RTOL = 1e-5
# phase 2's deepest f32 reduction (kernel 5 at Co 128: 9 x 128 terms),
# the depth its f32 absolute tolerance was set at
F32_REDUCTION = 1152


def criterion_cases(nn, rs):
    """``(name, criterion, input, target)`` of every criterion class of
    the port (and ClassNLL's one-hot targets), CPU tensors from ``rs``."""
    import numpy as np
    import torch

    n, c = 16, 10

    def f(*shape, lo=None, hi=None):
        a = rs.randn(*shape) if lo is None else rs.uniform(lo, hi, shape)
        return torch.tensor(a, dtype=torch.float32)

    def sign(*shape):
        return torch.tensor(np.where(rs.rand(*shape) > 0.5, 1.0, -1.0),
                            dtype=torch.float32)

    def labels(*shape):
        return torch.tensor(rs.randint(0, c, shape))

    def probs(*shape):
        return torch.softmax(f(*shape), -1)

    def binary(*shape):
        return torch.tensor(rs.rand(*shape) > 0.5, dtype=torch.float32)

    one_hot = torch.eye(c)[labels(n)]
    mlm = torch.tensor([[3, 0, -1, 1, 2], [2, -1, 4, 0, -1]] * (n // 2))
    cases = [
        ("ClassNLLCriterion", nn.ClassNLLCriterion(logits=True), f(n, c),
         labels(n)),
        ("ClassNLLCriterion one-hot", nn.ClassNLLCriterion(logits=True),
         f(n, c), one_hot),
        ("ClassNLLCriterion soft rows", nn.ClassNLLCriterion(),
         torch.log_softmax(f(n, c), -1), probs(n, c)),
        ("CrossEntropyCriterion", nn.CrossEntropyCriterion(), f(n, c),
         labels(n)),
        ("MSECriterion", nn.MSECriterion(), f(n, 3, 4), f(n, 3, 4)),
        ("AbsCriterion", nn.AbsCriterion(), f(n, c), f(n, c)),
        ("SmoothL1Criterion", nn.SmoothL1Criterion(), 2 * f(n, c),
         f(n, c)),
        ("BCECriterion", nn.BCECriterion(), f(n, c, lo=0.05, hi=0.95),
         binary(n, c)),
        ("BCEWithLogitsCriterion", nn.BCEWithLogitsCriterion(),
         2 * f(n, c), binary(n, c)),
        ("MarginCriterion", nn.MarginCriterion(0.7), f(n, c), sign(n, c)),
        ("HingeEmbeddingCriterion", nn.HingeEmbeddingCriterion(1.5),
         f(n, c).abs(), sign(n, c)),
        ("DistKLDivCriterion", nn.DistKLDivCriterion(),
         torch.log_softmax(f(n, c), -1), probs(n, c)),
        ("KLDCriterion", nn.KLDCriterion(), (f(n, 4), f(n, 4)), None),
        ("CosineEmbeddingCriterion", nn.CosineEmbeddingCriterion(0.1),
         (f(n, 6), f(n, 6)), sign(n)),
        ("MarginRankingCriterion", nn.MarginRankingCriterion(0.5),
         (f(n), f(n)), sign(n)),
        ("MultiLabelSoftMarginCriterion",
         nn.MultiLabelSoftMarginCriterion(), f(n, c), binary(n, c)),
        ("MultiMarginCriterion", nn.MultiMarginCriterion(p=2), f(n, c),
         labels(n)),
        ("SoftMarginCriterion", nn.SoftMarginCriterion(), f(n, c),
         sign(n, c)),
        ("MultiCriterion", nn.MultiCriterion().add(nn.MSECriterion(), 0.5)
         .add(nn.AbsCriterion(), 2.0), f(n, c), f(n, c)),
        ("ParallelCriterion", nn.ParallelCriterion()
         .add(nn.MSECriterion(), 0.5).add(nn.CrossEntropyCriterion()),
         (f(n, 3), f(n, c)), (f(n, 3), labels(n))),
        ("TimeDistributedCriterion", nn.TimeDistributedCriterion(
            nn.ClassNLLCriterion(logits=True)), f(4, 5, c), labels(4, 5)),
        ("ClassSimplexCriterion", nn.ClassSimplexCriterion(), f(n, c),
         f(n, c)),
        ("DiceCoefficientCriterion", nn.DiceCoefficientCriterion(),
         f(n, c, lo=0, hi=1), binary(n, c)),
        ("MeanAbsolutePercentageCriterion",
         nn.MeanAbsolutePercentageCriterion(), f(n, c),
         f(n, c) + 0.5 * sign(n, c)),
        ("MeanSquaredLogarithmicCriterion",
         nn.MeanSquaredLogarithmicCriterion(), f(n, c, lo=0.01, hi=2),
         f(n, c, lo=0.01, hi=2)),
        ("KullbackLeiblerDivergenceCriterion",
         nn.KullbackLeiblerDivergenceCriterion(), probs(n, c),
         probs(n, c)),
        ("PoissonCriterion", nn.PoissonCriterion(), f(n, c, lo=0.1, hi=2),
         torch.tensor(rs.poisson(1.0, (n, c)), dtype=torch.float32)),
        ("CosineProximityCriterion", nn.CosineProximityCriterion(),
         f(n, c), f(n, c)),
        ("CategoricalCrossEntropy", nn.CategoricalCrossEntropy(),
         probs(n, c), one_hot),
        ("CosineDistanceCriterion", nn.CosineDistanceCriterion(), f(n, c),
         f(n, c)),
        ("DotProductCriterion", nn.DotProductCriterion(True), f(n, c),
         f(n, c)),
        ("PGCriterion", nn.PGCriterion(), probs(n, c), one_hot * f(n, 1)),
        ("GaussianCriterion", nn.GaussianCriterion(),
         {1: f(n, 4), 2: f(n, 4)}, f(n, 4)),
        ("L1HingeEmbeddingCriterion", nn.L1HingeEmbeddingCriterion(20.0),
         [f(c), f(c)], torch.tensor(-1.0)),
        ("MultiLabelMarginCriterion", nn.MultiLabelMarginCriterion(),
         f(n, 5), mlm),
        ("SmoothL1CriterionWithWeights",
         nn.SmoothL1CriterionWithWeights(2.0, 3), f(n, c),
         (f(n, c), f(n, c, lo=0, hi=1), f(n, c, lo=0, hi=1))),
        ("SoftmaxWithCriterion", nn.SoftmaxWithCriterion(1), f(4, c, 3, 3),
         labels(4, 3, 3)),
        ("TimeDistributedMaskCriterion", nn.TimeDistributedMaskCriterion(
            nn.ClassNLLCriterion(logits=True)), f(4, 5, c),
         labels(4, 5)),
        ("TransformerCriterion", nn.TransformerCriterion(
            nn.MSECriterion(), nn.Linear(8, 4), nn.Linear(8, 4)), f(n, 8),
         f(n, 8)),
    ]
    return cases


def _to(tree, dev):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def basic_phase(args, card, kt, dev="cuda"):
    """Phase 12, the basic-block family (``kt``: :func:`kernel_tools`):
    (a) kernels 4 and 5 without a prologue at ResNet-18's stride-1 conv1
    shapes at batch 256 and CIFAR-20's at batch 128, bf16 (twice,
    bit-equal) and f32, against their plain versions, timed beside the
    plain version and the library call with their bound; (b) a stride-1
    and a stride-2 FusedBasicBlock at ResNet-18 shapes against the plain
    path in f32 (output, every gradient, running statistics); (c) the
    fused ResNet-18 train step (bf16 compute, batch 256) in one CUDA
    graph with remat on and off: launches per step (and per replay, by
    profiler), no channel padding, ms per step, images/s, peak memory;
    one step at batch 32 against the plain path in bf16 and f32; (d) a
    captured ResNet-34 step at batch 32 and its launches; (e)
    ``resnet_train.main`` with --fused at depth 18 on synthetic 224 px
    images and at CIFAR depth 20 on CIFAR-10 batches written here:
    finite losses, one capture and its launches per step; (f)
    ``fuse_resnet_params`` on the card: the fused ResNet-18 from the
    unfused one's tree gives its eval forward (bf16 within the serving
    tolerance, f32 with the same argmax); (g) every criterion's loss and
    input gradient on the card against the same call on the CPU.
    ``dev="cpu"`` serves a rehearsal with the sizes shrunk and the CUDA
    calls patched.  Returns the results."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import (ResNet, fuse_resnet_params,
                                        resnet_train)
    from bigdl_tpu_torch.ops import fused_matmul as fm
    from bigdl_tpu_torch.optim import (SGD, CompiledTrainStep,
                                       make_train_step, optimizer as optmod)
    from bigdl_tpu_torch.utils import (export_variables, graphs,
                                       load_jax_variables, random_variables)

    t_phase = time.perf_counter()
    print(f"basic-block phase on {card}", flush=True)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 12)
    res = {}

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()

    def exact64(op, o):
        """y (kernel 4) or dx (kernel 5) without a prologue, in f64
        from the f32 operands (ytot rounded to f32, as both round it)."""
        w = o["w"].double().permute(3, 2, 0, 1)
        if op == "cv":
            return torch.nn.functional.conv2d(
                o["x"].double().permute(0, 3, 1, 2), w,
                padding=1).permute(0, 2, 3, 1)
        t = kt.ytot(o, torch.float32).double()
        b, h, wd, ci = o["x"].shape
        return torch.nn.grad.conv2d_input(
            (b, ci, h, wd), w, t.permute(0, 3, 1, 2),
            padding=1).permute(0, 2, 3, 1)

    # ------------------------------------ (a) kernels 4 and 5, no prologue
    rows = []
    for model, shapes in BASIC_NO_PROLOGUE.items():
        for shape, count in shapes.items():
            for op in ("cv", "cv_dgrad"):
                name, kern, plain, _ = kt.kernels[op]
                for dt, dtype in (("bf16", bf16), ("f32", torch.float32)):
                    o = kt.operands(op, shape, False, dtype)
                    got = kt.call(kern, op, o)
                    if dt == "bf16" and not kt.same(got, kt.call(kern, op,
                                                                 o)):
                        fail(f"{name}{shape} no prologue: two runs differ")
                    # f32: the absolute part grows with the reduction
                    # (9 C or 9 Co products) past phase 2's deepest
                    # (1152), as a K-term f32 sum's worst-case error
                    k = 9 * shape[3 if op == "cv" else 4]
                    err = kt.check(f"{name}{shape} {dt}, no prologue", op,
                                   got, kt.call(plain, op, o), dt,
                                   math.prod(shape[:-2]),
                                   max(1.0, k / F32_REDUCTION)
                                   if dt == "f32" else 1.0)
                    if dt == "f32":  # both against the same function in f64
                        f64 = exact64(op, o)
                        errs = [(v[0].double() - f64).abs().max().item()
                                for v in (got, kt.call(plain, op, o))]
                    del got
                    reps = 10 if dt == "bf16" else 2
                    r = {"kernel": name, "model": model, "shape": list(shape),
                         "dtype": dt, "calls_per_forward": count,
                         "max_abs_err": err,
                         "ms": device_ms(lambda: kt.call(kern, op, o), reps),
                         "plain_ms": device_ms(lambda: kt.call(plain, op, o),
                                               reps),
                         "library_ms": device_ms(lambda: kt.library(op, o),
                                                 reps)}
                    if dt == "f32":
                        r["kernel_f64_err"], r["plain_f64_err"] = errs
                    r["bytes_ms"], r["ops_ms"] = kt.bound(op, shape, False,
                                                          dt == "f32")
                    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
                    rows.append(r)
                    print(f"  {name} {shape} {dt}, no prologue, x{count}: "
                          f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                          f"library {r['library_ms']:.4f}, bound "
                          f"{r['bound_ms']:.4f}), max |d| {err:.3g}"
                          + (f"; max |d| from f64: kernel "
                             f"{r['kernel_f64_err']:.3g}, plain "
                             f"{r['plain_f64_err']:.3g}" if dt == "f32"
                             else ""), flush=True)
                    del o
    res["no_prologue"] = rows

    # -------------------------------------- (b) one block, kernels vs plain
    res["blocks"] = {}
    batch = BATCH
    for n_in, n_out, stride, hw in BASIC_BLOCKS:
        bv = random_variables(export_variables(
            nn.FusedBasicBlock(n_in, n_out, stride)), args.seed + 5)
        xb = torch.randn((batch, hw, hw, n_in), generator=gen, device=dev)
        cot = torch.randn((batch, hw // stride, hw // stride, n_out),
                          generator=gen, device=dev)
        got = []
        for plain in (False, True):
            blk = nn.FusedBasicBlock(n_in, n_out, stride).to(dev)
            load_jax_variables(blk, bv)
            nn.use_plain_ops(blk, plain).train()
            xx = xb.clone().requires_grad_(True)
            yb = blk(xx)
            (yb * cot).sum().backward()
            got.append({"out": yb.detach(), "dx": xx.grad,
                        **{k: p.grad for k, p in blk.named_parameters()},
                        **dict(blk.named_buffers())})
        err = {k: rel(got[0][k], got[1][k]) for k in got[1]}
        worst = max(err, key=err.get)
        what = f"basic block({n_in}, {n_out}, stride {stride}) at {hw}x{hw}"
        res["blocks"][what] = err[worst]
        print(f"basic parity, {what}, f32: output, gradients and running "
              f"stats rel L2 max {err[worst]:.3g} ({worst})", flush=True)
        if err[worst] > BLOCK_TOL or not all(
                torch.isfinite(t).all() for t in got[0].values()):
            fail(f"{what}: kernels disagree with the plain path: {worst} "
                 f"{err[worst]:.3g} > {BLOCK_TOL}")
        del got, xb, cot

    # ------------------------------------------- (c) the ResNet-18 step
    crit = nn.ClassNLLCriterion(logits=True)

    def sgd():
        return {"__all__": SGD(0.1, momentum=0.9)}

    def fresh(m):
        params = {k: p.detach().clone() for k, p in m.named_parameters()}
        state = {k: b.detach().clone() for k, b in m.named_buffers()}
        return params, state, {"__all__": SGD(0.1, momentum=0.9)
                               .init_state(params)}

    def set_remat(m, on):
        for blk in m.modules():
            if isinstance(blk, nn.FusedBasicBlock):
                blk.remat = on

    def captured(what, step, trees, x, t, want):
        """One compiled step: its capture's launches (and the host's
        count) must be ``want``, with no channel padding."""
        fm.reset_launches()
        compiled = CompiledTrainStep(step)
        trees = compiled(*trees, 1, None, x, t, [0.1])[:3]
        (graph,) = compiled.graphs.values()
        if graph.launches != want or fm.LAUNCHES != host_launches(
                want, 1) or fm.COPIES["fused_channel_pad"]:
            fail(f"{what}: the capture launched {graph.launches}, the host "
                 f"counted {fm.LAUNCHES}, channel pads {fm.COPIES}; "
                 f"expected {want} per capture and no padding")
        return compiled, graph, trees

    res18, big = BASIC_RES, TRAIN_BATCH
    m18 = ResNet(1000, 18, fused=True, device=dev)
    v18 = random_variables(export_variables(m18), args.seed + 18)
    load_jax_variables(m18, v18)
    step = make_train_step(m18, crit, sgd(), compute_dtype=bf16)
    x = torch.rand((big, res18, res18, 3), generator=gen, device=dev).to(bf16)
    t = torch.randint(0, 1000, (big,), generator=gen, device=dev)
    res["resnet18_step"] = {}
    for remat in (True, False):
        set_remat(m18, remat)
        what = f"ResNet-18 step at batch {big}, remat {'on' if remat else 'off'}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        compiled, graph, trees = captured(
            what, step, fresh(m18), x, t, BASIC_LAUNCHES[("resnet18", remat)])
        replay = check_graph(what, graph, BASIC_LAUNCHES[("resnet18", remat)],
                             lambda: compiled(*trees, 2, None, x, t, [0.1]))
        for i in range(3):
            *trees, loss = compiled(*trees, i + 3, None, x, t, [0.1])
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(TIMED_STEPS):
            *trees, loss = compiled(*trees, i + 6, None, x, t, [0.1])
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / TIMED_STEPS
        r = {"launches_per_step": graph.launches, "ms_per_step": ms,
             "images_per_s": big / ms * 1e3,
             "replay_device_ms": replay["replay_device_ms"],
             "allocated_before_bytes": before,
             "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
             "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
             "capture_seconds": graph.capture_seconds, "loss": loss.item()}
        if not math.isfinite(r["loss"]):
            fail(f"{what}: non-finite loss {r['loss']}")
        res["resnet18_step"]["remat_on" if remat else "remat_off"] = r
        print(f"{what} (one CUDA graph): launches {graph.launches}, "
              f"{ms:.2f} ms per step, {r['images_per_s']:.1f} images/s, "
              f"device {r['replay_device_ms']:.2f} ms per replay (profiler),"
              f" peak memory {r['peak_allocated_bytes'] / 2**30:.2f} GiB "
              f"allocated ({before / 2**30:.2f} before the step) / "
              f"{r['peak_reserved_bytes'] / 2**30:.2f} GiB reserved; "
              f"capture {graph.capture_seconds:.2f} s", flush=True)
        del compiled, graph, trees
    set_remat(m18, True)
    del x, t

    # one step at batch 32 against the plain path, bf16 and f32
    small = BATCH
    ref18 = nn.use_plain_ops(ResNet(1000, 18, fused=True, device=dev))
    load_jax_variables(ref18, v18)
    x = torch.rand((small, res18, res18, 3), generator=gen, device=dev)
    t = torch.randint(0, 1000, (small,), generator=gen, device=dev)
    res["resnet18_parity"] = {}
    for dt, tol, kw in (("bf16", TRAIN_BF16_TOL, {"compute_dtype": bf16}),
                        ("f32", TRAIN_F32_TOL, {})):
        xx = x.to(bf16) if dt == "bf16" else x
        (pk, sk, ok, lk), (_, sp, op_, lp) = (
            make_train_step(m, crit, sgd(), **kw)(
                *fresh(m), 1, None, xx, t, [0.1]) for m in (m18, ref18))
        vk, vp = ok["__all__"]["velocity"], op_["__all__"]["velocity"]
        if not (math.isfinite(lk.item()) and all(
                torch.isfinite(vk[k]).all() for k in vk)):
            fail(f"ResNet-18 {dt} step: non-finite loss or gradients")
        err = {"loss": abs(lk.item() - lp.item()) / abs(lp.item()),
               "grad": max(rel(vk[k], vp[k]) for k in vk),
               "state": max(rel(sk[k], sp[k]) for k in sk)}
        res["resnet18_parity"][dt] = err
        print(f"ResNet-18 step parity at batch {small}, {dt} (kernels vs "
              f"plain path): loss {lk.item():.6g} vs {lp.item():.6g}; rel "
              f"errors {err}", flush=True)
        over = {k: (err[k], lim) for k, lim in tol.items() if err[k] > lim}
        if over:
            fail(f"ResNet-18 {dt} step disagrees with the plain path: "
                 f"(error, limit) {over}")
    del ref18, step

    # -------------------------------------------- (d) the ResNet-34 step
    m34 = ResNet(1000, 34, fused=True, device=dev)
    load_jax_variables(m34, random_variables(export_variables(m34),
                                             args.seed + 34))
    step34 = make_train_step(m34, crit, sgd(), compute_dtype=bf16)
    xb, want = x.to(bf16), BASIC_LAUNCHES[("resnet34", True)]
    compiled, graph, trees = captured("ResNet-34 step", step34, fresh(m34),
                                      xb, t, want)
    check_graph("ResNet-34 step", graph, want,
                lambda: compiled(*trees, 2, None, xb, t, [0.1]))
    res["resnet34_step"] = {"launches_per_step": graph.launches,
                            "capture_seconds": graph.capture_seconds}
    print(f"ResNet-34 step at batch {small} (one CUDA graph): launches "
          f"{graph.launches}; capture {graph.capture_seconds:.2f} s",
          flush=True)
    del m34, step34, compiled, graph, trees, x, xb, t
    torch.cuda.empty_cache()

    # ------------------------------------------ (e) the user entry points
    opts, losses, events = [], [], []
    real_call = optmod.CompiledTrainStep.__call__
    real_build = optmod.LocalOptimizer._build_step_fn

    def call(self, *a):
        """The loop's step, recorded: its loss and an event after it."""
        out = real_call(self, *a)
        losses.append(out[3].detach().clone())
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    def build(self, model):
        opts.append(self)
        return real_build(self, model)

    def recipe(what, argv, key):
        opts.clear()
        losses.clear()
        events.clear()
        t0 = time.perf_counter()
        top = resnet_train.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        opt = opts[-1]
        step = opt.train_step
        (graph,) = step.graphs.values()
        vals = [v.item() for v in losses]
        ipe = len(events) // 2  # two epochs: epoch 2's steps, back to back
        ms = statistics.median(a.elapsed_time(b) for a, b in zip(
            events[ipe:], events[ipe + 1:]))
        r = {"seconds": secs, "result": top, "captures": step.captures,
             "replays": step.replays, "launches_per_step": graph.launches,
             "losses": vals, "ms_per_step": ms}
        print(f"{what}: {secs:.1f} s, {top}; {step.captures} capture, "
              f"{step.replays} replays, launches per step {graph.launches};"
              f" {ms:.2f} ms per step in epoch 2 (CUDA events); losses "
              f"{[round(v, 4) for v in vals]}", flush=True)
        if step.captures != 1 or graph.launches != BASIC_LAUNCHES[key] \
                or not vals or not all(math.isfinite(v) for v in vals) \
                or not math.isfinite(opt._loop_state["loss"]):
            fail(f"{what}: {step.captures} captures, launches per step "
                 f"{graph.launches} (expected {BASIC_LAUNCHES[key]}), "
                 f"losses {vals}")
        return r

    optmod.CompiledTrainStep.__call__ = call
    optmod.LocalOptimizer._build_step_fn = build
    try:
        res["recipe18"] = recipe(
            f"resnet_train.main({' '.join(BASIC_RECIPE_ARGV)})",
            BASIC_RECIPE_ARGV, ("resnet18", True))
        if set(res["recipe18"]["result"]) != {"Top1Accuracy",
                                              "Top5Accuracy"}:
            fail(f"resnet_train depth 18: result {res['recipe18']['result']}")
        rs = np.random.RandomState(args.seed + 20)
        shutil.rmtree(CIFAR_DIR, ignore_errors=True)
        CIFAR_DIR.mkdir(parents=True)
        n_train, n_test = CIFAR_RECORDS
        for name, k in [(f"data_batch_{i}", n_train) for i in range(1, 6)] \
                + [("test_batch", n_test)]:
            recs = np.concatenate([rs.randint(0, 10, (k, 1)),
                                   rs.randint(0, 256, (k, 3072))], axis=1)
            recs.astype(np.uint8).tofile(str(CIFAR_DIR / f"{name}.bin"))
        argv = CIFAR_ARGV + ["--folder", str(CIFAR_DIR)]
        try:
            res["cifar20"] = recipe(f"resnet_train.main({' '.join(argv)})",
                                    argv, ("cifar20", True))
        finally:
            shutil.rmtree(CIFAR_DIR, ignore_errors=True)
    finally:
        optmod.CompiledTrainStep.__call__ = real_call
        optmod.LocalOptimizer._build_step_fn = real_build
    torch.cuda.empty_cache()

    # ------------------------------------------ (f) the converters, eval
    unfused = ResNet(1000, 18, device=dev)
    vu = random_variables(export_variables(unfused), args.seed + 6)
    load_jax_variables(unfused, vu)
    load_jax_variables(m18, fuse_resnet_params(vu, 1000, 18))
    m18.eval()
    x = torch.rand((small, res18, res18, 3), generator=gen, device=dev)
    conv = {}
    with torch.inference_mode():
        for dt in ("bf16", "f32"):
            xx = x.to(bf16) if dt == "bf16" else x
            a, b = (m(xx).float() for m in (m18, unfused))
            scale = b.abs().max().item()
            conv[dt] = {"max_abs_err": (a - b).abs().max().item(),
                        "max_abs_logit": scale,
                        "argmax_equal": int((a.argmax(-1) == b.argmax(-1))
                                            .sum())}
    res["converted"] = conv
    print(f"fuse_resnet_params on the card: fused vs unfused ResNet-18 eval "
          f"at batch {small}: {conv}", flush=True)
    if conv["bf16"]["max_abs_err"] > SERVE_TOL * conv["bf16"]["max_abs_logit"] \
            or conv["f32"]["argmax_equal"] != small or \
            conv["f32"]["max_abs_err"] > 1e-3 * conv["f32"]["max_abs_logit"]:
        fail(f"the converted fused ResNet-18 disagrees with the unfused one: "
             f"{conv}")
    del m18, unfused, x

    # ------------------------------------------------- (g) the criteria
    rs = np.random.RandomState(args.seed + 21)
    worst, n_cases = 0.0, 0
    for name, crit_cpu, x, tgt in criterion_cases(nn, rs):
        crit_dev = copy.deepcopy(crit_cpu)
        for attr in ("input_transformer", "target_transformer"):
            if getattr(crit_dev, attr, None) is not None:
                getattr(crit_dev, attr).to(dev)
        want = crit_cpu.forward(x, tgt)
        want_g = graphs.leaves(crit_cpu.backward(x, tgt))
        xd, td = _to(x, dev), _to(tgt, dev)
        got = crit_dev.forward(xd, td)
        got_g = graphs.leaves(crit_dev.backward(xd, td))
        if got.device.type != torch.device(dev).type or \
                len(got_g) != len(want_g):
            fail(f"criterion {name}: result on {got.device}")
        for what, g, w in [("loss", got, want)] + [
                ("gradient", g, w) for g, w in zip(got_g, want_g)]:
            g, w = g.detach().cpu().float(), w.detach().float()
            d = (g - w).abs()
            lim = CRITERION_RTOL * (w.abs() + w.abs().max())
            if not torch.isfinite(g).all() or (d > lim).any():
                fail(f"criterion {name} {what}: the card gives max |d| "
                     f"{d.max().item():.3g} from the CPU's")
            worst = max(worst, (d / (w.abs().max() + 1e-30)).max().item())
        n_cases += 1
    res["criteria"] = {"cases": n_cases, "max_rel_err": worst}
    print(f"criteria on the card: {n_cases} cases, loss and input gradient "
          f"against the CPU within {CRITERION_RTOL} (max |d| / max |cpu| "
          f"{worst:.3g})", flush=True)

    res["seconds"] = time.perf_counter() - t_phase
    print(f"basic-block phase: {res['seconds']:.1f} s", flush=True)
    return res


# phase 13's tracing-overhead gate, measured as the JAX package's is
# (bench.py telemetry_ab, tests/test_telemetry.py: < 3%): one client
# submits a chunk of 32 requests and waits, the tracer flipped per chunk,
# Python's cyclic collector off (a collection that the spans' allocations
# trigger would land on the traced chunks by construction), the median
# request latency of each state
TELEMETRY_CHUNKS = 128
TELEMETRY_OVERHEAD = 0.03
# then saturated rounds of 1024 requests from 4 clients, the tracer on
# and off in turns after a warm-up round of each: images/s and p50/p99
# of each state (a round spreads by +-15% on an H100's host)
TELEMETRY_REQUESTS = 1024
TELEMETRY_ROUNDS = 8
TELEMETRY_RES = 224       # the served and trained images' side


def telemetry_phase(args, card, out, dev="cuda"):
    """Phase 13, the telemetry plane (``bigdl_tpu_torch.telemetry``):
    the fused ResNet-50 served in bf16 by two engines, one built with the
    tracer off and one with it on: each capture launches kernels 1 and 4
    36 and 13 times either way, the outputs of one batch are bit-equal,
    each bucket's cost stamp is its batch x the batch-1 stamp; then the
    second engine gives the overhead of tracing as the JAX package's gate
    measures it (``TELEMETRY_CHUNKS`` chunks, held to
    ``TELEMETRY_OVERHEAD``) and serves ``TELEMETRY_ROUNDS`` saturated
    rounds of ``TELEMETRY_REQUESTS`` requests with the tracer off and as
    many with it on, in turns, for images/s, p50/p99 and the log lines
    with GF/s and MFU; the Chrome trace written
    under ``out`` and parsed back has the dispatcher's and the drain's
    tracks, and every request's attribution sums to its latency; the
    bare forward's MFU (the batch-32 stamp over a replay); the HBM
    ledger samples the card (source "device"); the compiled train step
    (batch 32, bf16) gives the same launches and bit-equal losses and
    trees with the tracer on and off, and its MFU at batch 256; a decode
    engine forced onto an undeclared prompt bucket has the changed axis
    named by the registry's forensics and counted by the watchdog.
    ``dev="cpu"`` serves a rehearsal with the sizes shrunk and the CUDA
    calls patched.  Returns the results."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn, telemetry
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.optim import SGD, CompiledTrainStep, make_train_step
    from bigdl_tpu_torch.serving import (DecodeEngine, ServingEngine,
                                         ServingMetrics)
    from bigdl_tpu_torch.telemetry import costmodel
    from bigdl_tpu_torch.utils import (export_variables, graphs,
                                       load_jax_variables, random_variables)

    t_phase = time.perf_counter()
    print(f"telemetry phase on {card}", flush=True)
    tracer = telemetry.get_tracer()
    registry = telemetry.get_program_registry()
    peak = costmodel.peak_flops_per_device(dev)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    rs = np.random.RandomState(args.seed + 13)
    res = {"peak_flops": peak}

    # ---------------------------------- (a) serving, tracer off and on
    model = ResNet50(1000, stem="space_to_depth", fused=True, device=dev)
    load_jax_variables(model, random_variables(export_variables(model),
                                               args.seed))
    dims = (TELEMETRY_RES, TELEMETRY_RES, 3)
    engines = {}
    for on in (False, True):
        tracer.enabled = on
        tracer.clear()
        engines[on] = ServingEngine(model, buckets=[dims],
                                    batch_sizes=SERVE_BATCHES,
                                    input_dtype=bf16, device=dev)
        if dev == "cuda":
            for key, g in engines[on]._compiled.items():
                if g.launches != FUSED_FWD:
                    fail(f"tracer {'on' if on else 'off'}: bucket {key} "
                         f"captured {g.launches}, expected {FUSED_FWD}")
    costs = {on: {b: e._bucket_costs[(b, dims)].flops
                  for b in SERVE_BATCHES} for on, e in engines.items()}
    per_image = costs[False][1]
    if costs[True] != costs[False] or any(
            costs[False][b] != b * per_image for b in SERVE_BATCHES):
        fail(f"bucket cost stamps {costs}: not batch x {per_image}")
    images = rs.randn(TELEMETRY_REQUESTS, *dims).astype(np.float32)
    outs = {on: e.predict_batch(images[:SERVE_BATCHES[-1]])
            for on, e in engines.items()}
    if not np.array_equal(outs[False], outs[True]):
        fail("served outputs differ with the tracer on and off")
    b32 = engines[False]._compiled[(SERVE_BATCHES[-1], dims)]
    fwd_ms = replay_ms(b32.graph) if dev == "cuda" else float("nan")
    engines[False].close()
    engine = engines[True]
    tracer.enabled = True
    tracer.clear()  # the trace holds the rounds served with it on
    # every attribution the engine closes, held to its latency as it
    # closes (kept, 17k of them would slow the collector's full passes)
    closed, close_many = {"n": 0, "worst": 0.0}, engine.xray.close_many

    def close_and_check(*args, **kwargs):
        atts = close_many(*args, **kwargs)
        for att in atts:
            if att is not None:
                closed["n"] += 1
                closed["worst"] = max(closed["worst"], abs(
                    sum(att.phases.values()) - att.latency))
        return atts

    engine.xray.close_many = close_and_check
    metrics = {on: ServingMetrics() for on in (False, True)}

    def serve_chunk(latencies):
        """One client's chunk of a batch of requests, each request's
        latency to its done callback (bench.py serve_one_chunk)."""
        pending = []
        for j in range(SERVE_BATCHES[-1]):
            slot = [time.perf_counter(), None, threading.Event()]

            def stamp(f, s=slot):
                s[1] = time.perf_counter()
                s[2].set()

            fut = engine.submit(images[j])
            fut.add_done_callback(stamp)
            pending.append((fut, slot))
        for fut, slot in pending:
            fut.result(300)
            # the callback runs just after the result is set: wait for it
            if not slot[2].wait(300):
                fail("a served request's done callback never ran")
            latencies.append(slot[1] - slot[0])

    tracer.enabled = False
    serve_chunk([])
    lats = {False: [], True: []}
    gc_was = gc.isenabled()
    gc.disable()
    try:
        for i in range(TELEMETRY_CHUNKS):
            tracer.enabled = i % 2 == 1
            engine.metrics = metrics[tracer.enabled]
            serve_chunk(lats[tracer.enabled])
    finally:
        tracer.enabled = False
        if gc_was:
            gc.enable()
    med_lat = {on: statistics.median(v) for on, v in lats.items()}
    overhead = med_lat[True] / med_lat[False] - 1.0
    res["overhead"] = {"value": overhead,
                       "median_latency_ms": {"off": 1e3 * med_lat[False],
                                             "on": 1e3 * med_lat[True]},
                       "chunks": TELEMETRY_CHUNKS}
    print(f"telemetry: tracing overhead {100 * overhead:.2f}% of the median "
          f"request latency ({1e3 * med_lat[False]:.3f} ms off, "
          f"{1e3 * med_lat[True]:.3f} ms on; {TELEMETRY_CHUNKS} chunks of "
          f"{SERVE_BATCHES[-1]} requests from one client, the tracer "
          f"flipped per chunk, the collector off, as the JAX package's "
          f"gate; limit {100 * TELEMETRY_OVERHEAD:.0f}%); {card}",
          flush=True)
    if overhead > TELEMETRY_OVERHEAD:
        fail(f"tracing costs {100 * overhead:.2f}% of the request latency")

    def serve_round(on):
        """One round's images/s with the tracer ``on`` (or off), into
        that state's own metrics."""
        tracer.enabled = on
        engine.metrics = metrics[on]
        return TELEMETRY_REQUESTS / serve_images(engine, images)[1]

    warm = {on: serve_round(on) for on in (True, False)}
    ips = {False: [], True: []}
    for r in range(TELEMETRY_ROUNDS):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            ips[on].append(serve_round(on))
    tracer.enabled = False
    ratios = [a / b for a, b in zip(ips[True], ips[False])]
    serve = {"images_per_s_on_off_median_ratio": statistics.median(ratios)}
    for on, m in metrics.items():
        med = statistics.median(ips[on])
        # while serving, from the rounds' own rate: the log line's MFU
        # also counts the time since the metrics started that the
        # engine spent on the other state's rounds
        round_mfu = med * per_image / peak
        serve["on" if on else "off"] = {
            "images_per_s": ips[on], "median_images_per_s": med,
            "warm_up_images_per_s": warm[on], "round_mfu": round_mfu,
            "p50_ms": m.latency_ms(50), "p99_ms": m.latency_ms(99),
            "gflops_per_sec": m.gflops_per_sec(), "mfu": m.mfu(),
            "log_line": m.log_line()}
        print(f"telemetry: serve, tracer {'on' if on else 'off'}: median "
              f"{med:.1f} images/s over {TELEMETRY_ROUNDS} rounds of "
              f"{TELEMETRY_REQUESTS} ({[round(v, 1) for v in ips[on]]}; "
              f"warm-up round {warm[on]:.1f}), MFU {100 * round_mfu:.2f}% "
              f"while serving, p50 {m.latency_ms(50):.2f} ms, p99 "
              f"{m.latency_ms(99):.2f} ms; {card}", flush=True)
        print(f"telemetry: {m.log_line()}", flush=True)
    res["serve"] = serve
    print(f"telemetry: saturated, traced / untraced images/s "
          f"{serve['images_per_s_on_off_median_ratio']:.4f} (the median "
          f"ratio of {TELEMETRY_ROUNDS} adjacent rounds)", flush=True)

    # (b) the Chrome trace, parsed back, and the attributions
    path = telemetry.write_chrome_trace(str(out / "telemetry_trace.json"))
    blob = json.loads(Path(path).read_text())
    tracks = {e["args"]["name"] for e in blob["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    if not {"bigdl-serve-dispatch", "bigdl-serve-drain"} <= tracks:
        fail(f"the trace's tracks {sorted(tracks)} lack the dispatcher's "
             "or the drain's")
    xray = engine.xray
    n_att, worst = closed["n"], closed["worst"]
    traced = (TELEMETRY_ROUNDS + 1) * TELEMETRY_REQUESTS \
        + TELEMETRY_CHUNKS // 2 * SERVE_BATCHES[-1]
    if n_att != traced or worst > 1e-6:
        fail(f"{n_att} attributions, largest |phases - latency| "
             f"{worst:.3g} s")
    res["trace"] = {"events": len(blob["traceEvents"]),
                    "tracks": sorted(tracks), "attributions": n_att,
                    "max_sum_err_s": worst, "xray": xray.summary()}
    print(f"telemetry: trace {path}: {len(blob['traceEvents'])} events on "
          f"{len(tracks)} tracks {sorted(tracks)}; {n_att} attributions, "
          f"largest |sum of phases - latency| {worst:.3g} s; "
          f"{xray.log_line()}", flush=True)

    # (c) the bare forward's MFU and the HBM ledger
    res["forward"] = {"batch": SERVE_BATCHES[-1],
                      "flops": costs[False][SERVE_BATCHES[-1]],
                      "gflop_per_image": per_image / 1e9, "ms": fwd_ms,
                      "mfu": costs[False][SERVE_BATCHES[-1]]
                      / (fwd_ms / 1e3) / peak}
    sample = telemetry.get_hbm_ledger().sample()
    res["hbm"] = sample
    print(f"telemetry: forward at batch {SERVE_BATCHES[-1]}: "
          f"{per_image / 1e9:.4f} GFLOP an image, replay {fwd_ms:.3f} ms, "
          f"MFU {100 * res['forward']['mfu']:.2f}%; HBM ledger: "
          f"{sample and sample['source']} {sample and sample['bytes_in_use']}"
          f" of {sample and sample['bytes_limit']} bytes, top "
          f"{sample and [t['program'] for t in sample['top']]}; {card}",
          flush=True)
    if dev == "cuda" and (sample is None or sample["source"] != "device"):
        fail(f"the HBM ledger did not sample the card: {sample}")
    engine.close()
    del engines, engine, b32
    torch.cuda.empty_cache()

    # ------------------ (d) the train step, tracer off and on, and MFU
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    crit = nn.ClassNLLCriterion(logits=True)
    step = make_train_step(model, crit, {"__all__": SGD(0.1, momentum=0.9)},
                           compute_dtype=bf16)

    def fresh():
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = {k: b.detach().clone() for k, b in model.named_buffers()}
        return params, state, {"__all__": SGD(0.1, momentum=0.9)
                               .init_state(params)}

    x = torch.rand((BATCH,) + dims, generator=gen, device=dev).to(bf16)
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    runs = {}
    for on in (False, True):
        tracer.enabled = on
        compiled = CompiledTrainStep(step)
        trees, losses = fresh(), []
        for i in range(2):
            *trees, loss = compiled(*trees, i + 1, None, x, t, [0.1])
            losses.append(loss.item())
        runs[on] = (losses, graphs.leaves(trees),
                    next(iter(compiled.graphs.values())), compiled.cost)
    tracer.enabled = False
    torch.backends.cudnn.deterministic = deterministic
    (l0, t0_, g0, c0), (l1, t1_, g1, c1) = runs[False], runs[True]
    differ = sum(not torch.equal(a, b) for a, b in zip(t0_, t1_))
    if dev == "cuda" and (g0.launches != g1.launches
                          or g0.launches != STEP_LAUNCHES[True]):
        fail(f"train step launches {g0.launches} (tracer off), "
             f"{g1.launches} (on); expected {STEP_LAUNCHES[True]}")
    if l0 != l1 or differ or c0.flops != c1.flops:
        fail(f"train step with the tracer on and off: losses {l0} vs {l1}, "
             f"{differ} tree leaves differ, stamps {c0.flops} vs {c1.flops}")
    # forward, remat recompute and a backward of twice the forward's
    # operations (less the input's gradient): a count that missed the
    # backward (run on autograd's device thread) would read near 2
    if not 3.5 < c0.flops / BATCH / per_image < 4.5:
        fail(f"train step stamp {c0.flops} is {c0.flops / BATCH / per_image:.3f}"
             f" x the forward's {per_image} an image, not about 4")
    print(f"telemetry: train step at batch {BATCH}, tracer off and on: "
          f"losses {l0} bit-equal, {len(t0_)} leaves bit-equal, launches "
          f"{getattr(g0, 'launches', None)}; stamp {c0.flops / 1e9:.3f} "
          f"GFLOP ({c0.flops / BATCH / per_image:.3f} x the forward an "
          f"image)", flush=True)
    del runs, g0, g1
    xb = torch.rand((TRAIN_BATCH,) + dims, generator=gen,
                    device=dev).to(bf16)
    tb = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    compiled = CompiledTrainStep(step)
    r = step_ms(compiled, fresh(), 1, lambda i: None, xb, tb, [0.1])
    r["flops"] = compiled.cost.flops
    r["mfu"] = compiled.cost.flops / (r["ms_per_step"] / 1e3) / peak
    r["bytes_per_s"] = compiled.cost.bytes_per_s(r["ms_per_step"] / 1e3)
    res["train"] = {"batch32_flops": c0.flops, "batch256": r}
    print(f"telemetry: train step at batch {TRAIN_BATCH}: "
          f"{r['ms_per_step']:.2f} ms, {r['flops'] / 1e12:.4f} TFLOP "
          f"counted, MFU {100 * r['mfu']:.2f}%, "
          f"{r['bytes_per_s'] / 1e9:.1f} GB/s counted; {card}", flush=True)
    del compiled, xb, tb, step, model
    torch.cuda.empty_cache()

    # ------------- (e) a decode engine forced onto an undeclared bucket
    lm = nn.Transformer(**{**LM, "num_layers": 1}, dropout=0.0).to(dev)
    load_jax_variables(lm, lm_variables(lm, args.seed))
    registry.clear()
    tracer.enabled = True  # the forensic instant and the spans it pairs
    eng = DecodeEngine(lm, slots=2, max_len=64, prompt_buckets=(8, 16),
                       prefill_batch_sizes=(1, 2), device=dev)
    try:
        with telemetry.Watchdog(log=None).attach() as wd:
            prompt = rs.randint(0, LM["vocab_size"], (24,))
            eng.generate(prompt, 4, timeout=300)
        forensics = registry.forensic_records()
    finally:
        eng.close(timeout=300)
        tracer.enabled = False
    want = "arg `ids` dim 1 — 16 → 24, dtype unchanged"
    if [f["cause"] for f in forensics if f["program"] == "decode_prefill"] \
            != [want] or wd.counters["steady_state_recompiles"] != 2 \
            or want not in wd.anomalies[0]["message"]:
        fail(f"decode forensics {forensics}, watchdog {wd.counters} "
             f"{[a['message'] for a in wd.anomalies]}")
    res["decode_forensic"] = {"forensics": forensics,
                              "watchdog": wd.report()}
    print(f"telemetry: decode engine on an undeclared prompt of 24: "
          f"{wd.anomalies[0]['message']!r}; watchdog {wd.log_line()}",
          flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"telemetry phase: {res['seconds']:.1f} s", flush=True)
    return res


# phase 14, the rest of the telemetry plane: numerics in the step, the
# seeded divergence, the live plane, the profiling tools and the cluster
# merge.  (a) times stats on against off as bench.py numerics_ab does:
# two compiled steps from one model, bursts of OBS_BURST steps in turns,
# the stats never fetched, the median of each arm's per-step times (the
# first of each burst dropped), held to JAX's 3% (tests/test_numerics.py)
OBS_RES = 224
OBS_TRAIN_BATCH = 256
OBS_BIT_STEPS = 3         # steps held bit-equal, stats off and on
OBS_BURSTS = 6
OBS_BURST = 10
OBS_OVERHEAD = 0.03
NUMERICS_RTOL = 1e-5      # drained stats against the eager step's
OBS_DIV_BATCH = 32        # (b): 4 batches an epoch, a checkpoint each
OBS_DIV_AT = 6            # the batch whose images turn NaN at the trap
OBS_SERVE_REQUESTS = 256  # (c)
OBS_PROFILE_ITERS = 2     # (d): optimize() iterations under the profiler


def _numpy_tree(tree):
    """A tree of tensors copied to host numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _stats_err(a, b):
    """Largest relative difference of two numerics trees' norms and
    histograms, and whether their non-finite counts agree."""
    import numpy as np

    worst, counts = 0.0, True

    def rel(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.size == 0:
            return 0.0
        return float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30)))

    for k in ("grad_norm", "param_norm", "update_norm"):
        worst = max(worst, rel(a[k], b[k]))
    counts &= int(a["nonfinite"]) == int(b["nonfinite"])
    if list(a["layers"]) != list(b["layers"]):
        return float("inf"), False
    for name, la in a["layers"].items():
        lb = b["layers"][name]
        for k in ("g", "p", "u"):
            worst = max(worst, rel(la[k], lb[k]))
        worst = max(worst, rel(la["hist"], lb["hist"]))
        counts &= int(la["nf"]) == int(lb["nf"])
    return worst, counts


def device_kernel_count(fn):
    """The CUDA kernels and the copies and sets one call of ``fn`` runs on
    the card (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if evt.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
    return kernels, copies


def observability_phase(args, card, out, dev="cuda"):
    """Phase 14, the rest of the telemetry plane
    (``bigdl_tpu_torch.telemetry`` numerics, flight recorder, debug
    server, cluster, and ``utils/profiling.py``): (a) the compiled fused
    ResNet-50 step (bf16, batch ``OBS_TRAIN_BATCH``) with numerics off
    and on: one capture each, kernels 1-5 72/36/36/26/13 a step in both,
    every kernel of a replay counted by the profiler, the trees after
    ``OBS_BIT_STEPS`` steps bit-equal, the drained stats of a replay
    against the same step run eagerly on the same trees and the layers'
    parameter and update norms against a plain per-leaf recomputation
    (``NUMERICS_RTOL``), and the stats' overhead timed as bench.py
    numerics_ab times it, held to ``OBS_OVERHEAD``; (b) a trap layer
    before the ResNet-50 turns one batch NaN in ``Optimizer.optimize()``
    with numerics on and a checkpoint each epoch: the watchdog counts the
    ``numerics_anomaly`` (kind nonfinite) before the ``loss_divergence``,
    ``nan_provenance`` names the trap with site forward, the recovery
    books the rewind, the step stays one capture, and the flight bundle
    holds JAX's seven files (the provenance's seconds and a dump's
    seconds and bytes printed); (c) the served ResNet-50 with
    ``BIGDL_TPU_DEBUG_PORT=0``: ``/metricsz`` parses and agrees with the
    engine's ``ServingMetrics``, with HBM gauges from the card,
    ``/tracez`` loads, ``/xrayz`` lists the buckets and ``/flightz``
    dumps; (d) ``profiling.trace`` around a batch-32 forward and
    ``optimize()``: the device trace names kernels 1-5, ``host_trace.json``
    holds the loop's spans, and ``get_times`` prints the per-layer table;
    (e) the served and the trained parts shipped as two hosts and merged
    by ``ClusterAggregator`` into two lanes.  ``dev="cpu"`` serves a
    rehearsal with the sizes shrunk and the CUDA calls patched.  Returns
    the results."""
    import contextlib
    import io
    import urllib.request

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn, telemetry
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.minibatch import MiniBatch
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.ops import fused_matmul as fm
    from bigdl_tpu_torch.optim import (SGD, CompiledTrainStep, Optimizer,
                                       Trigger, make_train_step)
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.telemetry import (cluster, debug_server,
                                           flightrecorder, numerics)
    from bigdl_tpu_torch.tools import blackbox, cluster_top
    from bigdl_tpu_torch.utils import (export_variables, graphs,
                                       load_jax_variables, profiling,
                                       random_variables)

    t_phase = time.perf_counter()
    print(f"observability phase on {card}", flush=True)
    tracer = telemetry.get_tracer()
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 14)
    rs = np.random.RandomState(args.seed + 14)
    run_dir = out / "cluster_phase"
    flight_dir = out / "flight_phase"
    scratch = ROOT / "build" / "obs_phase"
    for d in (run_dir, flight_dir, scratch):
        shutil.rmtree(d, ignore_errors=True)
    knobs = {"BIGDL_TPU_FLIGHT": "1", "BIGDL_TPU_FLIGHT_DIR": str(flight_dir),
             "BIGDL_TPU_FLIGHT_MIN_INTERVAL_S": "0",
             "BIGDL_TPU_DEBUG_PORT": "0"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    flightrecorder.set_global(None)
    debug_server.set_global(None)
    res = {}
    dims = (OBS_RES, OBS_RES, 3)

    model = ResNet50(1000, stem="space_to_depth", fused=True, device=dev)
    load_jax_variables(model, random_variables(export_variables(model),
                                               args.seed))
    crit = nn.ClassNLLCriterion(logits=True)
    spec = numerics.spec_for(model)

    def fresh():
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = {k: b.detach().clone() for k, b in model.named_buffers()}
        return params, state, {"__all__": SGD(0.1, momentum=0.9)
                               .init_state(params)}

    def step_fn(on):
        return make_train_step(model, crit, {"__all__": SGD(0.1, momentum=0.9)},
                               compute_dtype=bf16,
                               numerics=spec if on else None)

    # --------------------------------------- (a) numerics in the step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    xb = torch.rand((OBS_TRAIN_BATCH,) + dims, generator=gen,
                    device=dev).to(bf16)
    tb = torch.randint(0, 1000, (OBS_TRAIN_BATCH,), generator=gen,
                       device=dev)
    lrs = [0.1]
    arms = {on: {"step": CompiledTrainStep(step_fn(on)), "trees": fresh()}
            for on in (False, True)}
    on_arm = arms[True]
    before = graphs.clone(on_arm["trees"])
    *trees, _, stats = on_arm["step"](*on_arm["trees"], 1, None, xb, tb, lrs)
    drained = _numpy_tree(stats)  # before the next replay overwrites it
    eager = step_fn(True)(*before, 1, None, xb, tb, lrs)
    eager_err, eager_counts = _stats_err(drained, _numpy_tree(eager[4]))
    # each layer's parameter and update norms, leaf by leaf, in f64
    plain_err = 0.0
    for name, names in numerics._layer_groups(before[0], spec.layers):
        p = sum(float(torch.linalg.vector_norm(before[0][n].double())) ** 2
                for n in names) ** 0.5
        u = sum(float(torch.linalg.vector_norm(
            (trees[0][n] - before[0][n]).double())) ** 2
            for n in names) ** 0.5
        for got, want in ((drained["layers"][name]["p"], p),
                          (drained["layers"][name]["u"], u)):
            plain_err = max(plain_err, abs(float(got) - want)
                            / max(abs(want), 1e-30))
    del eager, before
    if dev == "cuda":
        torch.cuda.empty_cache()
    if not eager_counts or eager_err > NUMERICS_RTOL \
            or plain_err > NUMERICS_RTOL:
        fail(f"drained stats against the eager step: largest relative "
             f"difference {eager_err:.3g} (counts equal: {eager_counts}), "
             f"against the plain per-leaf norms {plain_err:.3g}; limit "
             f"{NUMERICS_RTOL}")
    print(f"observability: numerics of a replayed batch-{OBS_TRAIN_BATCH} "
          f"step against the same step eager: largest relative difference "
          f"{eager_err:.3g}, non-finite counts equal; the layers' parameter "
          f"and update norms against a per-leaf f64 recomputation "
          f"{plain_err:.3g} ({len(drained['layers'])} layers, grad norm "
          f"{float(drained['grad_norm']):.4g}, {int(drained['nonfinite'])} "
          f"non-finite)", flush=True)
    for i in range(2, OBS_BIT_STEPS + 1):
        on_arm["step"](*on_arm["trees"], i, None, xb, tb, lrs)
    off_arm = arms[False]
    for i in range(1, OBS_BIT_STEPS + 1):
        off_arm["step"](*off_arm["trees"], i, None, xb, tb, lrs)
    differ = sum(not torch.equal(a, b) for a, b in zip(
        graphs.leaves(on_arm["trees"]), graphs.leaves(off_arm["trees"])))
    if differ:
        fail(f"numerics on and off: {differ} tree leaves differ after "
             f"{OBS_BIT_STEPS} steps")
    res["numerics"] = {"eager_max_rel": eager_err,
                       "plain_norms_max_rel": plain_err,
                       "layers": len(drained["layers"]),
                       "bit_equal_steps": OBS_BIT_STEPS}
    if dev == "cuda":
        counts = {}
        for on, arm in arms.items():
            (g,) = arm["step"].graphs.values()
            if arm["step"].captures != 1 or g.launches != STEP_LAUNCHES[True]:
                fail(f"numerics {'on' if on else 'off'}: "
                     f"{arm['step'].captures} captures launching "
                     f"{g.launches}, expected one with "
                     f"{STEP_LAUNCHES[True]}")
            got, _ = replay_kernels(lambda: arm["step"](
                *arm["trees"], 100, None, xb, tb, lrs))
            if got != STEP_LAUNCHES[True]:
                fail(f"numerics {'on' if on else 'off'}: a replay runs "
                     f"{got} (profiler)")
            counts[on] = device_kernel_count(lambda: arm["step"](
                *arm["trees"], 101, None, xb, tb, lrs))
        res["numerics"]["launches_per_step"] = dict(g.launches)
        res["numerics"]["graph_kernels"] = {"off": counts[False],
                                            "on": counts[True]}
        print(f"observability: one capture each, kernels 1-5 "
              f"{STEP_LAUNCHES[True]} a step stats off and on; a replay "
              f"runs {counts[False][0]} kernels and {counts[False][1]} "
              f"copies/sets off, {counts[True][0]} and {counts[True][1]} on "
              f"(+{counts[True][0] - counts[False][0]} kernels for the "
              f"stats); trees bit-equal after {OBS_BIT_STEPS} steps",
              flush=True)
        times = {False: [], True: []}
        base = 200
        for _ in range(OBS_BURSTS):
            for on in (False, True):
                arm = arms[on]
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(OBS_BURST + 1)]
                ev[0].record()
                for i in range(OBS_BURST):
                    arm["step"](*arm["trees"], base + i, None, xb, tb, lrs)
                    ev[i + 1].record()
                ev[-1].synchronize()
                times[on] += [ev[i].elapsed_time(ev[i + 1])
                              for i in range(1, OBS_BURST)]
                base += OBS_BURST
        med = {on: statistics.median(t) for on, t in times.items()}
        overhead = med[True] / med[False] - 1.0
        res["numerics"]["timing"] = {
            "ms_per_step_off": med[False], "ms_per_step_on": med[True],
            "overhead": overhead, "steps_per_arm": len(times[True])}
        print(f"observability: step at batch {OBS_TRAIN_BATCH}, median of "
              f"{len(times[True])} steps a state (bursts of {OBS_BURST} in "
              f"turns, CUDA events): {med[False]:.3f} ms stats off, "
              f"{med[True]:.3f} ms on, overhead {100 * overhead:.2f}% "
              f"(limit {100 * OBS_OVERHEAD:.0f}%); {card}", flush=True)
        if overhead > OBS_OVERHEAD:
            fail(f"numerics cost {100 * overhead:.2f}% of the step")
    torch.backends.cudnn.deterministic = deterministic
    del arms, on_arm, off_arm, trees, stats, xb, tb
    if dev == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------ (b) a seeded divergence
    class Trap(nn.Module):
        """Pass-through that goes NaN where |x| > limit."""

        def __init__(self, limit=1e6):
            super().__init__()
            self.limit = limit

        def forward(self, x):
            return torch.where(x.abs() > self.limit,
                               torch.full_like(x, float("nan")), x)

    class SentinelOnce:
        """The ``at``-th training batch pulled gets a large finite
        value in every feature."""

        def __init__(self, base, at, value=1e8):
            self.base, self.at, self.value, self.count = base, at, value, 0

        def batches_per_epoch(self):
            return self.base.batches_per_epoch()

        def data(self, train):
            for b in self.base.data(train):
                if train:
                    self.count += 1
                    if self.count == self.at:
                        b = MiniBatch(np.full_like(b.get_input(),
                                                   self.value),
                                      b.get_target())
                yield b

    feats = rs.rand(4 * OBS_DIV_BATCH, *dims).astype(np.float32)
    labels = rs.randint(0, 1000, 4 * OBS_DIV_BATCH)
    trapped = nn.Sequential(Trap(), model)
    tracer.enable()
    tracer.clear()
    wd = telemetry.Watchdog(log=None).attach()
    flight = flightrecorder.get_flight_recorder()
    flight.set_watchdog(wd)
    ckdir = scratch / "ckpt"
    opt = (Optimizer.apply(trapped, SentinelOnce(DataSet.from_arrays(
        feats, labels, batch_size=OBS_DIV_BATCH), OBS_DIV_AT),
        crit, end_trigger=Trigger.max_epoch(3), device=dev)
        .set_optim_method(SGD(0.1, momentum=0.9))
        .set_compute_dtype(bf16)
        .set_checkpoint(str(ckdir), Trigger.every_epoch())
        .set_numerics(True))
    prov_s = []
    diagnose = opt._maybe_diagnose_divergence

    def timed_diagnosis(*a, **kw):
        t0 = time.perf_counter()
        diagnose(*a, **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
        prov_s.append(time.perf_counter() - t0)

    opt._maybe_diagnose_divergence = timed_diagnosis
    fm.reset_launches()
    t0 = time.perf_counter()
    opt.optimize()
    div_s = time.perf_counter() - t0
    div_launches = dict(fm.LAUNCHES)
    wd.close()
    spans = tracer.spans()
    names = [s.name for s in spans]
    prov = [s.args for s in spans if s.name == "nan_provenance"]
    rec = [s.args for s in spans if s.name == "divergence_recovery"]
    first = next((s.args for s in spans if s.name == "numerics_anomaly"), {})
    early = ("numerics_anomaly" in names and "loss_divergence" in names
             and names.index("numerics_anomaly")
             < names.index("loss_divergence"))
    if not early or first.get("kind") != "nonfinite":
        fail(f"seeded divergence: numerics_anomaly {first} is not a "
             f"nonfinite warning before the loss_divergence")
    if len(prov) != 1 or (prov[0]["layer"], prov[0]["site"],
                          prov[0]["iteration"]) != ("0", "forward",
                                                    OBS_DIV_AT):
        fail(f"seeded divergence: provenance {prov}")
    if len(rec) != 1 or rec[0]["iteration"] != OBS_DIV_AT \
            or rec[0]["restored_iteration"] != 4 or opt._retries != 1:
        fail(f"seeded divergence: recovery {rec}, retries {opt._retries}")
    captures = opt.train_step.captures if dev == "cuda" else 1
    if captures != 1 or not math.isfinite(opt._loop_state["loss"]):
        fail(f"seeded divergence: {captures} captures, final loss "
             f"{opt._loop_state['loss']}")
    if wd.counters["nonfinite_grads"] < 1 or wd.counters["nan_windows"] < 1:
        fail(f"seeded divergence: watchdog {wd.counters}")
    manifests = {b: json.loads((Path(b) / "manifest.json").read_text())
                 for b in flight.bundles()}
    bundle = next((b for b, m in manifests.items()
                   if m["trigger"] == "loss_divergence"), None)
    seven = {"trace.json", "metrics.jsonl", "xray.json", "watchdog.json",
             "numerics.json", "threads.txt", "manifest.json"}
    if bundle is None or set(os.listdir(bundle)) != seven:
        fail(f"seeded divergence: bundles "
             f"{ {b: m['trigger'] for b, m in manifests.items()} }")
    t0 = time.perf_counter()
    dumped = flight.dump(trigger="flightz", note="timed", force=True)
    dump_s = time.perf_counter() - t0
    dump_bytes = sum(f.stat().st_size for f in Path(dumped).iterdir())
    summary = blackbox.summarize(blackbox.load_bundle(bundle))
    if dev == "cuda" and any(div_launches.get(k, 0) == 0
                             for k in STEP_LAUNCHES[True]):
        fail(f"seeded divergence: launches {div_launches}")
    res["divergence"] = {
        "seconds": div_s, "provenance_s": prov_s[0],
        "provenance": prov[0], "recovery": rec[0],
        "watchdog": dict(wd.counters), "launches": div_launches,
        "bundle_files": sorted(os.listdir(bundle)),
        "bundle_bytes": sum(f.stat().st_size for f in Path(bundle).iterdir()),
        "dump_s": dump_s, "dump_bytes": dump_bytes,
        "blackbox_trigger": summary["trigger"]}
    print(f"observability: seeded divergence at iteration {OBS_DIV_AT} "
          f"(batch {OBS_DIV_BATCH}, fused ResNet-50 behind a trap): "
          f"numerics_anomaly {first.get('kind')} before the loss_divergence;"
          f" nan_provenance layer {prov[0]['layer']!r} site "
          f"{prov[0]['site']!r} in {prov_s[0]:.3f} s; recovery from "
          f"iteration {rec[0]['restored_iteration']} (detected at "
          f"{rec[0]['detected_at']}); {captures} capture; watchdog "
          f"{wd.log_line()}; bundle of {len(seven)} files, "
          f"{res['divergence']['bundle_bytes']} bytes; a forced dump "
          f"{dump_s:.3f} s, {dump_bytes} bytes; launches {div_launches}; "
          f"{div_s:.1f} s; {card}", flush=True)
    del opt, trapped
    shutil.rmtree(ckdir, ignore_errors=True)
    if dev == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------- (c) the live plane
    tracer.clear()
    serve_ship = cluster.TelemetryShipper(str(run_dir), "serve",
                                          interval_s=0)
    engine = ServingEngine(model, buckets=[dims], batch_sizes=SERVE_BATCHES,
                           input_dtype=bf16, device=dev)
    serve_ship.add_metrics("serve", lambda: engine.metrics)
    srv = debug_server.get_debug_server()
    try:
        images = rs.randn(OBS_SERVE_REQUESTS, *dims).astype(np.float32)
        serve_images(engine, images)
        hbm = telemetry.get_hbm_ledger().sample()

        def get(path):
            with urllib.request.urlopen(srv.local_url(path),
                                        timeout=60) as r:
                return r.read().decode()

        text = get("/metricsz")
        prom = cluster_top.parse_prometheus(text)
        m = engine.metrics
        snap = {dict(lbl)["key"]: v for (n, lbl), v in prom.items()
                if n == "bigdl_tpu_snapshot" and dict(lbl)["source"]
                == "serve"}
        hist_n = prom.get(("bigdl_tpu_request_latency_seconds_count",
                           (("source", "serve"),)))
        hbm_use = cluster_top._prom_pick(prom, "bigdl_tpu_hbm_bytes",
                                         kind="in_use")
        hbm_limit = cluster_top._prom_pick(prom, "bigdl_tpu_hbm_bytes",
                                           kind="limit")
        want_limit = (torch.cuda.get_device_properties(0).total_memory
                      if dev == "cuda" else None)
        if snap.get("completed") != m.completed \
                or m.completed != OBS_SERVE_REQUESTS \
                or hist_n != OBS_SERVE_REQUESTS \
                or snap.get("recompiles") != m.recompiles:
            fail(f"/metricsz: completed {snap.get('completed')}, histogram "
                 f"count {hist_n}, recompiles {snap.get('recompiles')}; "
                 f"the engine's {m.completed}, {m.recompiles}")
        if dev == "cuda" and (hbm is None or hbm["source"] != "device"
                              or not hbm_use or hbm_limit != want_limit):
            fail(f"/metricsz HBM gauges in_use {hbm_use}, limit "
                 f"{hbm_limit} (the card's {want_limit}); sample {hbm}")
        status = json.loads(get("/statusz"))
        trace = json.loads(get("/tracez?secs=0"))
        xray = json.loads(get("/xrayz"))
        flightz = json.loads(get("/flightz?note=phase14"))
        tracks = {e["args"]["name"] for e in trace["traceEvents"]
                  if e.get("ph") == "M" and e["name"] == "thread_name"}
        progs = [p["name"] for p in xray["programs"]]
        if [e["name"] for e in status["engines"]] != ["serve"] \
                or "bigdl-serve-drain" not in tracks \
                or not any(p.startswith("serving") for p in progs) \
                or not Path(flightz.get("bundle", "")).is_dir():
            fail(f"live plane: engines {status['engines']}, tracks "
                 f"{sorted(tracks)}, programs {progs}, flightz {flightz}")
        res["live"] = {"metricsz_lines": len(text.splitlines()),
                       "families": len({n for n, _ in prom}),
                       "hbm_in_use": hbm_use, "hbm_limit": hbm_limit,
                       "trace_events": len(trace["traceEvents"]),
                       "programs": progs, "flightz": flightz["bundle"]}
        print(f"observability: live plane on {srv.address}: /metricsz "
              f"{len(text.splitlines())} lines in "
              f"{res['live']['families']} families (completed "
              f"{int(snap['completed'])} = the engine's, histogram count "
              f"{int(hist_n)}, HBM in use {hbm_use:.0f} of {hbm_limit} "
              f"bytes); /tracez {len(trace['traceEvents'])} events on "
              f"tracks {sorted(tracks)}; /xrayz {len(progs)} programs; "
              f"/flightz {Path(flightz['bundle']).name}", flush=True)
    finally:
        engine.close()
        serve_ship.close()

    # --------------------------------------- (d) the profiling tools
    train_ship = cluster.TelemetryShipper(str(run_dir), "train",
                                          interval_s=0)
    x32 = torch.rand((BATCH,) + dims, generator=gen, device=dev).to(bf16)
    model.eval()
    with torch.no_grad():
        model(x32)  # built and warm outside the trace
    opt = (Optimizer.apply(model, DataSet.from_arrays(
        feats[:2 * BATCH], labels[:2 * BATCH], batch_size=BATCH), crit,
        end_trigger=Trigger.max_iteration(OBS_PROFILE_ITERS), device=dev)
        .set_optim_method(SGD(0.1, momentum=0.9)).set_compute_dtype(bf16))
    train_ship.add_metrics("train", lambda: opt.metrics)
    logdir = scratch / "profile"
    tracer.clear()
    t0 = time.perf_counter()
    with profiling.trace(str(logdir)):
        with profiling.annotate("phase14_forward"), torch.no_grad():
            model.eval()
            model(x32)
        opt.optimize()
    trace_s = time.perf_counter() - t0
    train_ship.close()
    (dev_trace,) = logdir.glob("*.pt.trace.json")
    events = json.loads(dev_trace.read_text())["traceEvents"]
    by_kernel = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            w = kernel_of(e.get("name", ""))
            if w is not None:
                by_kernel[w] += 1
    host = json.loads((logdir / "host_trace.json").read_text())
    loop = {e["name"] for e in host["traceEvents"] if e.get("ph") == "X"}
    steps = {e.get("args", {}).get("corr") for e in host["traceEvents"]
             if e.get("name") == "dispatch"}
    if dev == "cuda" and not set(STEP_LAUNCHES[True]) <= set(by_kernel):
        fail(f"the device trace names {dict(by_kernel)}, not kernels 1-5")
    if not {"dispatch", "data_stall"} <= loop or "step:1" not in steps:
        fail(f"host_trace.json: spans {sorted(loop)}, steps {steps}")
    rows = profiling.get_times(model, x=x32)
    table = profiling.format_times(rows)
    print(table, flush=True)
    blocks = sum(1 for _, t, _, _ in rows if t == "FusedBottleneck")
    if blocks != 16 or len(rows) != len(model.child_keys):
        fail(f"get_times: {len(rows)} rows, {blocks} fused blocks")
    res["profiling"] = {
        "device_trace_bytes": dev_trace.stat().st_size,
        "device_trace_kernels": dict(by_kernel), "host_spans": sorted(loop),
        "seconds": trace_s, "get_times_rows": len(rows),
        "get_times_fwd_ms": 1e3 * sum(r[2] for r in rows),
        "get_times_bwd_ms": 1e3 * sum(r[3] for r in rows)}
    print(f"observability: profiling.trace of a batch-{BATCH} forward and "
          f"{OBS_PROFILE_ITERS} optimize() iterations ({trace_s:.1f} s): "
          f"device trace {dev_trace.stat().st_size} bytes naming "
          f"{dict(by_kernel)}; host_trace.json spans {sorted(loop)}; "
          f"get_times {len(rows)} rows, forward "
          f"{res['profiling']['get_times_fwd_ms']:.1f} ms, backward "
          f"{res['profiling']['get_times_bwd_ms']:.1f} ms in all (eager, "
          f"synchronised per layer); {card}", flush=True)
    del opt
    shutil.rmtree(scratch, ignore_errors=True)

    # ---------------------------------------- (e) the cluster merge
    agg = cluster.ClusterAggregator(str(run_dir)).load()
    merged = agg.merge_trace()
    lanes = sorted(e["args"]["name"] for e in merged["traceEvents"]
                   if e.get("ph") == "M" and e["name"] == "process_name")
    summary = agg.cluster_summary()
    with contextlib.redirect_stdout(io.StringIO()) as top_out:
        top_rc = cluster_top.main([str(run_dir), "--json"])
    top = json.loads(top_out.getvalue())
    if len(lanes) != 2 or set(summary["per_host"]) != {"serve", "train"} \
            or summary["per_host"]["train"]["n_steps"] < 1 or top_rc != 0 \
            or set(top["summary"]["per_host"]) != {"serve", "train"}:
        fail(f"cluster: lanes {lanes}, hosts {sorted(summary['per_host'])}, "
             f"cluster_top rc {top_rc}")
    res["cluster"] = {"lanes": lanes, "events": len(merged["traceEvents"]),
                      "summary": summary["cluster"]}
    print(f"observability: cluster merge of {len(lanes)} shipped hosts "
          f"{lanes}: {len(merged['traceEvents'])} events, train steps "
          f"{summary['per_host']['train']['n_steps']}, debug address "
          f"{summary['per_host']['serve']['debug_addr']}", flush=True)

    tracer.disable()
    tracer.clear()
    srv.close()
    flightrecorder.set_global(None)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    res["seconds"] = time.perf_counter() - t_phase
    print(f"observability phase: {res['seconds']:.1f} s", flush=True)
    return res


def kernel_tools(gen, dev):
    """The kernel checks' helpers over the generator ``gen`` on
    ``dev``: random operands of kernels 1-5 (``operands``), their
    calls (``call``), one library call for each (``library``), the
    checks against the plain versions (``check``, ``close``), a
    bit-equality test (``same``), the least time (``bound``) and
    ``kernels``: op -> (kernel name, wrapper, plain version, the TPU
    kernel it replaces)."""
    import torch

    from bigdl_tpu_torch.ops import fused_matmul as fm

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def operands(op, shape, prologue, dtype):
        """Inputs of kernel family ``op`` at ``shape``: x, w, ps, pb and,
        for a backward kernel, the saved y and the cotangents dy, dssum,
        dssq (random, at the scales a train step gives them)."""
        conv = op in ("cv", "cv_dgrad")
        if conv:
            b, h, wd, c, co = shape
            x = rand(b, h, wd, c, dtype=dtype)
            w = rand(3, 3, c, co, scale=(9 * c) ** -0.5, dtype=dtype)
            y_shape = (b, h, wd, co)
        else:
            m, k, n = shape
            x, w = rand(m, k, dtype=dtype), rand(k, n, scale=k ** -0.5,
                                                  dtype=dtype)
            c, co, y_shape = k, n, (m, n)
        ps = pb = None
        if prologue:
            ps = torch.rand(c, generator=gen, device=dev) + 0.5
            pb = torch.randn(c, generator=gen, device=dev) * 0.5
        ops = {"x": x, "w": w, "ps": ps, "pb": pb}
        if op in ("mm", "cv"):
            return ops
        m = math.prod(y_shape[:-1])
        ops.update(y=rand(*y_shape, dtype=dtype),
                   dy=rand(*y_shape, scale=m ** -0.5, dtype=dtype),
                   dssum=torch.randn(co, generator=gen, device=dev) / m,
                   dssq=torch.randn(co, generator=gen, device=dev) / m)
        return ops

    def ytot(o, dtype):
        return (o["dy"].float() + o["dssum"]
                + 2.0 * o["y"].float() * o["dssq"]).to(dtype)

    def prologue_bwd(g, o):
        """The library version's mask and reductions (on f32 g)."""
        if o["ps"] is None:
            return g.to(o["x"].dtype), None, None
        xf = o["x"].float().reshape(g.shape)
        g = torch.where(xf * o["ps"] + o["pb"] > 0, g, 0.0)
        return (g * o["ps"]).to(o["x"].dtype), (g * xf).sum(0), g.sum(0)

    def library(op, o):
        """One PyTorch library call for the same function, with the
        elementwise work around it done by plain tensor ops."""
        x, w, ps, pb = o["x"], o["w"], o["ps"], o["pb"]
        if op in ("mm", "cv", "mm_wgrad"):
            u = x if ps is None else torch.relu(
                x.float() * ps + pb).to(w.dtype)
        if op == "mm":
            y = torch.matmul(u, w)
        elif op == "cv":
            y = torch.nn.functional.conv2d(
                u.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1
            ).permute(0, 2, 3, 1)
        if op in ("mm", "cv"):
            yf = y.float().reshape(-1, y.shape[-1])
            return y, yf.sum(0), (yf * yf).sum(0)
        t = ytot(o, x.dtype)
        if op == "mm_dgrad":
            return prologue_bwd(torch.matmul(t, w.t()).float(), o)
        if op == "mm_wgrad":
            return torch.matmul(u.t(), t)
        b, h, wd, ci = x.shape
        g = torch.nn.grad.conv2d_input(
            (b, ci, h, wd), w.permute(3, 2, 0, 1), t.permute(0, 3, 1, 2),
            padding=1).permute(0, 2, 3, 1)
        return prologue_bwd(g.float().reshape(-1, ci), o)

    def call(fn, op, o):
        if op in ("mm", "cv"):
            return fn(o["x"], o["w"], o["ps"], o["pb"], relu=True)
        if op == "mm_wgrad":
            return fn(o["x"], o["ps"], o["pb"], o["dy"], o["y"], o["dssum"],
                      o["dssq"], relu=True)
        return fn(o["dy"], o["y"], o["dssum"], o["dssq"], o["w"], o["x"],
                  o["ps"], o["pb"], relu=True)

    def close(name, what, got, ref, dt, atol_scale=1.0):
        """Elementwise check of a tensor in x's type; max |d|.
        ``atol_scale`` widens the absolute part for deeper reductions."""
        d = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        bad = (d > Y_RTOL[dt] * ref.float().abs()
               + atol_scale * Y_ATOL[dt] * scale).sum()
        if not torch.isfinite(got.float()).all() or bad:
            fail(f"{name}: kernel {what} disagrees with the plain version "
                 f"({int(bad)} bad, max |d| {d.max().item():.4g})")
        return d.max().item()

    def close_sums(name, what, got, ref, rtol, atol):
        bad = ((got - ref).abs() > rtol * ref.abs() + atol).sum()
        if not torch.isfinite(got).all() or bad:
            fail(f"{name}: kernel {what} disagrees with the plain version "
                 f"({int(bad)} bad, max |d| "
                 f"{(got - ref).abs().max().item():.4g})")

    def check(name, op, got, ref, dt, m, atol_scale=1.0):
        if op in ("mm", "cv"):
            (y, s, q), (yr, sr, qr) = got, ref
            err = close(name, "y", y, yr, dt, atol_scale)
            close_sums(name, "ssum", s, sr, STATS_RTOL,
                       1e-5 * torch.sqrt(m * qr))  # bounds |column sum|
            close_sums(name, "ssq", q, qr, STATS_RTOL, 0.0)
            return err
        if op == "mm_wgrad":
            return close(name, "dW", got, ref, dt, atol_scale)
        (dx, dps, dpb), (dxr, dpsr, dpbr) = got, ref
        err = close(name, "dx", dx, dxr, dt, atol_scale)
        if (dps is None) != (dpsr is None):
            fail(f"{name}: d_ps/d_pb present in one version only")
        for what, g, r in (("d_ps", dps, dpsr), ("d_pb", dpb, dpbr)):
            if r is not None:
                close_sums(name, what, g, r, STATS_RTOL,
                           DSUM_ATOL * r.abs().max())
        return err

    # op -> (kernel name, wrapper, plain version, source, TPU kernel)
    src = "bigdl_tpu_torch/csrc/"
    tpu = "bigdl_tpu/ops/pallas/fused_matmul.py:"
    kernels = {
        "mm": ("fused_matmul_bn", fm.fused_matmul_bn,
               fm.fused_matmul_bn_plain, f"{tpu}159"),
        "mm_dgrad": ("fused_matmul_bn_dgrad", fm.fused_matmul_bn_dgrad,
                     fm.fused_matmul_bn_dgrad_plain, f"{tpu}218"),
        "mm_wgrad": ("fused_matmul_bn_wgrad", fm.fused_matmul_bn_wgrad,
                     fm.fused_matmul_bn_wgrad_plain, f"{tpu}300"),
        "cv": ("fused_conv3x3_bn", fm.fused_conv3x3_bn,
               fm.fused_conv3x3_bn_plain, f"{tpu}516"),
        "cv_dgrad": ("fused_conv3x3_bn_dgrad", fm.fused_conv3x3_bn_dgrad,
                     fm.fused_conv3x3_bn_dgrad_plain, f"{tpu}671"),
    }
    def same(a, b):
        if a is None or isinstance(a, torch.Tensor):
            return a is b if a is None else torch.equal(a, b)
        return all(same(u, v) for u, v in zip(a, b))

    def bound(op, shape, prologue, f32=False):
        """(bytes ms, operations ms) of the kernel's formula in the
        package (``fm.COSTS``: each input read once, each output written
        once) over the card's memory rate and bf16 peak (with ``f32``:
        4-byte elements over the f32 peak outside the tensor cores).
        Without a prologue a dgrad reads no x and a kernel no ps, pb."""
        ops, nbytes = fm.COSTS[kernels[op][0]](*shape, prologue,
                                               4 if f32 else 2)
        return (nbytes / PEAK_BYTES * 1e3,
                ops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS) * 1e3)

    return types.SimpleNamespace(
        kernels=kernels, src=src, rand=rand, operands=operands, ytot=ytot,
        prologue_bwd=prologue_bwd, library=library, call=call, close=close,
        close_sums=close_sums, check=check, same=same, bound=bound)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "smoke",
                    help="directory for the nvcc log and per-shape times")
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels, then stop")
    args = ap.parse_args()

    import numpy as np
    import torch

    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    try:
        import bigdl_tpu_torch
    except ImportError as e:
        fail(f"cannot import bigdl_tpu_torch beside this script: {e}")
    if Path(bigdl_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"bigdl_tpu_torch imported from {bigdl_tpu_torch.__file__}, "
             "not from this checkout")
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import fused_matmul as fm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)
    # f32 references in full f32 (cuDNN's default for f32 convs is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    (out / "kernel_build.log").write_text("\n".join(
        f"== {n}\n{log}" for n, log in _build.build_info["logs"].items()))
    print(f"kernels built in {build_s:.1f} s "
          f"({', '.join(_build.build_info['compiled'])})", flush=True)
    hgmma = {}
    for name in ("fused_matmul_bn", "fused_matmul_bn_dgrad",
                 "fused_matmul_bn_wgrad", "fused_conv3x3_bn",
                 "fused_conv3x3_bn_dgrad", "flash_attention"):
        sass = subprocess.run(
            [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
             str(libs[name])], capture_output=True, text=True)
        hgmma[name] = sass.stdout.count("HGMMA")
        if sass.returncode != 0 or hgmma[name] == 0:
            fail(f"{name}: no wgmma (HGMMA) in its SASS "
                 f"({sass.stderr.strip()[:200]})")
    # kernel 7's integer wgmma: cuobjdump spells it IGMMA
    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(libs["int8_matmul"])], capture_output=True, text=True)
    hgmma["int8_matmul (IGMMA)"] = sass.stdout.count("IGMMA")
    if sass.returncode != 0 or hgmma["int8_matmul (IGMMA)"] == 0:
        fail(f"int8_matmul: no integer wgmma (IGMMA) in its SASS "
             f"({sass.stderr.strip()[:200]})")
    print(f"wgmma instructions (HGMMA; IGMMA for int8_matmul) in the SASS: "
          f"{hgmma}", flush=True)
    dev = torch.device("cuda")

    # --------------------------------------------------------- 2. kernels
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    kt = kernel_tools(gen, dev)
    (operands, library, call, close, check, kernels, src, same,
     bound) = (kt.operands, kt.library, kt.call, kt.close, kt.check,
               kt.kernels, kt.src, kt.same, kt.bound)
    mm_calls, cv_calls = resnet50_calls(BATCH)
    if sum(mm_calls.values()) != 36 or sum(cv_calls.values()) != 13:
        fail(f"call table: {sum(mm_calls.values())} matmuls, "
             f"{sum(cv_calls.values())} convs per forward")
    main_shapes = [(op, (m, k, n), p, c) for (m, k, n, p), c
                   in mm_calls.items() for op in ("mm", "mm_dgrad",
                                                  "mm_wgrad")]
    main_shapes += [(op, s, True, c) for s, c in cv_calls.items()
                    for op in ("cv", "cv_dgrad")]
    extra = []
    for op in ("mm", "mm_dgrad", "mm_wgrad"):
        extra += [(op, (147, 2048, 512), True, "bf16"),  # ragged M, 3 x 7x7
                  (op, (1000, 64, 256), False, "bf16"),
                  (op, (300, 72, 136), True, "bf16"),  # ragged K and N
                  (op, (4099, 256, 64), True, "f32")]
    for op in ("cv", "cv_dgrad"):
        extra += [(op, (1, 56, 56, 64, 64), True, "bf16"),  # batch 1
                  (op, (1, 7, 7, 512, 512), True, "bf16"),
                  (op, (3, 7, 7, 512, 512), False, "bf16"),
                  (op, (2, 14, 14, 64, 128), True, "f32")]
    max_err = Counter()
    for op, shape, prologue, dt in extra + [
            (o_, s_, p_, "bf16") for o_, s_, p_, _ in main_shapes]:
        name, kern, plain, _ = kernels[op]
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        o = operands(op, shape, prologue, dtype)
        got = call(kern, op, o)
        torch.cuda.synchronize()
        if op in BIT_EQUAL and dt == "bf16" and not same(
                got, call(kern, op, o)):
            fail(f"{name}{shape}: two runs differ")
        ref = call(plain, op, o)
        m = math.prod(shape[:-2]) if op.startswith("cv") else shape[0]
        err = check(f"{name}{shape} {dt}", op, got, ref, dt, m)
        if dt == "bf16":
            max_err[op] = max(max_err[op], err)
        del o, got, ref
    print(f"kernel checks passed: {len(extra) + len(main_shapes)} cases, "
          f"max |kernel - plain| {dict(max_err)}", flush=True)

    # kernels 1-5 at width 12: the channels zero-padded to 16, one launch
    # and one operand copy each, held against the plain version
    width12 = []
    for op, shape in WIDTH12_CASES:
        name, kern, plain, _ = kernels[op]
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            o = operands(op, shape, True, dtype)
            fm.reset_launches()
            got = call(kern, op, o)
            torch.cuda.synchronize()
            launches = fm.LAUNCHES[name]
            copies = fm.COPIES["fused_channel_pad"]
            if launches != 1 or copies != 1 or sum(fm.LAUNCHES.values()) != 1:
                fail(f"{name}{shape} {dt}: launches {fm.LAUNCHES}, channel "
                     f"pads {copies}; expected one of each")
            m = math.prod(shape[:-2]) if op.startswith("cv") else shape[0]
            err = check(f"{name}{shape} {dt} (width 12, padded)", op, got,
                        call(plain, op, o), dt, m)
            width12.append({"kernel": name, "shape": list(shape),
                            "dtype": dt, "launches": launches,
                            "copies": copies, "max_abs_err": err})
            del o, got
    print(f"width-12 checks passed: {len(width12)} cases (kernels 1-5, "
          f"bf16 and f32, channels padded to 16), max |kernel - plain| "
          f"{max(r['max_abs_err'] for r in width12):.4g}", flush=True)

    # a NaN in row 37 of x, through the prologue (relu): it must reach
    # the outputs exactly where it reaches the plain version's.  The
    # dgrads' mask zeroes g at the NaN (dx is 0 there, d_pb finite) and
    # only d_ps carries it (0 * NaN)
    for op, shape in NAN_CASES:
        name, kern, plain, _ = kernels[op]
        for dtype in (torch.bfloat16, torch.float32):
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            o = operands(op, shape, True, dtype)
            o["x"].view(-1, o["x"].shape[-1])[37, 5] = float("nan")
            got, ref = call(kern, op, o), call(plain, op, o)
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):
                got, ref = (got,), (ref,)
            if not any(torch.isnan(r).any() for r in ref):
                fail(f"{name}{shape} {dt}: the NaN reached no output of "
                     "the plain version")
            for what, g, r in zip(("out", "d_ps", "d_pb"), got, ref):
                if not torch.equal(torch.isnan(g), torch.isnan(r)):
                    fail(f"{name}{shape} {dt} {what}: NaN at "
                         f"{int(torch.isnan(g).sum())} places, the plain "
                         f"version at {int(torch.isnan(r).sum())}")
            if op.endswith("dgrad") and (
                    got[0].view(-1, got[0].shape[-1])[37, 5] != 0
                    or not torch.isnan(got[1][5])):
                fail(f"{name}{shape} {dt}: dx at the NaN is not 0 or d_ps "
                     "of its channel is not NaN")
            close(f"{name}{shape} {dt} NaN row", "finite part",
                  got[0].nan_to_num(0.0), ref[0].nan_to_num(0.0), dt)
            del o, got, ref
    print(f"NaN checks passed: {2 * len(NAN_CASES)} cases", flush=True)
    flash_rows, flash_err = flash_phase(gen, timing=not args.quick)
    int8_rows = int8_phase(gen, timing=not args.quick)
    if args.quick:
        print("quick: kernels build, launch and agree; stopping")
        return

    rows, agg = [], {}
    for op, shape, prologue, count in main_shapes:
        name, kern, plain, _ = kernels[op]
        o = operands(op, shape, prologue, torch.bfloat16)
        r = {"kernel": name, "shape": list(shape), "prologue": prologue,
             "calls_per_forward": count,
             "ms": device_ms(lambda: call(kern, op, o)),
             "plain_ms": device_ms(lambda: call(plain, op, o)),
             "library_ms": device_ms(lambda: library(op, o)),
             "call_ms": call_ms(lambda: call(kern, op, o))}
        r["bytes_ms"], r["ops_ms"] = bound(op, shape, prologue)
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        rows.append(r)
        a = agg.setdefault(op, Counter())
        for key in ("ms", "plain_ms", "library_ms", "call_ms", "bound_ms",
                    "bytes_ms", "ops_ms"):
            a[key] += count * r[key]
        print(f"  {name} {tuple(shape)} x{count}: {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f}, eager call {r['call_ms']:.4f})",
              flush=True)
        del o

    # kernels 1-5 at the batch-256 shapes of the train step: bit-equal
    # on a second run, checked against their plain versions, timed beside
    # their library calls
    mm256, cv256 = resnet50_calls(TRAIN_BATCH)
    cases256 = [(op, (m, k, n), p, c) for (m, k, n, p), c in mm256.items()
                for op in ("mm", "mm_dgrad", "mm_wgrad")]
    cases256 += [(op, s_, True, c) for s_, c in cv256.items()
                 for op in ("cv", "cv_dgrad")]
    rows256 = []
    for op, shape, prologue, count in cases256:
        name, kern, plain, _ = kernels[op]
        o = operands(op, shape, prologue, torch.bfloat16)
        m = math.prod(shape[:-2]) if op.startswith("cv") else shape[0]
        got = call(kern, op, o)
        if not same(got, call(kern, op, o)):
            fail(f"{name}{shape}: two runs differ")
        check(f"{name}{shape} bf16", op, got, call(plain, op, o), "bf16", m)
        del got
        r = {"kernel": name, "op": op, "shape": list(shape),
             "prologue": prologue, "calls_per_forward": count,
             "ms": device_ms(lambda: call(kern, op, o)),
             "library_ms": device_ms(lambda: library(op, o))}
        r["bytes_ms"], r["ops_ms"] = bound(op, shape, prologue)
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        rows256.append(r)
        print(f"  {name} {tuple(shape)} x{count}: {r['ms']:.4f} ms (library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of it)", flush=True)
        del o

    # ----------------------------------------------------------- 3. serve
    device_memory("before phase 3 (serve)")
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import use_plain_ops
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.utils import (export_variables, graphs,
                                       load_jax_variables, random_variables)

    model = ResNet50(1000, stem="space_to_depth", fused=True)
    variables = random_variables(export_variables(model), args.seed)
    load_jax_variables(model, variables)
    reference = use_plain_ops(ResNet50(1000, stem="space_to_depth",
                                       fused=True))
    load_jax_variables(reference, variables)

    # the counts run from before the engine's warmup, which compiles
    # every declared bucket: a capture counts its launches, a replay none
    fm.reset_launches()
    graphs.reset_counts()
    engine = ServingEngine(model, buckets=[(224, 224, 3)],
                           batch_sizes=SERVE_BATCHES,
                           input_dtype=torch.bfloat16)
    rs = np.random.RandomState(args.seed + 1)
    images = rs.randn(REQUESTS, 224, 224, 3).astype(np.float32)
    answers = [None] * REQUESTS
    errors = []
    n_clients = 4

    def client(idx):
        try:
            futs = [(i, engine.submit(images[i]))
                    for i in range(idx, REQUESTS, n_clients)]
            for i, f in futs:
                answers[i] = f.result(300)
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    serve_launches = dict(fm.LAUNCHES)
    if fm.COPIES["fused_channel_pad"]:
        fail(f"serving padded channels: {fm.COPIES}")
    batches = engine.metrics.batches
    check_steady("serve", engine, batches, graphs.COUNTS["replays"])
    log_line = engine.log_line()
    p50, p99 = engine.metrics.latency_ms(50), engine.metrics.latency_ms(99)
    engine.close()
    if errors:
        fail(f"client errors: {errors[:3]}")
    if {k: v for k, v in serve_launches.items() if v} != host_launches(
            FUSED_FWD, engine.recompiles) or any(
            g.launches != FUSED_FWD for g in engine._compiled.values()):
        fail(f"launches {serve_launches} over {engine.recompiles} captures "
             f"and {batches} batches; expected {FUSED_FWD} per capture "
             "and none per replay")

    # one batch-32 forward: eager (host included) against the device
    # alone (CUDA graph replay), and the plain path's device time
    xb = torch.from_numpy(images[:32]).to(dev).to(torch.bfloat16)
    with torch.inference_mode():
        fwd = {"eager_ms": call_ms(lambda: model(xb)),
               "device_ms": device_ms(lambda: model(xb), reps=1),
               "plain_device_ms": device_ms(lambda: reference(xb), reps=1)}
    fwd["kernel_ms"] = agg["mm"]["ms"] + agg["cv"]["ms"]
    print(f"forward at batch 32: eager {fwd['eager_ms']:.3f} ms, device "
          f"{fwd['device_ms']:.3f} ms (CUDA graph), plain path device "
          f"{fwd['plain_device_ms']:.3f} ms; the two kernels "
          f"{fwd['kernel_ms']:.3f} ms of it", flush=True)

    ref_out = []
    with torch.inference_mode():
        for lo in range(0, REQUESTS, 32):
            xb = torch.from_numpy(images[lo:lo + 32]).to(dev)
            ref_out.append(reference(xb.to(torch.bfloat16)).float().cpu())
    ref_np = torch.cat(ref_out).numpy()
    got = np.stack(answers)
    if got.shape != (REQUESTS, 1000) or not np.isfinite(got).all():
        fail(f"served logits shape {got.shape} or non-finite values")
    serve_err = float(np.abs(got - ref_np).max())
    serve_scale = float(np.abs(ref_np).max())
    if serve_err > SERVE_TOL * serve_scale:
        fail(f"served logits differ from the plain path: max |d| "
             f"{serve_err:.4g} > {SERVE_TOL} x {serve_scale:.4g}")
    print(f"serve: {REQUESTS} requests from {n_clients} threads in "
          f"{batches} batches (graph replays), {REQUESTS / wall:.1f} "
          f"images/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms; launches "
          f"{serve_launches} over {engine.recompiles} captures; "
          f"max |logit - plain| {serve_err:.4g} (max |logit| "
          f"{serve_scale:.4g})", flush=True)
    print(log_line, flush=True)
    del engine, model, images, answers, got, ref_np

    # ----------------------------------------------------------- 4. train
    device_memory("before phase 4 (train)")
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion, FusedBottleneck
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger, make_train_step

    bf16 = torch.bfloat16
    crit = ClassNLLCriterion(logits=True)

    def set_remat(m, on):
        for blk in m.modules():
            if isinstance(blk, FusedBottleneck):
                blk.remat = on

    def fresh(m):
        """(params, model_state, opt_states) of ``m`` for the step."""
        params = {k: p.detach().clone() for k, p in m.named_parameters()}
        state = {k: b.detach().clone() for k, b in m.named_buffers()}
        return params, state, {"__all__": SGD(0.1, momentum=0.9)
                               .init_state(params)}

    tmodel = ResNet50(1000, stem="space_to_depth", fused=True)
    load_jax_variables(tmodel, variables)
    step = make_train_step(tmodel, crit, {"__all__": SGD(0.1, momentum=0.9)},
                           compute_dtype=bf16)
    plain_step = make_train_step(reference, crit,
                                 {"__all__": SGD(0.1, momentum=0.9)},
                                 compute_dtype=bf16)
    rs = np.random.RandomState(args.seed + 2)
    xt = torch.from_numpy(rs.rand(32, 224, 224, 3).astype(np.float32)
                          ).to(dev).to(bf16)  # bench.py:109
    tt = torch.from_numpy(rs.randint(0, 1000, 32)).to(dev)

    # 4.1 one step against the plain path, and the launches per step
    step_launches = {}
    for remat in (False, True):  # the remat-on step is compared below
        set_remat(tmodel, remat)
        fm.reset_launches()
        kern_out = step(*fresh(tmodel), 1, None, xt, tt, [0.1])
        torch.cuda.synchronize()
        step_launches[remat] = dict(fm.LAUNCHES)
        if step_launches[remat] != STEP_LAUNCHES[remat] or \
                fm.COPIES["fused_channel_pad"]:
            fail(f"train step launches with remat={remat}: "
                 f"{step_launches[remat]}, expected {STEP_LAUNCHES[remat]}, "
                 f"and channel pads {fm.COPIES} (expected none)")
    print(f"train step launches: remat on {step_launches[True]}, "
          f"remat off {step_launches[False]}", flush=True)

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()

    def compare(what, kern, plain, tol):
        """Kernel-path step outputs against the plain path's."""
        (pk, sk, ok, lk), (_, sp, op_, lp) = kern, plain
        vk, vp = ok["__all__"]["velocity"], op_["__all__"]["velocity"]
        bad = [k for k in pk if not (torch.isfinite(vk[k]).all()
                                     and torch.isfinite(pk[k]).all())]
        if bad or not math.isfinite(lk.item()):
            fail(f"{what}: non-finite loss, gradients or parameters "
                 f"{bad[:4]}")
        err = {"loss": abs(lk.item() - lp.item()) / abs(lp.item())}
        grad = {k: rel(vk[k], vp[k]) for k in pk}
        state = {k: rel(sk[k], sp[k]) for k in sk}
        err["grad"], err["state"] = max(grad.values()), max(state.values())
        worst = max(grad, key=grad.get)
        print(f"train step parity, {what} at batch 32 (kernels vs plain "
              f"path): loss {lk.item():.6g} vs {lp.item():.6g} (rel "
              f"{err['loss']:.3g}); gradient rel L2 per leaf max "
              f"{err['grad']:.3g} ({worst}), median "
              f"{sorted(grad.values())[len(grad) // 2]:.3g}; running "
              f"stats max {err['state']:.3g}", flush=True)
        over = {k: (err[k], t) for k, t in tol.items() if err[k] > t}
        if over:
            fail(f"{what} train step disagrees with the plain path: "
                 f"(error, limit) {over}")
        return err

    parity = {"bf16": compare("bf16", kern_out, plain_step(
        *fresh(reference), 1, None, xt, tt, [0.1]), TRAIN_BF16_TOL)}
    f32_step = make_train_step(tmodel, crit,
                               {"__all__": SGD(0.1, momentum=0.9)})
    f32_plain = make_train_step(reference, crit,
                                {"__all__": SGD(0.1, momentum=0.9)})
    xf = xt.float()
    parity["f32"] = compare(
        "f32", f32_step(*fresh(tmodel), 1, None, xf, tt, [0.1]),
        f32_plain(*fresh(reference), 1, None, xf, tt, [0.1]), TRAIN_F32_TOL)
    del kern_out, plain_step, f32_step, f32_plain, reference, xf

    # one fused block at a time, f32: the gradients are well-conditioned
    parity["blocks"] = {}
    for n_in, planes, stride, hw in BLOCKS:
        bv = random_variables(export_variables(
            FusedBottleneck(n_in, planes, stride)), args.seed + 4)
        xb = torch.randn((BATCH, hw, hw, n_in), generator=gen, device=dev)
        cot = torch.randn((BATCH, hw // stride, hw // stride, 4 * planes),
                          generator=gen, device=dev)
        got = []
        for plain in (False, True):
            blk = FusedBottleneck(n_in, planes, stride).to(dev)
            load_jax_variables(blk, bv)
            use_plain_ops(blk, plain).train()
            xx = xb.clone().requires_grad_(True)
            yb = blk(xx)
            (yb * cot).sum().backward()
            got.append({"out": yb.detach(), "dx": xx.grad,
                        **{k: p.grad for k, p in blk.named_parameters()},
                        **dict(blk.named_buffers())})
        err = {k: rel(got[0][k], got[1][k]) for k in got[1]}
        worst = max(err, key=err.get)
        what = f"block({n_in}, {planes}, stride {stride}) at {hw}x{hw}"
        parity["blocks"][what] = err[worst]
        print(f"train parity, {what}, f32: output, gradients and running "
              f"stats rel L2 max {err[worst]:.3g} ({worst})", flush=True)
        if err[worst] > BLOCK_TOL or not all(
                torch.isfinite(t).all() for t in got[0].values()):
            fail(f"{what}: kernels disagree with the plain path: "
                 f"{worst} {err[worst]:.3g} > {BLOCK_TOL}")
        del got, xb, cot

    # 4.2 ten steps on one batch: the loss falls
    trees = fresh(tmodel)
    losses = []
    for i in range(10):
        *trees, loss = step(*trees, i + 1, None, xt, tt, [0.1])
        losses.append(loss.item())
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"loss did not fall over 10 steps on one batch: {losses}")
    print(f"learning: 10 steps on one batch of 32, loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    del trees

    # 4.3 throughput at batch 256, remat on and off
    x256 = torch.rand((TRAIN_BATCH, 224, 224, 3), generator=gen,
                      device=dev).to(bf16)
    t256 = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    train = {}
    for remat in (True, False):
        set_remat(tmodel, remat)
        trees = fresh(tmodel)
        for i in range(3):
            *trees, loss = step(*trees, i + 1, None, x256, t256, [0.1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t_host = time.perf_counter()
        for i in range(10):
            *trees, loss = step(*trees, i + 4, None, x256, t256, [0.1])
        # the host's time to enqueue a step: where it reaches the step
        # time, the host and not the card sets the pace
        host_ms = (time.perf_counter() - t_host) * 1e3 / 10
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / 10
        train[remat] = {"ms_per_step": ms, "host_enqueue_ms": host_ms,
                        "images_per_s": TRAIN_BATCH / ms * 1e3,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "loss": loss.item()}
        if not math.isfinite(train[remat]["loss"]):
            fail(f"non-finite loss at batch {TRAIN_BATCH}, remat={remat}")
        print(f"train at batch {TRAIN_BATCH}, remat {'on' if remat else 'off'}"
              f": {train[remat]['images_per_s']:.1f} images/s, "
              f"{ms:.2f} ms per step (the host enqueues one in "
              f"{host_ms:.2f} ms), peak memory "
              f"{train[remat]['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        del trees

    # where one remat-on step's device time goes (informational)
    set_remat(tmodel, True)
    trees = fresh(tmodel)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*trees, 1, None, x256, t256, [0.1])
        torch.cuda.synchronize()
    groups = Counter()
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # a CPU op: its kernels are counted as themselves
        t_us = getattr(evt, "device_time_total", None)
        if t_us is None:
            t_us = getattr(evt, "cuda_time_total", 0)
        key = evt.key
        if "conv3_dgrad_wgmma" in key:
            grp = "kernel 5 (conv dgrad)"
        elif "mm_dgrad_wgmma" in key:
            grp = "kernel 2 (matmul dgrad)"
        elif "conv3_wgmma" in key:
            grp = "kernel 4 (conv forward)"
        elif "mm_wgmma" in key:
            grp = "kernel 1 (matmul forward)"
        elif "split_sum" in key:
            grp = "split sums (kernels 1, 2, 4, 5)"
        elif "fused_gemm_bn_kernel" in key:
            grp = ("kernel 4 (conv forward)" if "true>" in key
                   else "kernel 1 (matmul forward)")
        elif "fused_dgrad_kernel" in key:
            grp = ("kernel 5 (conv dgrad)" if "true>" in key
                   else "kernel 2 (matmul dgrad)")
        elif "wgrad" in key:
            grp = "kernel 3 (matmul wgrad)"
        elif "colsum_kernel" in key:
            grp = "column sums (kernels 1, 2, 4, 5)"
        else:
            grp = "library and elementwise"
        groups[grp] += t_us / 1e3
    device_total = sum(groups.values())
    breakdown = {k: round(v, 3) for k, v in groups.most_common()}
    print(f"one step at batch {TRAIN_BATCH} (remat on), device ms by part "
          f"(torch.profiler, {device_total:.1f} ms in all): {breakdown}",
          flush=True)
    del trees, x256, t256, prof

    # 4.4 the user entry point
    optlog = logging.getLogger("bigdl_tpu_torch.optim")
    optlog.setLevel(logging.INFO)
    optlog.addHandler(logging.StreamHandler(sys.stdout))
    rs = np.random.RandomState(args.seed + 3)
    feats = rs.rand(160, 224, 224, 3).astype(np.float32)
    labels = rs.randint(0, 1000, 160)
    umodel = ResNet50(1000, stem="space_to_depth", fused=True)
    load_jax_variables(umodel, variables)
    fm.reset_launches()
    graphs.reset_counts()
    t0 = time.perf_counter()
    opt = (Optimizer.apply(umodel, DataSet.from_arrays(feats, labels,
                                                       batch_size=32),
                           ClassNLLCriterion(logits=True),
                           end_trigger=Trigger.max_iteration(OPT_ITERS))
           .set_optim_method(SGD(0.1, momentum=0.9))
           .set_compute_dtype(bf16))
    opt.optimize()
    opt_s = time.perf_counter() - t0
    opt_launches = dict(fm.LAUNCHES)
    opt_copies = fm.COPIES["fused_channel_pad"]
    final_loss = opt._loop_state["loss"]
    print(opt.train_log_line(), flush=True)
    if not math.isfinite(final_loss):
        fail(f"Optimizer.optimize() ended with loss {final_loss}")
    # one compiled step: one capture, then a replay per iteration
    compiled = opt.train_step
    if (compiled.captures, compiled.replays) != (1, OPT_ITERS) or \
            graphs.COUNTS["replays"] != OPT_ITERS:
        fail(f"Optimizer.optimize(): {compiled.captures} captures and "
             f"{compiled.replays} replays over {OPT_ITERS} iterations")
    want = host_launches(STEP_LAUNCHES[True], 1)
    step_graph = next(iter(compiled.graphs.values()))
    if opt_launches != want or step_graph.launches != STEP_LAUNCHES[True] \
            or opt_copies:
        fail(f"Optimizer.optimize() launches {opt_launches} (the capture "
             f"{step_graph.launches}), expected {want} "
             f"({STEP_LAUNCHES[True]} per capture, none per replay); "
             f"channel pads {opt_copies} (expected none)")
    print(f"optimize: {OPT_ITERS} iterations at batch 32 (f32 features, "
          f"bf16 parameters: the f32 kernels) in {opt_s:.1f} s, final loss "
          f"{final_loss:.4f}; one capture ({step_graph.capture_seconds:.2f}"
          f" s with its warm-up), {compiled.replays} "
          f"replays; launches {opt_launches}", flush=True)
    del tmodel, umodel, opt, feats, xt
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 5. lm
    device_memory("before phase 5 (lm)")
    lm = lm_phase(args)
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 6. quant
    device_memory("before phase 6 (quant)")
    quant = quant_phase(args, out)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 7. graphs
    device_memory("before phase 7 (graphs)")
    graph_res = graphs_phase(args)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 8. decode
    device_memory("before phase 8 (decode)")
    decode = decode_phase(args, card)
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 9. checkpoint
    device_memory("before phase 9 (checkpoint)")
    ckpt = checkpoint_phase(args, card)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 10. recipe
    device_memory("before phase 10 (recipe)")
    recipe = recipe_phase(args, card)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 11. data
    device_memory("before phase 11 (data)")
    data = data_phase(args, card, recipe["recipe"])
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 12. basic
    device_memory("before phase 12 (basic)")
    basic = basic_phase(args, card, kt)
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 13. telemetry
    device_memory("before phase 13 (telemetry)")
    tel = telemetry_phase(args, card, out)
    torch.cuda.empty_cache()

    # --------------------------------------------------- 14. observability
    device_memory("before phase 14 (observability)")
    obs = observability_phase(args, card, out)

    (out / "chip_smoke_kernels.json").write_text(json.dumps(
        {"card": card, "batch": BATCH, "rows": rows, "forward": fwd,
         "batch256": rows256, "hgmma": hgmma,
         "serve": {"requests": REQUESTS, "batches": batches,
                   "images_per_s": REQUESTS / wall, "p50_ms": p50,
                   "p99_ms": p99, "max_abs_err": serve_err,
                   "max_abs_logit": serve_scale},
         "train": {"batch": TRAIN_BATCH,
                   "remat_on": train[True], "remat_off": train[False],
                   "step_device_ms_by_part": breakdown,
                   "parity": parity,
                   "losses_one_batch": losses,
                   "optimize": {"seconds": opt_s, "loss": final_loss}},
         "flash": flash_rows, "lm": lm, "int8": int8_rows, "quant": quant,
         "graphs": graph_res, "decode": decode, "checkpoint": ckpt,
         "recipe": recipe, "data": data, "basic": basic,
         "telemetry": tel, "observability": obs, "width12": width12},
        indent=1, default=str))

    # ---------------------------------------------------------- summary
    line = []
    for op in ("mm", "mm_dgrad", "mm_wgrad", "cv", "cv_dgrad"):
        name, _, _, replaces = kernels[op]
        a = agg[op]
        calls = sum((cv_calls if op.startswith("cv") else mm_calls).values())
        line.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces,
            "launches": opt_launches[name],
            "max_abs_err": max_err[op],
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"],
            "bound_by": "bytes" if a["bytes_ms"] >= a["ops_ms"]
            else "operations",
            "library_ms": a["library_ms"],
            "launches_by_path": {
                "serve": serve_launches[name],
                "train_step_remat_on": step_launches[True][name],
                "train_step_remat_off": step_launches[False][name],
                "optimize": opt_launches[name],
                "resnet_train_per_step":
                    recipe["recipe"]["launches_per_step"][name],
                "accum4_per_step":
                    recipe["accumulation"]["launches_per_step"][name],
                "resnet_folder_per_step":
                    data["cached"]["launches_per_step"][name],
                "resnet_folder_streaming_per_step":
                    data["streaming"]["launches_per_step"][name],
                "resnet18_per_step":
                    basic["recipe18"]["launches_per_step"].get(name, 0),
                "resnet34_per_step":
                    basic["resnet34_step"]["launches_per_step"].get(name, 0),
                "cifar20_per_step":
                    basic["cifar20"]["launches_per_step"].get(name, 0),
                "numerics_train_step_per_step":
                    obs["numerics"]["launches_per_step"][name],
                "seeded_divergence_optimize":
                    obs["divergence"]["launches"][name],
                "profiling_trace_device":
                    obs["profiling"]["device_trace_kernels"][name]},
            "no_prologue": {
                f"{r['model']} {r['dtype']}": {key: sum(
                    q["calls_per_forward"] * q[key]
                    for q in basic["no_prologue"] if q["kernel"] == name
                    and (q["model"], q["dtype"]) == (r["model"], r["dtype"]))
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
                for r in basic["no_prologue"] if r["kernel"] == name},
            "width_12": [{k: r[k] for k in ("shape", "dtype", "launches",
                                            "copies", "max_abs_err")}
                         for r in width12 if r["kernel"] == name],
            "shapes": f"one ResNet-50 {'backward' if 'grad' in op else 'forward'}"
                      f" at batch {BATCH}: {calls} calls, times summed",
            "batch_256": {key: sum(
                r["calls_per_forward"] * r[key] for r in rows256
                if r["op"] == op) for key in ("ms", "library_ms", "bound_ms")},
        })
    lm_row = flash_rows[0]  # the LM default, as MultiHeadAttention gives it
    line.append({
        "name": "flash_attention", "route": "cuda",
        "source": f"{src}flash_attention.cu",
        "replaces": "bigdl_tpu/ops/pallas/flash_attention.py:36",
        "launches": lm["main"]["launches"], "max_abs_err": flash_err,
        "ms": lm_row["ms"], "plain_ms": lm_row["plain_ms"],
        "bound_ms": lm_row["bound_ms"],
        "bound_by": "bytes" if lm_row["bytes_ms"] >= lm_row["ops_ms"]
        else "operations",
        "library_ms": lm_row["library_ms"],
        "launches_by_path": {
            "lm_train_step": LM["num_layers"],
            "lm_eval_forward": LM["num_layers"],
            "transformer_train_main": lm["main"]["launches"],
            "generate_reforward_per_step": decode["greedy"]["flash_per_step"],
            "generate_reforward": decode["launches_6"],
            "transformer_train_num_heads_1": lm["num_heads_1"]["launches"]},
        "head_dim_256": [{k: r[k] for k in (
            "shape", "causal", "dtype", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "library_ms")} for r in flash_rows
            if r["shape"][-1] > 128],
        "shapes": f"{tuple(lm_row['shape'])} causal bf16 as "
                  "MultiHeadAttention gives it, per call; "
                  f"{LM['num_layers']} calls per LM forward"})
    fwd7 = [r for r in int8_rows if r["calls_per_forward"]]
    k7 = {key: sum(r["calls_per_forward"] * r[key] for r in fwd7)
          for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                      "ops_ms")}
    line.append({
        "name": "int8_matmul", "route": "cuda",
        "source": f"{src}int8_matmul.cu",
        "replaces": "bigdl_tpu/ops/pallas/int8_matmul.py:60",
        "launches": quant["serve"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
        "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"],
        "bound_by": "bytes" if k7["bytes_ms"] >= k7["ops_ms"]
        else "operations",
        "library_ms": k7["library_ms"],
        "launches_by_path": {
            "serve": quant["serve"]["launches"],
            "resnet50_dynamic_forward": quant["launches"]["dynamic_forward"],
            "resnet50_weight_only_forward":
                quant["launches"]["weight_only_forward"],
            "mlp_forward": quant["launches"]["mlp_forward"],
            "int8_kv_extend_paged_per_chunk":
                decode["int8"]["launches_per_chunk"],
            "int8_kv_extend_paged": decode["int8"]["launches"],
            "decode_engine_int8_pool":
                decode["engine"]["int8"]["kernel7_host_launches"],
            "int8_spec_verify_per_round":
                decode["engine"]["int8_spec"]["verify_kernels"][
                    "int8_matmul"]},
        "int8_kv_scores": {key: decode["int8"][key] for key in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms",
            "chunk_ms", "ms_per_chunk")},
        "shapes": f"one quantized ResNet-50 forward at batch {QUANT_BATCH}: "
                  f"{sum(r['calls_per_forward'] for r in fwd7)} calls at "
                  f"{len(fwd7)} shapes, times summed; library is "
                  "torch._int_mm plus the same epilogue"})
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
