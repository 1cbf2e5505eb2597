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
   batch-256 shapes of the train step;
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
   longer than Q, f32, a causal (1, 8, 8192, 128) and head dims 12 and
   8 (zero-padded to 32 by the wrapper), timed beside its plain version
   and SDPA;
   the default Transformer LM (10001 tokens, hidden 256, 8 heads, filter
   1024, 4 layers) with random weights from --seed carried in through
   load_jax_variables: one Adam + clipping train step in bf16 and in f32
   held against the plain attention path (use_flash=False), exactly 4
   flash launches per forward, ms per step, tokens/s and peak memory at
   batch 8 and T 512 and 4096 with a profiler breakdown, and the user
   entry point transformer_train.main([]), whose loss must fall, in two
   compiled calls (the train step and the evaluation forward): 4 flash
   launches per capture and warm-up call, and a replay per iteration and
   validation batch;
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
   (remat on and off) and for the LM at T 512 and 4096.

The line before the last is the JSON ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Per-shape timings and the nvcc output
go to the --out directory (default build/smoke/).
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import subprocess
import sys
import threading
import time
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


def replay_kernels(fn):
    """The hand-written kernels one call of ``fn`` (a graph replay) runs
    on the card, counted by their symbols in a torch.profiler trace, and
    the device ms of all its kernels and copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    got, device_us = Counter(), 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us += evt.device_time_total
            wrapper = kernel_of(evt.name)
            if wrapper is not None:
                got[wrapper] += 1
    return dict(got), device_us / 1e3


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
    """(bytes ms, operations ms): q, k, v read once, O and the f32 lse
    written once; 4*B*H*T*S*D operations, halved under causal, over the
    bf16 tensor-core peak (f32: the f32 peak)."""
    b, h, t, s, d = shape
    size = 2 if dt == "bf16" else 4
    nbytes = size * b * h * (2 * t * d + 2 * s * d) + 4 * b * h * t
    ops = 4 * b * h * t * s * d / (2 if causal else 1)
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
        o, lse = fa.flash_attention_lse(q, k, v, causal)
        torch.cuda.synchronize()
        po, pl = fa.flash_attention_plain(q, k, v, causal)
        err = (o.float() - po.float()).abs().max().item()
        lse_err = (lse - pl).abs().max().item()
        scale = po.float().abs().max().item()
        tol = (2.0 ** (math.floor(math.log2(scale)) - 7) if dt == "bf16"
               else 1e-5 * scale)
        name = f"flash_attention{shape} causal={causal} {dt} {layout}"
        if (not torch.isfinite(o.float()).all() or err > tol
                or lse_err > 1e-5 * pl.abs().max().item()):
            fail(f"{name}: kernel disagrees with the plain version: max "
                 f"|dO| {err:.4g} (limit {tol:.4g}), max |dlse| "
                 f"{lse_err:.4g}")
        if dt == "bf16":
            max_err = max(max_err, err)
        r = {"shape": list(shape), "causal": causal, "dtype": dt,
             "layout": layout or "contiguous", "max_abs_err": err,
             "lse_err": lse_err}
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


def lm_variables(model, seed):
    """Random LM weights made with numpy from ``seed``, shaped as the
    model's JAX tree: the embedding N(0, d^-1/2) as the LM initialises
    it, (in, out) weights N(0, 1/in), LayerNorm weights 1 + N(0, 0.1^2),
    biases N(0, 0.1^2)."""
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
                a = rs.randn(*shape) * shape[1] ** -0.5
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
    return {"parity": parity, "speed": speed, "breakdown": breakdown,
            "step_top_kernels": top, "main": {
                "seconds": main_s, "result": res, "launches": launches,
                "graphs": counts,
                "train_losses": train_losses, "validation": val_lines}}


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


def int8_bound(shape):
    """(bytes ms, operations ms): x, w_q and the f32 scale read once, the
    bf16 y written once; 2*M*N*K int8 operations over the int8 peak."""
    m, k, n = shape
    nbytes = m * k + k * n + 4 * n + 2 * m * n
    return nbytes / PEAK_BYTES * 1e3, 2 * m * n * k / PEAK_INT8_OPS * 1e3


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

    def close(name, what, got, ref, dt):
        """Elementwise check of a tensor in x's type; max |d|."""
        d = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        bad = (d > Y_RTOL[dt] * ref.float().abs() + Y_ATOL[dt] * scale).sum()
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

    def check(name, op, got, ref, dt, m):
        if op in ("mm", "cv"):
            (y, s, q), (yr, sr, qr) = got, ref
            err = close(name, "y", y, yr, dt)
            close_sums(name, "ssum", s, sr, STATS_RTOL,
                       1e-5 * torch.sqrt(m * qr))  # bounds |column sum|
            close_sums(name, "ssq", q, qr, STATS_RTOL, 0.0)
            return err
        if op == "mm_wgrad":
            return close(name, "dW", got, ref, dt)
        (dx, dps, dpb), (dxr, dpsr, dpbr) = got, ref
        err = close(name, "dx", dx, dxr, dt)
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
    def same(a, b):
        if a is None or isinstance(a, torch.Tensor):
            return a is b if a is None else torch.equal(a, b)
        return all(same(u, v) for u, v in zip(a, b))

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

    def bound(op, shape, prologue):
        """(bytes ms, operations ms): each input read once, each output
        written once, over the card's memory rate and bf16 peak.  Without
        a prologue a dgrad reads no x and a kernel no ps, pb (dx = g)."""
        pro = int(prologue)
        if op.startswith("mm"):
            m, k, n = shape
            flops = 2 * m * k * n
            # x, w, y / dy, y, w, dx (+ x) / x, dy, y; ps, pb and the
            # column vectors (ssum, ssq / dssum, dssq, d_ps, d_pb)
            elems = {"mm": m * k + k * n + m * n,
                     "mm_dgrad": 2 * m * n + k * n + m * k + pro * m * k,
                     "mm_wgrad": m * k + 2 * m * n}[op]
            vec = 2 * pro * k + 2 * n + (2 * pro * k if op == "mm_dgrad"
                                         else 0)
            nbytes = 2 * elems + 4 * vec + (4 * k * n if op == "mm_wgrad"
                                            else 0)
        else:
            b, h, wd, c, co = shape
            m = b * h * wd
            flops = 18 * m * c * co
            if op == "cv":  # x, w, y; ps, pb, ssum, ssq
                elems = m * c + 9 * c * co + m * co
                vec = 2 * pro * c + 2 * co
            else:  # dy, y, dx, w (+ x); dssum, dssq (+ ps, pb, d_ps, d_pb)
                elems = 2 * m * co + m * c + 9 * c * co + pro * m * c
                vec = 4 * pro * c + 2 * co
            nbytes = 2 * elems + 4 * vec
        return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3

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
        if step_launches[remat] != STEP_LAUNCHES[remat]:
            fail(f"train step launches with remat={remat}: "
                 f"{step_launches[remat]}, expected {STEP_LAUNCHES[remat]}")
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
    if opt_launches != want or step_graph.launches != STEP_LAUNCHES[True]:
        fail(f"Optimizer.optimize() launches {opt_launches} (the capture "
             f"{step_graph.launches}), expected {want} "
             f"({STEP_LAUNCHES[True]} per capture, none per replay)")
    print(f"optimize: {OPT_ITERS} iterations at batch 32 (f32 features, "
          f"bf16 parameters: the f32 kernels) in {opt_s:.1f} s, final loss "
          f"{final_loss:.4f}; one capture ({step_graph.capture_seconds:.2f}"
          f" s with its warm-up), {compiled.replays} "
          f"replays; launches {opt_launches}", flush=True)
    del tmodel, umodel, opt, feats, xt
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 5. lm
    lm = lm_phase(args)
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 6. quant
    quant = quant_phase(args, out)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 7. graphs
    graph_res = graphs_phase(args)

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
         "graphs": graph_res},
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
                "optimize": opt_launches[name]},
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
            "transformer_train_main": lm["main"]["launches"]},
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
            "mlp_forward": quant["launches"]["mlp_forward"]},
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
