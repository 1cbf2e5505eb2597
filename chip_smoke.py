#!/usr/bin/env python3
"""GPU smoke run of bigdl_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # all phases, exit 0 only if all pass
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases:
1. device: require CUDA, print the card's name and power limit, build the
   port's CUDA kernels from bigdl_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, in parallel) and print the build time;
2. kernels: at ResNet-50's batch-32 shapes in bf16, plus a ragged-M
   matmul, batch-1 convs and an f32 case of each, hold every kernel
   against its plain PyTorch version on the card: the forward kernels'
   (y, ssum, ssq) and, with random cotangents, the backward kernels'
   (dx, d_ps, d_pb) and dW; time the kernel, the plain version and one
   library call for the same function (CUDA-graph replay) and compute
   the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s);
3. serve: fused ResNet-50 (space-to-depth stem, 1000 classes) with
   random weights from --seed and randomised BatchNorm, carried in
   through load_jax_variables, served by ServingEngine in bf16 to 4
   client threads; every answer is held against a plain-path forward of
   the same model on the card, and the launch counters must rise by 36
   (fused_matmul_bn) and 13 (fused_conv3x3_bn) per forward batch;
4. train: the same model trained with make_train_step (SGD 0.1, momentum
   0.9, bf16 compute and features, as bench.py's step): exact launch
   counts per step with remat on and off, one step at batch 32 held
   against the plain path in bf16 (loss, running statistics, finite
   gradients) and in f32 (loss, every gradient, running statistics),
   two fused blocks at ResNet-50 shapes against the plain path in f32
   (output, every gradient, running statistics), ten
   steps on one batch with a falling loss, images/s, ms per step and
   peak memory at batch 256 with remat on and off (and where the step's
   device time goes, from torch.profiler), and the user entry point
   Optimizer.apply(...).optimize() for 5 iterations on 160 images, which
   prints the reference log lines and must end with a finite loss;
5. lm: the flash-attention kernel held against its plain version (O and
   lse) at the LM's (8, 8, 512, 32) causal shape as MultiHeadAttention
   gives it, the FLASH shape, a ragged T, KV longer than Q, f32 and a
   causal (1, 8, 8192, 128), timed beside its plain version and SDPA;
   the default Transformer LM (10001 tokens, hidden 256, 8 heads, filter
   1024, 4 layers) with random weights from --seed carried in through
   load_jax_variables: one Adam + clipping train step in bf16 and in f32
   held against the plain attention path (use_flash=False), exactly 4
   flash launches per forward, ms per step, tokens/s and peak memory at
   batch 8 and T 512 and 4096 with a profiler breakdown, and the user
   entry point transformer_train.main([]), whose loss must fall and whose
   flash launches must be (iterations + validation batches) x 4.

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
    from bigdl_tpu_torch.utils import load_jax_variables

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
    flash_fwd = sum(v for k, v in step_k.items() if "flash_fwd_kernel" in k)
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
    want = (epochs * n_train + epochs * n_val + n_val) * LM["num_layers"]
    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "Loss is " in msg:
                losses.append(msg)

    grab = Losses()
    logging.getLogger("bigdl_tpu_torch.optim").addHandler(grab)
    fa.reset_launches()
    t0 = time.perf_counter()
    res = transformer_train.main([])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fa.LAUNCHES["flash_attention"]
    logging.getLogger("bigdl_tpu_torch.optim").removeHandler(grab)
    # "... Loss is 9.2103. compute: ..." (optimizer.py's log line)
    train_losses = [float(m.split("Loss is ")[1].split(". ")[0])
                    for m in losses if m.startswith("[Epoch")]
    val_lines = [m for m in losses if m.startswith("Loss is Loss(")]
    if launches != want:
        fail(f"transformer_train.main([]) launched the flash kernel "
             f"{launches} times, expected {want} ((5 x {n_train} "
             f"iterations + 6 x {n_val} validation batches) x 4)")
    if not (math.isfinite(res["val_loss"]) and train_losses
            and res["val_loss"] < train_losses[0]
            and len(val_lines) == epochs):
        fail(f"transformer_train.main([]): loss did not fall or validation "
             f"missing: first train loss {train_losses[:1]}, "
             f"{len(val_lines)} validations, result {res}")
    print(f"transformer_train.main([]): {epochs} epochs of {n_train} "
          f"iterations in {main_s:.1f} s, first loss {train_losses[0]}, "
          f"validation {val_lines[0]} -> {val_lines[-1]}, final "
          f"{res}; flash launches {launches}", flush=True)
    return {"parity": parity, "speed": speed, "breakdown": breakdown,
            "step_top_kernels": top, "main": {
                "seconds": main_s, "result": res, "launches": launches,
                "train_losses": train_losses, "validation": val_lines}}


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
    _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    (out / "kernel_build.log").write_text("\n".join(
        f"== {n}\n{log}" for n, log in _build.build_info["logs"].items()))
    print(f"kernels built in {build_s:.1f} s "
          f"({', '.join(_build.build_info['compiled'])})", flush=True)
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
        ref = call(plain, op, o)
        m = math.prod(shape[:-2]) if op.startswith("cv") else shape[0]
        err = check(f"{name}{shape} {dt}", op, got, ref, dt, m)
        if dt == "bf16":
            max_err[op] = max(max_err[op], err)
        del o, got, ref
    print(f"kernel checks passed: {len(extra) + len(main_shapes)} cases, "
          f"max |kernel - plain| {dict(max_err)}", flush=True)
    flash_rows, flash_err = flash_phase(gen, timing=not args.quick)
    if args.quick:
        print("quick: kernels build, launch and agree; stopping")
        return

    def bound(op, shape):
        """(bytes ms, operations ms): each input read once, each output
        written once, over the card's memory rate and bf16 peak."""
        if op.startswith("mm"):
            m, k, n = shape
            flops = 2 * m * k * n
            elems, vec = {"mm": m * k + k * n + m * n,
                          "mm_dgrad": 2 * m * n + k * n + 2 * m * k,
                          "mm_wgrad": m * k + 2 * m * n}[op], 2 * k + 2 * n
            if op == "mm_dgrad":
                vec += 2 * k  # d_ps, d_pb
            nbytes = 2 * elems + 4 * vec + (4 * k * n if op == "mm_wgrad"
                                            else 0)
        else:
            b, h, wd, c, co = shape
            m = b * h * wd
            flops = 18 * m * c * co
            if op == "cv":  # x, w, y; ps, pb, ssum, ssq
                elems, vec = m * c + 9 * c * co + m * co, 2 * c + 2 * co
            else:  # dy, y, x, dx, w; ps, pb, d_ps, d_pb, dssum, dssq
                elems = 2 * m * co + 2 * m * c + 9 * c * co
                vec = 4 * c + 2 * co
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
        r["bytes_ms"], r["ops_ms"] = bound(op, shape)
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

    # ----------------------------------------------------------- 3. serve
    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.nn import use_plain_ops
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.utils import (export_variables, load_jax_variables,
                                       random_variables)

    model = ResNet50(1000, stem="space_to_depth", fused=True)
    variables = random_variables(export_variables(model), args.seed)
    load_jax_variables(model, variables)
    reference = use_plain_ops(ResNet50(1000, stem="space_to_depth",
                                       fused=True))
    load_jax_variables(reference, variables)

    engine = ServingEngine(model, buckets=[(224, 224, 3)],
                           batch_sizes=(1, 8, 32),
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

    fm.reset_launches()
    batches0 = engine.metrics.batches
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    serve_launches = dict(fm.LAUNCHES)
    batches = engine.metrics.batches - batches0
    log_line = engine.log_line()
    p50, p99 = engine.metrics.latency_ms(50), engine.metrics.latency_ms(99)
    engine.close()
    if errors:
        fail(f"client errors: {errors[:3]}")
    if serve_launches["fused_matmul_bn"] != 36 * batches or \
            serve_launches["fused_conv3x3_bn"] != 13 * batches or batches == 0:
        fail(f"launches {serve_launches} over {batches} forward batches; "
             "expected 36 and 13 per batch")

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
          f"{batches} batches, {REQUESTS / wall:.1f} images/s, "
          f"p50 {p50:.2f} ms, p99 {p99:.2f} ms; launches {serve_launches}; "
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
        for i in range(10):
            *trees, loss = step(*trees, i + 4, None, x256, t256, [0.1])
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / 10
        train[remat] = {"ms_per_step": ms,
                        "images_per_s": TRAIN_BATCH / ms * 1e3,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "loss": loss.item()}
        if not math.isfinite(train[remat]["loss"]):
            fail(f"non-finite loss at batch {TRAIN_BATCH}, remat={remat}")
        print(f"train at batch {TRAIN_BATCH}, remat {'on' if remat else 'off'}"
              f": {train[remat]['images_per_s']:.1f} images/s, "
              f"{ms:.2f} ms per step, peak memory "
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
        if "fused_gemm_bn_kernel" in key:
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
    want = {k: OPT_ITERS * v for k, v in STEP_LAUNCHES[True].items()}
    if opt_launches != want:
        fail(f"Optimizer.optimize() launches {opt_launches}, expected "
             f"{want}")
    print(f"optimize: {OPT_ITERS} iterations at batch 32 (f32 features, "
          f"bf16 parameters: the f32 kernels) in {opt_s:.1f} s, final loss "
          f"{final_loss:.4f}; launches {opt_launches}", flush=True)
    del tmodel, umodel, opt, feats, xt
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 5. lm
    lm = lm_phase(args)

    (out / "chip_smoke_kernels.json").write_text(json.dumps(
        {"card": card, "batch": BATCH, "rows": rows, "forward": fwd,
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
         "flash": flash_rows, "lm": lm},
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
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
