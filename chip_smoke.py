#!/usr/bin/env python3
"""GPU smoke run of bigdl_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # all phases, exit 0 only if all pass
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases:
1. device: require CUDA, print the card's name and power limit, build the
   port's CUDA kernels from bigdl_tpu_torch/csrc (nvcc, sm_90a) and print
   the build time;
2. kernels: at ResNet-50's batch-32 shapes in bf16, plus a ragged-M
   matmul, batch-1 convs and an f32 case of each, hold every kernel's
   (y, ssum, ssq) against its plain PyTorch version on the card; time
   the kernel, the plain version and one library call for the same
   function (CUDA events) and compute the least time the card could
   take (bytes over 3.35 TB/s or operations over 989 TFLOP/s);
3. serve: fused ResNet-50 (space-to-depth stem, 1000 classes) with
   random weights from --seed and randomised BatchNorm, carried in
   through load_jax_variables, served by ServingEngine in bf16 to 4
   client threads; every answer is held against a plain-path forward of
   the same model on the card, and the launch counters must rise by 36
   (fused_matmul_bn) and 13 (fused_conv3x3_bn) per forward batch.

The line before the last is the JSON ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Per-shape timings and the nvcc output
go to the --out directory (default build/smoke/).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

# y: one bf16 rounding apart plus f32 sum order; stats: f32 sum order
Y_RTOL = {"bf16": 2e-2, "f32": 1e-4}
Y_ATOL = {"bf16": 1e-3, "f32": 1e-6}  # times the largest |y|
STATS_RTOL = 1e-3
BATCH = 32        # kernel shapes: one ResNet-50 forward at 224x224
REQUESTS = 512    # served by 4 client threads
ITERS = 20        # timed repetitions
# served logits vs the plain path, relative to the largest |logit|:
# bf16 rounding flips from f32 sum order, carried through 53 convs
SERVE_TOL = 3e-2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def resnet50_calls(batch: int):
    """Kernel calls of one fused ResNet-50 forward at ``batch``:
    Counter of (M, K, N, prologue) and of (B, H, W, C, Co)."""
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

    def operands(kind_, shape, prologue, dtype):
        if kind_ == "mm":
            m, k, n = shape
            x, w = rand(m, k, dtype=dtype), rand(k, n, scale=k ** -0.5,
                                                  dtype=dtype)
            c = k
        else:
            b, h, wd, c, co = shape
            x = rand(b, h, wd, c, dtype=dtype)
            w = rand(3, 3, c, co, scale=(9 * c) ** -0.5, dtype=dtype)
        if not prologue:
            return x, w, None, None
        ps = torch.rand(c, generator=gen, device=dev) + 0.5
        pb = torch.randn(c, generator=gen, device=dev) * 0.5
        return x, w, ps, pb

    def check(name, got, ref, dt):
        y, s, q = got
        yr, sr, qr = ref
        d = (y.float() - yr.float()).abs()
        scale = yr.float().abs().max().item()
        bad_y = (d > Y_RTOL[dt] * yr.float().abs() + Y_ATOL[dt] * scale).sum()
        m = y.numel() // y.shape[-1]
        sum_atol = 1e-5 * torch.sqrt(m * qr)  # bounds |sum| of the column
        bad_s = ((s - sr).abs() > STATS_RTOL * sr.abs() + sum_atol).sum()
        bad_q = ((q - qr).abs() > STATS_RTOL * qr.abs()).sum()
        if not (torch.isfinite(y.float()).all() and bad_y == 0
                and bad_s == 0 and bad_q == 0):
            fail(f"{name}: kernel disagrees with the plain version "
                 f"(y {int(bad_y)} bad, max |d| {d.max().item():.4g}; "
                 f"ssum {int(bad_s)} bad; ssq {int(bad_q)} bad)")
        return d.max().item()

    kernels = {
        "mm": ("fused_matmul_bn", fm.fused_matmul_bn,
               fm.fused_matmul_bn_plain),
        "cv": ("fused_conv3x3_bn", fm.fused_conv3x3_bn,
               fm.fused_conv3x3_bn_plain),
    }
    mm_calls, cv_calls = resnet50_calls(BATCH)
    if sum(mm_calls.values()) != 36 or sum(cv_calls.values()) != 13:
        fail(f"call table: {sum(mm_calls.values())} matmuls, "
             f"{sum(cv_calls.values())} convs per forward")
    main_shapes = [("mm", (m, k, n), p, c) for (m, k, n, p), c
                   in mm_calls.items()]
    main_shapes += [("cv", s, True, c) for s, c in cv_calls.items()]
    extra = [("mm", (147, 2048, 512), True, "bf16"),     # ragged M, 3 x 7x7
             ("mm", (1000, 64, 256), False, "bf16"),
             ("cv", (1, 56, 56, 64, 64), True, "bf16"),  # batch 1
             ("cv", (1, 7, 7, 512, 512), True, "bf16"),
             ("cv", (3, 7, 7, 512, 512), False, "bf16"),
             ("mm", (4099, 256, 64), True, "f32"),
             ("cv", (2, 14, 14, 64, 128), True, "f32")]
    max_err = {"mm": 0.0, "cv": 0.0}
    for kind_, shape, prologue, dt in extra + [
            (k_, s_, p_, "bf16") for k_, s_, p_, _ in main_shapes]:
        name, kern, plain = kernels[kind_]
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, w, ps, pb = operands(kind_, shape, prologue, dtype)
        got = kern(x, w, ps, pb, relu=True)
        torch.cuda.synchronize()
        ref = plain(x, w, ps, pb, relu=True)
        err = check(f"{name}{shape} {dt}", got, ref, dt)
        if dt == "bf16":
            max_err[kind_] = max(max_err[kind_], err)
    print(f"kernel checks passed: {len(extra) + len(main_shapes)} cases, "
          f"max |y - plain| {max_err}", flush=True)
    if args.quick:
        print("quick: kernels build, launch and agree; stopping")
        return

    def call_ms(fn):
        """Per call, eager, CUDA events: host launch cost included."""
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

    def library(kind_, x, w, ps, pb):
        u = x if ps is None else torch.relu(
            x.float() * ps + pb).to(w.dtype)
        if kind_ == "mm":
            y = torch.matmul(u, w)
        else:
            y = torch.nn.functional.conv2d(
                u.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1
            ).permute(0, 2, 3, 1)
        yf = y.float().reshape(-1, y.shape[-1])
        return y, yf.sum(0), (yf * yf).sum(0)

    def bound(kind_, shape):
        if kind_ == "mm":
            m, k, n = shape
            elems, flops, c, co = m * k + k * n + m * n, 2 * m * k * n, k, n
        else:
            b, h, wd, c, co = shape
            m = b * h * wd
            elems = m * c + 9 * c * co + m * co
            flops = 18 * m * c * co
        nbytes = 2 * elems + 4 * (2 * c + 2 * co)
        return nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3

    rows, agg = [], {}
    for kind_, shape, prologue, count in main_shapes:
        name, kern, plain = kernels[kind_]
        x, w, ps, pb = operands(kind_, shape, prologue, torch.bfloat16)
        r = {"kernel": name, "shape": list(shape), "prologue": prologue,
             "calls_per_forward": count,
             "ms": device_ms(lambda: kern(x, w, ps, pb, relu=True)),
             "plain_ms": device_ms(lambda: plain(x, w, ps, pb, relu=True)),
             "library_ms": device_ms(lambda: library(kind_, x, w, ps, pb)),
             "call_ms": call_ms(lambda: kern(x, w, ps, pb, relu=True))}
        r["bytes_ms"], r["ops_ms"] = bound(kind_, shape)
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        rows.append(r)
        a = agg.setdefault(kind_, Counter())
        for key in ("ms", "plain_ms", "library_ms", "call_ms", "bound_ms",
                    "bytes_ms", "ops_ms"):
            a[key] += count * r[key]
        print(f"  {name} {tuple(shape)} x{count}: {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f}, eager call {r['call_ms']:.4f})",
              flush=True)
        del x, w

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
    launches = dict(fm.LAUNCHES)
    batches = engine.metrics.batches - batches0
    log_line = engine.log_line()
    p50, p99 = engine.metrics.latency_ms(50), engine.metrics.latency_ms(99)
    engine.close()
    if errors:
        fail(f"client errors: {errors[:3]}")
    if launches["fused_matmul_bn"] != 36 * batches or \
            launches["fused_conv3x3_bn"] != 13 * batches:
        fail(f"launches {launches} over {batches} forward batches; "
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
          f"p50 {p50:.2f} ms, p99 {p99:.2f} ms; launches {launches}; "
          f"max |logit - plain| {serve_err:.4g} (max |logit| "
          f"{serve_scale:.4g})", flush=True)
    print(log_line, flush=True)

    (out / "chip_smoke_kernels.json").write_text(json.dumps(
        {"card": card, "batch": BATCH, "rows": rows, "forward": fwd,
         "serve": {"requests": REQUESTS, "batches": batches,
                   "images_per_s": REQUESTS / wall, "p50_ms": p50,
                   "p99_ms": p99, "max_abs_err": serve_err,
                   "max_abs_logit": serve_scale}}, indent=1))

    # ---------------------------------------------------------- summary
    src = "bigdl_tpu_torch/csrc/"
    replaces = {"mm": "bigdl_tpu/ops/pallas/fused_matmul.py:159",
                "cv": "bigdl_tpu/ops/pallas/fused_matmul.py:516"}
    line = []
    for kind_ in ("mm", "cv"):
        name = kernels[kind_][0]
        a = agg[kind_]
        line.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces[kind_],
            "launches": launches[name],
            "max_abs_err": max_err[kind_],
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"],
            "bound_by": "bytes" if a["bytes_ms"] >= a["ops_ms"]
            else "operations",
            "library_ms": a["library_ms"],
            "shapes": f"one ResNet-50 forward at batch {BATCH}: "
                      f"{sum((mm_calls if kind_ == 'mm' else cv_calls).values())}"
                      " calls, times summed",
        })
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
