#!/usr/bin/env python3
"""Time the port's kernels of two checkouts on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU, with a
second checkout (for example the parent commit, unpacked by
``git archive``) at OTHER:

    python3 kernel_ab.py OTHER [--kernels 2,5,7] [--out DIR]
    python3 kernel_ab.py --sweep BATCH [--kernels 2,5,7] [--out DIR]

Each checkout's ``bigdl_tpu_torch`` is imported in a process of its own,
which builds that checkout's kernels and times, on the same seeded
operands in both, ``fused_matmul_bn_dgrad`` (kernel 2) and
``fused_conv3x3_bn_dgrad`` (kernel 5) in bf16 at every shape of one
fused ResNet-50 backward at batch 32 and 256, and ``int8_matmul_dequant``
(kernel 7, bf16 out) at every shape of one quantized ResNet-50 forward at
batch 32 and at the FFN, int8 KV score and large-FC MLP shapes, with
``w_q`` laid out as that checkout's quantized layers hold it (K-major
where their ``weight_q`` has K stride 1, else a contiguous (K, N)):
device time per call, 10 calls captured in a CUDA graph and replayed 20
times between CUDA events.  The checkouts run in turns, OTHER, this,
this, OTHER, and each side's time is the mean of its two runs.  Prints
the card's name and power limit, a line per shape and the sums per pass;
writes the rows to DIR/kernel_ab.json (default build/kernel_ab).
``--sweep BATCH`` instead times this checkout's kernels at BATCH's shapes
under every column tile (and, for kernel 5, reduction split) their plans
can choose, and for kernel 7 under the column tiles, ring depths,
resident panels and K splits ``_int8_plan`` can choose, marks the plan's
choice, and writes DIR/sweep_BATCH.json.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCHES = (32, 256)
ITERS, REPS = 20, 10
KERNEL = {"mm_dgrad": 2, "cv_dgrad": 5}  # the port's kernel numbers
# kernel 7 beyond a quantized ResNet-50 forward (chip_smoke.py INT8_EXTRA)
INT8_EXTRA = ((4096, 768, 3072), (4096, 3072, 768), (8, 128, 4096),
              (8, 8192, 8192), (8, 8192, 1000))


def int8_calls(batch: int):
    """(M, K, N) -> calls of the int8 products of one quantized ResNet-50
    forward at ``batch``, as chip_smoke.py counts them."""
    calls = {}
    n_in, res = 64, 56
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ro = res // s
            keys = [(batch * res * res, n_in, planes),
                    (batch * ro * ro, planes, 4 * planes)]
            if s == 1 and n_in != 4 * planes:
                keys.append((batch * res * res, n_in, 4 * planes))
            for key in keys:
                calls[key] = calls.get(key, 0) + 1
            n_in, res = 4 * planes, ro
    calls[(batch, 2048, 1000)] = 1
    return calls


def int8_operands(shape, dev):
    """Kernel 7's operands at ``shape``, seeded by it, with ``w_q`` laid
    out as the imported tree's quantized layers hold their weights."""
    import torch

    from bigdl_tpu_torch.nn.quantized import QuantizedLinear

    m, k, n = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape))

    def randint8(*s):
        return torch.randint(-127, 128, s, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)

    k_major = QuantizedLinear(4, 3).weight_q.stride(0) == 1
    x = randint8(m, k)
    w = randint8(n, k).t() if k_major else randint8(k, n)
    s = (torch.rand(n, generator=gen, device=dev) + 0.05) * 1e-4
    return x, w, s


def resnet50_calls(batch: int):
    """(op, shape, prologue) -> calls per backward: the dgrad kernels'
    shapes of one fused ResNet-50 at ``batch``, as chip_smoke.py counts
    the forward's (each backward kernel runs once per forward call)."""
    calls = {}
    n_in, res = 64, 56
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** stage
        for b in range(n_blocks):
            s = 2 if stage > 0 and b == 0 else 1
            ro = res // s
            keys = [("mm_dgrad", (batch * res * res, n_in, planes), False),
                    ("mm_dgrad", (batch * ro * ro, planes, 4 * planes), True)]
            if s == 1:
                keys.append(("cv_dgrad", (batch, res, res, planes, planes),
                             True))
            if s != 1 or n_in != 4 * planes:
                keys.append(("mm_dgrad", (batch * ro * ro, n_in, 4 * planes),
                             False))
            for key in keys:
                calls[key] = calls.get(key, 0) + 1
            n_in, res = 4 * planes, ro
    return calls


def operands(op, shape, prologue, dev):
    """The wrapper of kernel family ``op`` and its bf16 operands at
    ``shape``, seeded by the shape, at the scales a train step gives."""
    import torch

    from bigdl_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device=dev).manual_seed(sum(shape))

    def rand(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    if op == "mm_dgrad":
        m, k, n = shape
        x, w = rand(m, k), rand(k, n, scale=k ** -0.5)
        y_shape, c, co, fn = (m, n), k, n, fm.fused_matmul_bn_dgrad
    else:
        b, h, wd, c, co = shape
        m = b * h * wd
        x, w = rand(b, h, wd, c), rand(3, 3, c, co, scale=(9 * c) ** -0.5)
        y_shape, fn = (b, h, wd, co), fm.fused_conv3x3_bn_dgrad
    ps = pb = None
    if prologue:
        ps = torch.rand(c, generator=gen, device=dev) + 0.5
        pb = torch.randn(c, generator=gen, device=dev) * 0.5
    y, dy = rand(*y_shape), rand(*y_shape, scale=m ** -0.5)
    dss = torch.randn(co, generator=gen, device=dev) / m
    dsq = torch.randn(co, generator=gen, device=dev) / m
    return fn, (dy, y, dss, dsq, w, x, ps, pb)


def device_ms(call) -> float:
    """ms per call: REPS calls captured in a CUDA graph, replayed ITERS
    times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            call()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(ITERS):
        graph.replay()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / (ITERS * REPS)


def _import(tree: Path):
    sys.path.insert(0, str(tree))
    import bigdl_tpu_torch

    if Path(bigdl_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"imported {bigdl_tpu_torch.__file__}, not {tree}")


def measure(tree: Path, kernels) -> list:
    """Times this process's tree's kernels; returns one row per shape."""
    import torch

    _import(tree)
    dev = torch.device("cuda")
    rows = []
    for batch in BATCHES if kernels & {2, 5} else ():
        for (op, shape, prologue), count in resnet50_calls(batch).items():
            if KERNEL[op] not in kernels:
                continue
            fn, args = operands(op, shape, prologue, dev)
            rows.append({"op": op, "batch": batch, "shape": list(shape),
                         "prologue": prologue, "calls": count,
                         "ms": device_ms(lambda: fn(*args, relu=True))})
            del fn, args
    if 7 in kernels:
        from bigdl_tpu_torch.ops import int8_matmul as im

        shapes = list(int8_calls(32).items()) + [(s, 0) for s in INT8_EXTRA]
        for shape, count in shapes:
            x, w, s = int8_operands(shape, dev)
            rows.append({"op": "int8", "batch": 32, "shape": list(shape),
                         "prologue": False, "calls": count,
                         "ms": device_ms(lambda: im.int8_matmul_dequant(
                             x, w, s))})
            del x, w, s
    return rows


def int8_variants(m: int, k: int, n: int, sms: int, chosen) -> list:
    """Every tiling of kernel 7 its plan can choose at (m, k, n): on the
    large route each column tile with and without a resident panel at
    the deepest ring that fits and at 2 and 4 stages; on the swap route
    each K split of 1 to 16 slices at the deepest ring."""
    from bigdl_tpu_torch.ops import int8_matmul as im

    kc = chosen.kc
    plans = []
    if chosen.swap:
        tiles = -(-n // chosen.bn)
        for slices in (1, 2, 4, 8, 16):
            if slices > 1 and tiles > sms:  # the workspace holds sms tiles
                continue
            per = -(-kc // min(slices, kc))
            got = -(-kc // per)
            stages = min(im._MAX_STAGES, per)
            plans.append(chosen._replace(per=per, slices=got, stages=stages,
                                         blocks=tiles * got))
    else:
        rows = -(-m // chosen.bm)
        for bn in (64, 128, 256):
            cols = -(-n // bn)
            blocks = min(rows * cols, max(1, sms // cols) * cols)
            for resident in (True, False):
                if resident and kc > im._MAX_PANEL:
                    continue
                base = chosen._replace(bn=bn, resident=resident,
                                       blocks=blocks, stages=1)
                room = im._SMEM - im._int8_smem(base)
                stage = 128 * 128 + (0 if resident else bn * 128)
                deepest = min(im._MAX_STAGES, room // stage + 1)
                for stages in sorted({2, 4, deepest}):
                    if 2 <= stages <= deepest:
                        plans.append(base._replace(stages=stages))
    if chosen not in plans:
        plans.append(chosen)
    return list(dict.fromkeys(plans))


def sweep_int8(dev) -> list:
    """Kernel 7 under every variant :func:`int8_variants` gives, at the
    batch-32 forward's shapes and the extras."""
    import torch

    from bigdl_tpu_torch.ops import int8_matmul as im

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    original = im._int8_plan
    rows = []
    shapes = list(int8_calls(32).items()) + [(s, 0) for s in INT8_EXTRA]
    for shape, count in shapes:
        x, w, s = int8_operands(shape, dev)
        chosen = original(*shape, sms)
        for plan in int8_variants(*shape, sms, chosen):
            im._int8_plan = lambda *a, p=plan: p
            rows.append({"op": "int8", "shape": list(shape), "calls": count,
                         "plan": plan._asdict(), "chosen": plan == chosen,
                         "ms": device_ms(lambda: im.int8_matmul_dequant(
                             x, w, s))})
            print(f"  int8 {tuple(shape)} {tuple(plan)}: "
                  f"{rows[-1]['ms']:.4f} ms"
                  f"{' (the plan)' if plan == chosen else ''}", flush=True)
        im._int8_plan = original
        del x, w, s
    return rows


def sweep(batch: int, kernels) -> list:
    """This tree's kernels 2 and 5 under every column tile and (kernel
    5) reduction split their plans can choose, at ``batch``'s shapes;
    kernel 7 under :func:`sweep_int8`'s variants."""
    import torch

    _import(ROOT)
    from bigdl_tpu_torch.ops import fused_matmul as fm

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = sweep_int8(dev) if 7 in kernels else []
    for (op, shape, prologue), count in resnet50_calls(batch).items():
        if KERNEL[op] not in kernels:
            continue
        fn, args = operands(op, shape, prologue, dev)
        plans = []
        if op == "mm_dgrad":
            m, k, n = shape
            steps, rows_m = -(-n // 64), -(-m // 128)
            for bn in (64, 128):
                cols = -(-k // bn)
                blocks = min(rows_m * cols, max(1, sms // cols) * cols)
                plans.append(fm.DgradPlan(128, bn, steps, steps, 1, blocks,
                                          blocks // cols))
            name, chosen = "_dgrad_plan", fm._dgrad_plan(m, k, n, sms)
        else:
            b, h, wd, ci, co = shape
            steps = 9 * -(-co // 64)
            for bn in (64, 128) if ci > 64 else (64,):
                for slices in (1, 2, 3, 4, 6, 8):
                    per = 3 * -(-steps // (3 * slices))
                    plan = fm.Conv3Plan(128, bn, steps, per, -(-steps // per))
                    if plan not in plans:
                        plans.append(plan)
            name, chosen = "_conv3_dgrad_plan", fm._conv3_dgrad_plan(
                b, h, wd, ci, co, sms)
        original = getattr(fm, name)
        for plan in plans:
            setattr(fm, name, lambda *a, p=plan: p)
            rows.append({"op": op, "shape": list(shape), "calls": count,
                         "plan": plan._asdict(), "chosen": plan == chosen,
                         "ms": device_ms(lambda: fn(*args, relu=True))})
            print(f"  {op} {tuple(shape)} {plan}: {rows[-1]['ms']:.4f} ms"
                  f"{' (the plan)' if plan == chosen else ''}", flush=True)
        setattr(fm, name, original)
        del fn, args
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, nargs="?",
                    help="root of the other checkout")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_ab")
    ap.add_argument("--sweep", type=int, metavar="BATCH",
                    help="instead: time this tree's plan variants at BATCH")
    ap.add_argument("--kernels", default="2,5,7",
                    help="which kernels (of 2, 5 and 7), comma-separated")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = {int(v) for v in args.kernels.split(",")}
    if not kernels or not kernels <= {2, 5, 7}:
        raise SystemExit(f"kernel_ab: --kernels takes 2, 5 and 7, got "
                         f"{args.kernels}")
    if args.measure is not None:  # a child: time one tree, print JSON
        print(json.dumps(measure(args.measure.resolve(), kernels)))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    if args.sweep:
        (args.out / f"sweep_{args.sweep}.json").write_text(json.dumps(
            {"card": smi.stdout.strip(),
             "rows": sweep(args.sweep, kernels)},
            indent=1))
        return
    if args.other is None:
        raise SystemExit("kernel_ab: name the other checkout's root")
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             str(trees[side]), "--kernels", args.kernels],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"kernel_ab: the {side} tree failed:\n"
                             f"{out.stderr[-4000:]}")
        runs[side].append(json.loads(out.stdout.strip().splitlines()[-1]))
    rows = []
    sums = {}
    for i, r in enumerate(runs["this"][0]):
        row = dict(r)
        row["ms_runs"] = [run[i]["ms"] for run in runs["this"]]
        row["other_ms_runs"] = [run[i]["ms"] for run in runs["other"]]
        row["ms"] = sum(row["ms_runs"]) / 2
        row["other_ms"] = sum(row["other_ms_runs"]) / 2
        rows.append(row)
        if r["calls"]:
            s = sums.setdefault(f"{r['op']} batch {r['batch']}", [0.0, 0.0])
            s[0] += r["calls"] * row["other_ms"]
            s[1] += r["calls"] * row["ms"]
        print(f"  {r['op']} {tuple(r['shape'])} batch {r['batch']} "
              f"x{r['calls']}: other {row['other_ms']:.4f} ms, this "
              f"{row['ms']:.4f} ms", flush=True)
    for key, (o, t) in sums.items():
        what = "a forward" if key.startswith("int8") else "a backward"
        print(f"summed over {what}, {key}: other {o:.4f} ms, this "
              f"{t:.4f} ms", flush=True)
    (args.out / "kernel_ab.json").write_text(json.dumps(
        {"card": smi.stdout.strip(), "rows": rows, "sums": sums}, indent=1))


if __name__ == "__main__":
    main()
