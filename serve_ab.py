#!/usr/bin/env python3
"""Served images/s of two checkouts on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU, with a
second checkout (for example the parent commit, unpacked by
``git archive``) at OTHER:

    python3 serve_ab.py OTHER [--rounds 6] [--requests 1024] [--out DIR]

Each leg is a process of its own that imports its checkout's
``bigdl_tpu_torch``, builds its kernels and serves the fused ResNet-50
(space-to-depth stem, 1000 classes, random weights from seed 0, bf16,
``ServingEngine`` buckets of batch 1, 8 and 32 at 224 px) to 4 client
threads for ROUNDS rounds of REQUESTS seeded images; a leg's number is
the median images/s of its rounds after the first.  The legs run in
turns, OTHER, this, this, OTHER.  Prints the card's name and power limit
and each leg's rounds; writes DIR/serve_ab.json (default
build/serve_ab).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def leg(rounds: int, requests: int) -> list:
    """This checkout's images/s per round (run inside a leg's process)."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.models import ResNet50
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.utils import (export_variables, load_jax_variables,
                                       random_variables)

    _build.build(verbose=False)
    model = ResNet50(1000, stem="space_to_depth", fused=True)
    load_jax_variables(model, random_variables(export_variables(model), 0))
    images = np.random.RandomState(1).randn(requests, 224, 224, 3).astype(
        np.float32)
    out = []
    with ServingEngine(model, buckets=[(224, 224, 3)],
                       batch_sizes=(1, 8, 32),
                       input_dtype=torch.bfloat16) as engine:
        for _ in range(rounds):
            futs = [None] * requests

            def client(i):
                for j in range(i, requests, 4):
                    futs[j] = engine.submit(images[j])

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for f in futs:
                f.result(300)
            out.append(requests / (time.perf_counter() - t0))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "serve_ab")
    ap.add_argument("--leg", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.leg:  # a leg's process, started below in its checkout
        sys.path.insert(0, ".")
        print(json.dumps(leg(args.rounds, args.requests)), flush=True)
        return
    if args.other is None:
        ap.error("OTHER: the checkout to compare with")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    res = {"card": card, "rounds": args.rounds, "requests": args.requests,
           "legs": []}
    for name in ("other", "this", "this", "other"):
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--leg",
             "--rounds", str(args.rounds), "--requests", str(args.requests)],
            cwd=trees[name], capture_output=True, text=True, timeout=900)
        if r.returncode:
            sys.exit(f"serve_ab: the {name} leg failed:\n{r.stderr[-3000:]}")
        ips = json.loads(r.stdout.strip().splitlines()[-1])
        med = statistics.median(ips[1:])
        res["legs"].append({"checkout": name, "images_per_s": ips,
                            "median": med})
        print(f"{name}: median {med:.1f} images/s of rounds "
              f"{[round(v, 1) for v in ips]}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "serve_ab.json").write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
